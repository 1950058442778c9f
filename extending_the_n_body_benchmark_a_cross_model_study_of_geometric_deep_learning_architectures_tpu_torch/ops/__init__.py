"""Hand-written CUDA kernels, their wrappers and plain versions, and the build."""
