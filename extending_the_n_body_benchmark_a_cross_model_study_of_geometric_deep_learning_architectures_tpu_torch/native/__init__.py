"""Native (C++) macro kernels and their g++ build."""
