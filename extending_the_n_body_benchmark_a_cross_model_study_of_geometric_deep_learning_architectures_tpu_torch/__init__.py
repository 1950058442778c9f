"""PyTorch + CUDA port of the n-body benchmark framework, for an NVIDIA H100.

The JAX package beside it (``..._tpu``) is the reference this package is held
against; this package imports nothing of it, and no JAX.  Plain tensor code
is PyTorch; the JAX package's Pallas kernels are CUDA C++ kernels under
``csrc/``, built at first use by ``ops/_build.py``.

Float32 matrix products run in full f32: every module that imports torch
first imports ``_tf32``, which switches TF32 off for matmuls and cuDNN.
This file imports no torch, so the host-only tools (``tools.pipeline``,
``tools.archive_row``, ``tools.results_report``, ``tools.diagnose_macros``)
start without it.
"""
