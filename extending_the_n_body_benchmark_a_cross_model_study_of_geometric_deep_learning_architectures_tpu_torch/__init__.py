"""PyTorch + CUDA port of the n-body benchmark framework, for an NVIDIA H100.

The JAX package beside it (``..._tpu``) is the reference this package is held
against; this package imports nothing of it, and no JAX.  Plain tensor code
is PyTorch; the JAX package's Pallas kernels are CUDA C++ kernels under
``csrc/``, built at first use by ``ops/_build.py``.

Float32 matrix products run in full f32: TF32 is switched off here for
matmuls and cuDNN.  TF32 is the card's analogue of the TPU's one-pass bf16
default, which ruins closed-loop rollout fidelity (PARITY.md).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
