"""Full-float32 matrix products: TF32 off for matmuls and cuDNN.

TF32 is the card's analogue of the TPU's one-pass bf16 default, which ruins
closed-loop rollout fidelity (PARITY.md).  Every module of the package that
imports torch imports this one first, so no matmul anywhere runs with TF32
on; the package itself imports no torch, so its host-only tools start
without it.  A run that asks for another precision sets it itself
(``train.trainer.set_matmul_precision``).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
