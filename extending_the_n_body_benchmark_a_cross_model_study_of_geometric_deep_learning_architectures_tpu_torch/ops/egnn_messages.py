"""EGNN-MC edge stage: kernel K1 (``csrc/egnn_messages.cu``) and its plain version.

One layer's edge stage is

    m_ij   = silu(silu(hA_i + hB_j + g_ij @ Wg) @ W2 + b2)
    agg_i  = masked mean over senders j of m_ij
    w_ij   = tanh(silu(m_ij @ Wc1 + bc1) @ wc2)
    t_i    = masked mean over senders j of clip(w_ij * cd_ij, +-100)

with ``hA = h @ W1[:H] + b1`` and ``hB = h @ W1[H:2H]`` computed per node
outside, and the geometry ``g = [d2, 4 edge attrs]`` and ``cd`` packed as
``geom [B, N, N, 8]``, as the JAX package's Pallas ``fused_egnn_messages``
(``ops/pallas/egnn_messages.py:197``) takes them.  Its ``version=2`` takes
the same input and computes the same function; it only moves the packed axis
into ``[B, 8, N, N]`` planes inside that wrapper, a lane layout for the TPU.
So one kernel and one wrapper here serve both versions.

``fused_egnn_messages`` is the wrapper the model calls.  On a CPU tensor it
computes :func:`egnn_messages_plain`, the dense masked-mean formula of the
JAX model's XLA path (``models/egnn_mc.py:158-203``); on a CUDA tensor it
launches the kernel (f32, He = Hc = 128, silu) and counts the launch in
``fused_egnn_messages.launches``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.graph import masked_segment_mean
from ..models.common import get_activation
from . import _build

KERNEL_WIDTH = 128  # He and Hc the kernel is compiled for
MAX_RECEIVERS = 16  # receivers per thread block (kMaxTi in the source)


def egnn_messages_plain(
    hA, hB, geom, mask, w_geom, W2, b2, Wc1, bc1, wc2,
    tanh: bool = True, activation: str = "silu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense reference: materialises the ``[B, N, N, He]`` messages."""
    act = get_activation(activation)
    g_term = geom[..., 0:5].to(hA.dtype) @ w_geom  # [B, N, N, He]
    m = act(act(hA[:, :, None, :] + hB[:, None, :, :] + g_term) @ W2 + b2)
    w = act(m @ Wc1 + bc1) @ wc2  # [B, N, N]
    if tanh:
        w = torch.tanh(w)
    trans = torch.clamp(w[..., None].to(geom.dtype) * geom[..., 5:8], -100.0, 100.0)
    return masked_segment_mean(m, mask), masked_segment_mean(trans, mask)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous float32 with a 16-byte aligned base (the kernel's float4 loads)."""
    t = t.to(torch.float32).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def receiver_tile(n: int) -> int:
    """Receivers per block: the fewest tiles of at most ``MAX_RECEIVERS``, evened out."""
    tiles = -(-n // MAX_RECEIVERS)
    return -(-n // tiles)


def fused_egnn_messages(
    hA, hB, geom, mask, w_geom, W2, b2, Wc1, bc1, wc2,
    tanh: bool = True, activation: str = "silu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(agg [B, N, He], trans [B, N, 3])``: kernel K1 on a CUDA
    tensor, :func:`egnn_messages_plain` on a CPU tensor."""
    if not _build.wants_kernel(hA):
        return egnn_messages_plain(
            hA, hB, geom, mask, w_geom, W2, b2, Wc1, bc1, wc2, tanh, activation
        )
    if activation != "silu":
        raise ValueError(f"the edge kernel computes silu, not {activation!r}")
    tensors = (hA, hB, geom, w_geom, W2, b2, Wc1, bc1, wc2)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("the edge kernel takes float32 (bfloat16 is a later step)")
    if any(t.device != hA.device for t in (*tensors, mask)):
        raise ValueError("edge-stage inputs lie on different devices")
    B, N, He = hA.shape
    Hc = Wc1.shape[1]
    if He != KERNEL_WIDTH or Hc != KERNEL_WIDTH:
        raise ValueError(f"the edge kernel is built for He = Hc = {KERNEL_WIDTH}, got {He}/{Hc}")
    if hB.shape != hA.shape or geom.shape != (B, N, N, 8) or mask.shape != (B, N, N):
        raise ValueError(f"bad shapes hB {hB.shape} geom {geom.shape} mask {mask.shape}")
    if w_geom.shape != (5, He) or W2.shape != (He, He) or Wc1.shape != (He, Hc):
        raise ValueError("bad weight shapes")
    if b2.shape != (He,) or bc1.shape != (Hc,) or wc2.shape != (Hc,):
        raise ValueError("bad bias shapes")
    ins = [_aligned(t) for t in (hA, hB, geom, mask, w_geom, W2, b2, Wc1, bc1, wc2)]
    agg = torch.empty((B, N, He), dtype=torch.float32, device=hA.device)
    trans = torch.empty((B, N, 3), dtype=torch.float32, device=hA.device)
    err = _build.kernels().nbody_egnn_messages_f32(
        *(t.data_ptr() for t in ins), agg.data_ptr(), trans.data_ptr(),
        B, N, He, Hc, receiver_tile(N), int(bool(tanh)), _build.stream_ptr(hA),
    )
    _build.check(err, "nbody_egnn_messages_f32")
    fused_egnn_messages.launches += 1
    return agg, trans


fused_egnn_messages.launches = 0
