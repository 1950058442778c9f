"""Streaming EGNN-MC edge stage: kernel K3 (``csrc/egnn_stream.cu``) and its plain version.

The same edge stage as ``ops.egnn_messages`` (K1), with the per-edge geometry
computed from O(N) node data instead of read from a ``[B, N, N, 8]`` tensor:

    cd0_ij = pos0_i - pos0_j,    r0_ij = cd0_ij / max(|cd0_ij|, 1e-12)
    g_ij   = [|c_i - c_j|^2, m_i m_j, v_i . r0_ij, v_j . r0_ij, |cd0_ij|^2]
    cd_ij  = c_i - c_j           (divided by max(|cd_ij|, 1) under norm_diff)

with ``pos0``, ``vel``, ``mass`` the scene's and ``c`` the layer's current
coordinates; differences are receiver minus sender.  This is the JAX package's
Pallas ``streaming_egnn_messages`` (``ops/pallas/egnn_stream.py:192``), the
single-device path for large N: only the ``[B, N, N]`` mask is read from device
memory.

``streaming_egnn_messages`` is the wrapper the model calls.  On a CPU tensor it
computes :func:`streaming_egnn_messages_plain`; on a CUDA tensor it launches the
kernel (f32, He = Hc = 128, silu) and counts the launch in
``streaming_egnn_messages.launches``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from . import egnn_messages as EM  # K1's module: the plain formula, tiles, widths

_ELEM_BF16_LATER = "ROADMAP.md, still to come: stream_elem_bf16 (bf16 elementwise stack)"


def streaming_egnn_messages_plain(
    hA, hB, pos0, vel, mass, coord, mask, w_geom, W2, b2, Wc1, bc1, wc2,
    tanh: bool = True, norm_diff: bool = True, activation: str = "silu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense reference: builds the ``[B, N, N, 8]`` geometry ``[radial, m_i m_j,
    proj_i, proj_j, d0^2, cd]`` as the TPU kernel's body does
    (``egnn_stream.py:95-109``), then K1's plain formula, which materialises the
    ``[B, N, N, He]`` messages (fine for tests and checks up to N ~ 1000)."""
    cd0 = pos0[:, :, None, :] - pos0[:, None, :, :]
    d2_0 = torch.sum(cd0 * cd0, dim=-1, keepdim=True)
    dir0 = cd0 / torch.clamp(torch.sqrt(torch.clamp(d2_0, min=0.0)), min=1e-12)
    proj_i = torch.sum(vel[:, :, None, :] * dir0, dim=-1, keepdim=True)
    proj_j = torch.sum(vel[:, None, :, :] * dir0, dim=-1, keepdim=True)
    mass_prod = mass[:, :, None, :] * mass[:, None, :, :]
    cd = coord[:, :, None, :] - coord[:, None, :, :]
    radial = torch.sum(cd * cd, dim=-1, keepdim=True)
    if norm_diff:
        cd = cd / torch.clamp(torch.sqrt(torch.clamp(radial, min=0.0)), min=1.0)
    geom = torch.cat([radial, mass_prod, proj_i, proj_j, d2_0, cd], dim=-1)
    return EM.egnn_messages_plain(hA, hB, geom, mask, w_geom, W2, b2, Wc1, bc1, wc2,
                                  tanh, activation)


def streaming_egnn_messages(
    hA, hB, pos0, vel, mass, coord, mask, w_geom, W2, b2, Wc1, bc1, wc2,
    tanh: bool = True, norm_diff: bool = True, tile_i: int = 32, tile_j: int = 128,
    elem_bf16: bool = False, activation: str = "silu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(agg [B, N, He], trans [B, N, 3])``: kernel K3 on a CUDA
    tensor, :func:`streaming_egnn_messages_plain` on a CPU tensor.

    ``tile_i`` and ``tile_j`` are the TPU kernel's tile sizes; they are taken
    for its signature's sake and change nothing here."""
    del tile_i, tile_j
    if elem_bf16:
        raise NotImplementedError(f"elem_bf16 is not ported yet: {_ELEM_BF16_LATER}")
    if not _build.wants_kernel(hA):
        return streaming_egnn_messages_plain(
            hA, hB, pos0, vel, mass, coord, mask, w_geom, W2, b2, Wc1, bc1, wc2,
            tanh, norm_diff, activation,
        )
    if activation != "silu":
        raise ValueError(f"the edge kernel computes silu, not {activation!r}")
    tensors = (hA, hB, pos0, vel, mass, coord, w_geom, W2, b2, Wc1, bc1, wc2)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("the streaming edge kernel takes float32 (bfloat16 is a later step)")
    if any(t.device != hA.device for t in (*tensors, mask)):
        raise ValueError("edge-stage inputs lie on different devices")
    B, N, He = hA.shape
    Hc = Wc1.shape[1]
    if He != EM.KERNEL_WIDTH or Hc != EM.KERNEL_WIDTH:
        raise ValueError(
            f"the edge kernel is built for He = Hc = {EM.KERNEL_WIDTH}, got {He}/{Hc}")
    if (hB.shape != hA.shape or mask.shape != (B, N, N) or mass.shape != (B, N, 1)
            or any(t.shape != (B, N, 3) for t in (pos0, vel, coord))):
        raise ValueError(f"bad shapes hB {hB.shape} pos0 {pos0.shape} vel {vel.shape} "
                         f"mass {mass.shape} coord {coord.shape} mask {mask.shape}")
    if w_geom.shape != (5, He) or W2.shape != (He, He) or Wc1.shape != (He, Hc):
        raise ValueError("bad weight shapes")
    if b2.shape != (He,) or bc1.shape != (Hc,) or wc2.shape != (Hc,):
        raise ValueError("bad bias shapes")
    ins = [EM._aligned(t) for t in (hA, hB, pos0, vel, mass, coord, mask,
                                    w_geom, W2, b2, Wc1, bc1, wc2)]
    agg = torch.empty((B, N, He), dtype=torch.float32, device=hA.device)
    trans = torch.empty((B, N, 3), dtype=torch.float32, device=hA.device)
    err = _build.kernels().nbody_egnn_stream_f32(
        *(t.data_ptr() for t in ins), agg.data_ptr(), trans.data_ptr(),
        B, N, He, Hc, EM.receiver_tile(N), int(bool(tanh)), int(bool(norm_diff)),
        _build.stream_ptr(hA),
    )
    _build.check(err, "nbody_egnn_stream_f32")
    streaming_egnn_messages.launches += 1
    return agg, trans


streaming_egnn_messages.launches = 0
