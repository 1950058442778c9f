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
kernel (He = Hc = 128, silu) and counts the launch: ``launches`` for float32
operands, ``launches_bf16`` for bfloat16 operands and ``launches_elem`` for
``elem_bf16`` (either operand dtype).

Operand types follow K1's (``ops.egnn_messages``) with the TPU body's one
difference (``ops/pallas/egnn_stream.py:124-136``): the geometry term is an
f32 product with ``w_geom`` upcast, so the geometry is never rounded.
``elem_bf16=True`` runs the ``[B, N, N, He]`` silus and the mask multiply in
bfloat16 (``:111-158``), with float32 or bfloat16 operands.
"""

from __future__ import annotations

from typing import Tuple

from .. import _tf32  # noqa: F401  (TF32 off before torch is used)
import torch

from . import _build
from . import egnn_messages as EM  # K1's module: the plain formula, the grid, widths


def streaming_egnn_messages_plain(
    hA, hB, pos0, vel, mass, coord, mask, w_geom, W2, b2, Wc1, bc1, wc2,
    tanh: bool = True, norm_diff: bool = True, activation: str = "silu",
    elem_bf16: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense reference: builds the ``[B, N, N, 8]`` geometry ``[radial, m_i m_j,
    proj_i, proj_j, d0^2, cd]`` as the TPU kernel's body does
    (``egnn_stream.py:95-109``), then the edge stage of K1's plain version with
    K3's rounding points, which materialises the ``[B, N, N, He]`` messages
    (fine for tests and checks up to N ~ 1000)."""
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
    return EM.edge_stage_plain(hA, hB, geom, mask, w_geom, W2, b2, Wc1, bc1, wc2,
                               tanh, activation, round_geom=False, elem_bf16=elem_bf16)


def streaming_egnn_messages(
    hA, hB, pos0, vel, mass, coord, mask, w_geom, W2, b2, Wc1, bc1, wc2,
    tanh: bool = True, norm_diff: bool = True, tile_i: int = 32, tile_j: int = 128,
    elem_bf16: bool = False, activation: str = "silu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(agg [B, N, He], trans [B, N, 3])``: kernel K3 on a CUDA
    tensor, :func:`streaming_egnn_messages_plain` on a CPU tensor.

    ``tile_i`` and ``tile_j`` are the TPU kernel's tile sizes; they are taken
    for its signature's sake and change nothing here.  Node inputs of a bf16
    scene are taken as float32 (``egnn_messages.at_least_f32``)."""
    del tile_i, tile_j
    pos0, vel, mass, coord = (EM.at_least_f32(t) for t in (pos0, vel, mass, coord))
    if not _build.wants_kernel(hA):
        return streaming_egnn_messages_plain(
            hA, hB, pos0, vel, mass, coord, mask, w_geom, W2, b2, Wc1, bc1, wc2,
            tanh, norm_diff, activation, elem_bf16,
        )
    if activation != "silu":
        raise ValueError(f"the edge kernel computes silu, not {activation!r}")
    operands = (hA, hB, w_geom, W2, b2, Wc1, bc1, wc2)
    node = (pos0, vel, mass, coord)
    op = EM.operand_dtype(operands, node)
    if any(t.device != hA.device for t in (*operands, *node, mask)):
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
    EM.refuse_grad("streaming_egnn_messages", (*operands, *node))
    ins = [EM.aligned(t, op) for t in (hA, hB)]
    ins += [EM.aligned(t, torch.float32) for t in (*node, mask)]
    ins += [EM.aligned(t, op) for t in (w_geom, W2, b2, Wc1, bc1, wc2)]
    agg = torch.empty((B, N, He), dtype=op, device=hA.device)
    trans = torch.empty((B, N, 3), dtype=torch.float32, device=hA.device)
    bf16 = op == torch.bfloat16
    name = "nbody_egnn_stream_bf16" if bf16 else "nbody_egnn_stream_f32"
    err = getattr(_build.kernels(), name)(
        *(t.data_ptr() for t in ins), agg.data_ptr(), trans.data_ptr(),
        B, N, He, Hc, EM.launch_blocks(B, N, _build.sm_count(hA)), int(bool(tanh)),
        int(bool(norm_diff)), int(bool(elem_bf16)), _build.stream_ptr(hA),
    )
    _build.check(err, name)
    if elem_bf16:
        streaming_egnn_messages.launches_elem += 1
    elif bf16:
        streaming_egnn_messages.launches_bf16 += 1
    else:
        streaming_egnn_messages.launches += 1
    return agg, trans


streaming_egnn_messages.launches = 0
streaming_egnn_messages.launches_bf16 = 0
streaming_egnn_messages.launches_elem = 0
