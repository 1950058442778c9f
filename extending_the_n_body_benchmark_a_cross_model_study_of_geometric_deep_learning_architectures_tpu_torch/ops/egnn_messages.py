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
computes :func:`egnn_messages_plain`, the dense masked-mean formula; on a
CUDA tensor it launches the kernel (He = Hc = 128, silu) and counts the
launch: an f32 launch in ``fused_egnn_messages.launches``, a bf16 one in
``fused_egnn_messages.launches_bf16``.

Operand types follow the TPU kernel body (``ops/pallas/egnn_messages.py:66-115``):
``hA``, ``hB`` and the weights share one operand dtype (float32, or bfloat16
in the mixed-bf16 model), ``geom`` and the mask are float32.  Every matmul
operand is rounded to the operand dtype (``geom[..., :5]``, ``m1``, ``m2`` and
the silu output before ``wc2``) and every product accumulates in float32, as
do the elementwise work and the masked sums; ``agg`` comes back in the
operand dtype and ``trans`` in float32.  With float32 (or float64) operands
no rounding step does anything.

The kernel has no backward: on a CUDA tensor the wrapper refuses to run when
autograd would need one (see :func:`refuse_grad`).
"""

from __future__ import annotations

from typing import Tuple

from .. import _tf32  # noqa: F401  (TF32 off before torch is used)
import torch

from ..core.graph import masked_segment_mean
from ..models.common import get_activation
from . import _build

KERNEL_WIDTH = 128  # He and Hc the kernel is compiled for
MAX_RECEIVERS = 16  # receivers a block sums at once (kMaxTi in the source)


def edge_stage_plain(
    hA, hB, geom, mask, w_geom, W2, b2, Wc1, bc1, wc2,
    tanh: bool = True, activation: str = "silu", round_geom: bool = True,
    elem_bf16: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The edge stage on a dense ``geom [B, N, N, 8]``, with the rounding points
    of the TPU kernel bodies for the operand dtype ``op = hA.dtype``.

    ``round_geom``: ``geom[..., :5]`` is a matmul operand and is rounded to
    ``op`` (K1's body); K3's body takes it as an f32 product instead.
    ``elem_bf16``: the ``[B, N, N, He]`` silus run in bfloat16, one rounding
    per operation (K3's ``elem_bf16``)."""
    op = hA.dtype
    acc = torch.promote_types(op, torch.float32)  # where products and sums run

    def operand(t):  # a matmul operand: rounded to op, multiplied in acc
        return t.to(op).to(acc)

    W2a, Wc1a, wc2a = operand(W2), operand(Wc1), operand(wc2)
    b2a, bc1a = operand(b2), operand(bc1)
    g = geom[..., 0:5].to(acc)
    g_term = (operand(g) if round_geom else g) @ operand(w_geom)  # [B, N, N, He]
    pre1 = hA.to(acc)[:, :, None, :] + hB.to(acc)[:, None, :, :] + g_term
    act = get_activation(activation)
    if elem_bf16:
        if activation != "silu":
            raise ValueError(f"elem_bf16 computes silu, not {activation!r}")
        m1 = _silu_bf16(pre1.to(torch.bfloat16))
        m2 = _silu_bf16((operand(m1) @ W2a + b2a).to(torch.bfloat16))
    else:
        m2 = act(operand(act(pre1)) @ W2a + b2a)
    # a 0/1 mask multiplies exactly in any dtype, so the masked mean runs in acc
    agg = masked_segment_mean(m2.to(acc), mask).to(op)
    w = operand(act(operand(m2) @ Wc1a + bc1a)) @ wc2a  # [B, N, N]
    if tanh:
        w = torch.tanh(w)
    trans = torch.clamp(w[..., None].to(geom.dtype) * geom[..., 5:8], -100.0, 100.0)
    return agg, masked_segment_mean(trans, mask)


def _silu_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x * (1 / (1 + exp(-x)))`` in bfloat16, rounded after each operation, as
    the TPU body writes it (``ops/pallas/egnn_stream.py:117-122``)."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return x * (one / (one + torch.exp(-x)))


def egnn_messages_plain(
    hA, hB, geom, mask, w_geom, W2, b2, Wc1, bc1, wc2,
    tanh: bool = True, activation: str = "silu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's plain version: the dense reference, which materialises the
    ``[B, N, N, He]`` messages."""
    return edge_stage_plain(hA, hB, geom, mask, w_geom, W2, b2, Wc1, bc1, wc2,
                            tanh, activation, round_geom=True)


def aligned(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Contiguous ``dtype`` with a 16-byte aligned base (the kernels' 16-byte loads)."""
    t = t.to(dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def operand_dtype(operands, f32_inputs) -> torch.dtype:
    """The kernels' operand dtype: float32 or bfloat16, shared by ``operands``
    (hA, hB and the weights).  ``f32_inputs`` (geometry or node data) may be
    any floating dtype: the kernels take them cast to float32."""
    op = operands[0].dtype
    if op not in (torch.float32, torch.bfloat16) or any(t.dtype != op for t in operands):
        raise TypeError("the edge kernels take hA, hB and the weights all in float32 or all "
                        f"in bfloat16, got {sorted({str(t.dtype) for t in operands})}")
    if not all(t.is_floating_point() for t in f32_inputs):
        raise TypeError("the edge kernels take the geometry as floating point, got "
                        f"{sorted({str(t.dtype) for t in f32_inputs})}")
    return op


def at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """Geometry or node data as the kernels take it: a float narrower than
    float32 (a bf16 scene's) cast to float32, as the JAX wrappers cast it
    (``ops/pallas/egnn_messages.py:238``, ``ops/pallas/egnn_stream.py:234-237``);
    float32 and float64 unchanged here (the CUDA launch casts float64 down)."""
    return t.float() if t.is_floating_point() and torch.finfo(t.dtype).bits < 32 else t


def refuse_grad(name: str, tensors) -> None:
    """F2: the kernels have no backward, so a call that autograd would have to
    differentiate raises instead of dropping the gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input requires grad; "
            "run it under torch.no_grad(), or differentiate the plain edge stage: "
            "EGNNMC(edge_impl=\"dense\") (or forward(..., edge_impl=\"dense\")), as the "
            "trainer does")


def launch_blocks(B: int, N: int, sms: int) -> int:
    """The persistent grid of K1 and K3: one block per SM, and no block without a
    receiver."""
    return min(B * N, sms)


def receiver_ranges(B: int, N: int, blocks: int):
    """The split of the ``R = B * N`` receivers ``b * N + i`` over ``blocks``
    blocks that K1 and K3 walk (``csrc/egnn_edge.cuh``, ``for_each_subtile``).

    Block ``k`` owns ``[k R // blocks, (k + 1) R // blocks)``, so the ranges
    differ by at most one receiver, and walks it in sub-tiles of at most
    ``MAX_RECEIVERS`` receivers that never cross a sim: each sim's part of the
    range is cut into the fewest such sub-tiles, evened out.  Returns, per
    block, its sub-tiles ``(b, i0, count)`` in the order it runs them."""
    R = B * N
    out = []
    for k in range(blocks):
        cur, end = k * R // blocks, (k + 1) * R // blocks
        tiles = []
        while cur < end:
            b, i = divmod(cur, N)
            seg = min(end, (b + 1) * N) - cur
            count = -(-seg // MAX_RECEIVERS)
            for q in range(count):
                nrecv = seg // count + (q < seg % count)
                tiles.append((b, i, nrecv))
                i += nrecv
            cur += seg
        out.append(tiles)
    return out


def fused_egnn_messages(
    hA, hB, geom, mask, w_geom, W2, b2, Wc1, bc1, wc2,
    tanh: bool = True, activation: str = "silu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(agg [B, N, He], trans [B, N, 3])``: kernel K1 on a CUDA
    tensor, :func:`egnn_messages_plain` on a CPU tensor.  A bf16 ``geom`` is
    taken as float32 (:func:`at_least_f32`)."""
    geom = at_least_f32(geom)
    if not _build.wants_kernel(hA):
        return egnn_messages_plain(
            hA, hB, geom, mask, w_geom, W2, b2, Wc1, bc1, wc2, tanh, activation
        )
    if activation != "silu":
        raise ValueError(f"the edge kernel computes silu, not {activation!r}")
    operands = (hA, hB, w_geom, W2, b2, Wc1, bc1, wc2)
    op = operand_dtype(operands, (geom,))
    if any(t.device != hA.device for t in (*operands, geom, mask)):
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
    refuse_grad("fused_egnn_messages", (*operands, geom))
    ins = [aligned(t, torch.float32 if i in (2, 3) else op)
           for i, t in enumerate((hA, hB, geom, mask, w_geom, W2, b2, Wc1, bc1, wc2))]
    agg = torch.empty((B, N, He), dtype=op, device=hA.device)
    trans = torch.empty((B, N, 3), dtype=torch.float32, device=hA.device)
    bf16 = op == torch.bfloat16
    name = "nbody_egnn_messages_bf16" if bf16 else "nbody_egnn_messages_f32"
    err = getattr(_build.kernels(), name)(
        *(t.data_ptr() for t in ins), agg.data_ptr(), trans.data_ptr(),
        B, N, He, Hc, launch_blocks(B, N, _build.sm_count(hA)), int(bool(tanh)),
        _build.stream_ptr(hA),
    )
    _build.check(err, name)
    if bf16:
        fused_egnn_messages.launches_bf16 += 1
    else:
        fused_egnn_messages.launches += 1
    return agg, trans


fused_egnn_messages.launches = 0
fused_egnn_messages.launches_bf16 = 0
