"""EquiformerV2: an SO(2)-convolution graph attention transformer, dense.

Counterpart of the JAX package's ``models/equiformer_v2.py``, on the port's
SO(3) edge machinery (:mod:`..ops.so3_edge`).  Node state is an array of
real-SH coefficients ``x [B, N, 9, C]`` (lmax 2, l-primary, e3nn basis); the
edge tensors are dense ``[B, N, N, ...]``, indexed (receiver r, sender s).
All of it is plain PyTorch, as the JAX model is plain einsums (no Pallas
kernel).

Conventions kept from the JAX model:

* the graph is ``adj[b, r, s] = mask[b, s, r]`` and the edge vector
  ``pos_s - pos_r``; the attention message is ``[x_s, x_r]``, sender first
  (SEGNN's is receiver first);
* each edge is rotated onto the z axis (``D``, restricted to ``|m| <= mmax``)
  and back (``D_inv``, whose rows of degree l > mmax are scaled by
  ``sqrt((2l+1)/(2 mmax+1))``), and the SO(2) convolution acts per m;
* the attention softmax runs over the senders of each receiver, the
  aggregation is a masked *sum*, and so is the edge-degree embedding's, over
  ``AVG_DEGREE``;
* LayerNorms use flax's epsilon (:class:`.common.LayerNorm`);
* the blocks, scanned over a stacked parameter axis in the JAX model, are a
  ``ModuleList`` here, and ``remat`` recomputes each one in the backward pass
  (``torch.utils.checkpoint``, non-reentrant).

Submodules and parameters carry the flax module names (``SO2Conv_0``,
``TorchLinear_1``, ``RMSNormSH_0``, ...), so that a ``state_dict`` key is the
flax path of its leaf (``weights`` maps one to the other by rule).

Dropout is live in training mode (``self.training``): alpha dropout on the
attention weights and drop path (one draw a simulation) after the attention
and after the feed-forward of each block.  The masks come from an explicit
``torch.Generator`` that the caller passes (``generator=``) on the model's
device; a training-mode forward with a rate above 0 and no generator raises.
Every block's masks are drawn before the block runs, so a block that
``remat`` recomputes sees the same masks again.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
from .. import _tf32  # noqa: F401  (TF32 off before torch is used)
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core import graph as G
from ..core.scene import Scene
from ..ops import so3_edge as SE
from .common import LayerNorm, TorchLinear, cast_like

LMAX = 2
KFULL = 9  # (LMAX+1)^2
AVG_DEGREE = 23.395238876342773
DISTANCE_WIDTH = 1024  # every distance expansion's width


def _uniform_(t: torch.Tensor, bound: float) -> torch.Tensor:
    with torch.no_grad():
        return t.uniform_(-bound, bound)


def _linear(in_features: int, out_features: int, weight_init: str,
            bias: bool = True) -> TorchLinear:
    """A ``TorchLinear`` with the model's init: ``"normal"`` gives weights
    N(0, 1/sqrt(fan_in)) and zero biases; ``"uniform"`` keeps torch's."""
    lin = TorchLinear(in_features, out_features, bias=bias)
    if weight_init == "normal":
        with torch.no_grad():
            lin.weight.normal_().div_(math.sqrt(in_features))
            if bias:
                lin.bias.zero_()
    return lin


def smooth_leaky_relu(x: torch.Tensor, alpha: float = 0.2) -> torch.Tensor:
    return ((1 + alpha) / 2.0) * x + ((1 - alpha) / 2.0) * x * (
        2.0 * torch.sigmoid(x) - 1.0)


def _embedding(num: int, dim: int) -> nn.Embedding:
    """``nn.Embed`` with the atom-edge init, U(+-0.001)."""
    emb = nn.Embedding(num, dim)
    _uniform_(emb.weight, 0.001)
    return emb


def _add_atom_edge(owner: nn.Module, prefix: str, max_num_elements: int,
                   edge_channels: int) -> None:
    """Give ``owner`` the source and target atom embeddings that
    :func:`_concat_atom_edge` appends to the edge scalars, named
    ``{prefix}source_embedding`` and ``{prefix}target_embedding``."""
    for side in ("source", "target"):
        owner.add_module(f"{prefix}{side}_embedding", _embedding(max_num_elements, edge_channels))


def _concat_atom_edge(owner: nn.Module, prefix: str, x_edge: torch.Tensor,
                      charges: torch.Tensor) -> torch.Tensor:
    """``[x_edge, source, target]`` over the dense edge grid: the source is
    the sender (broadcast on axis 2), the target the receiver (axis 1)."""
    B, N = charges.shape
    src = cast_like(getattr(owner, f"{prefix}source_embedding")(charges), x_edge)
    tgt = cast_like(getattr(owner, f"{prefix}target_embedding")(charges), x_edge)
    c = src.shape[-1]
    return torch.cat([x_edge, src[:, None, :, :].expand(B, N, N, c),
                      tgt[:, :, None, :].expand(B, N, N, c)], dim=-1)


class RadialFunction(nn.Module):
    """Linear + LayerNorm + SiLU stack ending in a Linear; weights keep
    torch's U(+-1/sqrt(fan_in)), biases are zero.  ``channels`` lists the
    widths, the input's first."""

    def __init__(self, channels: Sequence[int]):
        super().__init__()
        cs = list(channels)
        self.depth = len(cs) - 1
        for i, (a, b) in enumerate(zip(cs[:-1], cs[1:])):
            lin = TorchLinear(a, b)
            with torch.no_grad():
                lin.bias.zero_()
            self.add_module(f"TorchLinear_{i}", lin)
            if i < self.depth - 1:
                self.add_module(f"LayerNorm_{i}", LayerNorm(b))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"TorchLinear_{i}")(x)
            if i < self.depth - 1:
                x = F.silu(getattr(self, f"LayerNorm_{i}")(x))
        return x


def _per_l_rows(mmax: Optional[int]) -> List[Tuple[int, int]]:
    """``(start, stop)`` of each degree's rows in the (restricted) layout."""
    l_of = SE.l_expand_index(LMAX, mmax)
    return [(int(min(i for i, x in enumerate(l_of) if x == l)),
             int(max(i for i, x in enumerate(l_of) if x == l)) + 1) for l in range(LMAX + 1)]


class SO3Linear(nn.Module):
    """Per-degree linear over channels with a bias on l=0: ``weight (lmax+1,
    out, in)`` acts on each degree's rows (consecutive in the l-primary
    layout), ``bias (out,)`` adds to the l=0 row."""

    def __init__(self, in_features: int, out_features: int, mmax: Optional[int] = None,
                 weight_init: str = "normal"):
        super().__init__()
        w = torch.empty(LMAX + 1, out_features, in_features)
        if weight_init == "normal":
            with torch.no_grad():
                w.normal_().div_(math.sqrt(in_features))
        else:
            _uniform_(w, 1.0 / math.sqrt(in_features))
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.rows = _per_l_rows(mmax)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [..., K, C_in]
        w = cast_like(self.weight, x)
        outs = [F.linear(x[..., a:b, :], w[l]) for l, (a, b) in enumerate(self.rows)]
        outs[0] = outs[0] + cast_like(self.bias, x)
        return torch.cat(outs, dim=-2)


class RMSNormSH(nn.Module):
    """Degree-balanced component RMS norm: the l=0 row centred over channels,
    the mean over channels of ``sum_l x^2 / (2l+1) / (lmax+1)``, the scale
    ``(norm + eps)^-1/2``, a per-degree affine weight and a bias on l=0."""

    def __init__(self, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.affine_weight = nn.Parameter(torch.ones(LMAX + 1, num_channels))
        self.affine_bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [..., K, C]
        K, C = x.shape[-2:]
        lmax = int(math.isqrt(K)) - 1
        l_of = SE.l_expand_index(lmax)
        # the degree balance as a column, and the one-hot column of the l=0 row
        balance = SE.on_device(("rms_balance", lmax),
                               lambda: ((1.0 / (2 * l_of + 1)) / (lmax + 1))[:, None], x)
        e0 = SE.on_device(("row0", K), lambda: np.eye(K)[:, :1], x)
        x = x - torch.mean(x[..., 0:1, :], dim=-1, keepdim=True) * e0  # centre l=0
        # the mean over channels of the balanced sum over rows
        norm = torch.sum(x * x * balance, dim=(-2, -1), keepdim=True) / C  # [..., 1, 1]
        inv = (norm + self.eps) ** -0.5
        expand = SE.index_on_device(("l_of", lmax, None), lambda: l_of, x)
        out = x * inv * cast_like(self.affine_weight, x).index_select(0, expand)
        return out + cast_like(self.affine_bias, x) * e0


class SO2Conv(nn.Module):
    """SO(2) convolution over every m: input ``[..., K_r, C_in]`` in the
    restricted l-primary layout (7 rows at mmax 1).  The m=0 rows go through
    ``TorchLinear_0`` (its first ``extra_m0_channels`` outputs returned
    beside), each |m| > 0 pair of -m / +m rows through the bias-free
    ``Dense_{m-1}`` as a complex product.  With ``radial_channels`` a
    ``RadialFunction_0`` of the edge scalars modulates the inputs of each m
    (one weight for the -m and +m rows)."""

    def __init__(self, in_channels: int, m_output_channels: int, mmax: int = 1,
                 extra_m0_channels: int = 0, radial_channels: Optional[Sequence[int]] = None,
                 weight_init: str = "normal"):
        super().__init__()
        self.m_out, self.mmax, self.extra = m_output_channels, mmax, extra_m0_channels
        m0_idx, m_blocks = SE.m_order_indices(LMAX, mmax)
        self.n_l0 = len(m0_idx)
        self.n_lm = [len(minus) for minus, _ in m_blocks]
        C = in_channels
        self.sizes = [self.n_l0 * C] + [n * C for n in self.n_lm]
        self.radial = radial_channels is not None
        if self.radial:
            self.RadialFunction_0 = RadialFunction(list(radial_channels) + [sum(self.sizes)])
        self.TorchLinear_0 = _linear(self.n_l0 * C, self.n_l0 * m_output_channels
                                     + extra_m0_channels, weight_init)
        for mi, n in enumerate(self.n_lm):
            fan, width = n * C, 2 * m_output_channels * n
            fc = nn.Linear(fan, width, bias=False)
            with torch.no_grad():
                if weight_init == "normal":
                    fc.weight.normal_().div_(math.sqrt(fan))
                else:
                    _uniform_(fc.weight, 1.0 / math.sqrt(fan) / math.sqrt(2.0))
            self.add_module(f"Dense_{mi}", fc)

    def forward(self, x: torch.Tensor, x_edge: Optional[torch.Tensor] = None):
        lead, C = x.shape[:-2], x.shape[-1]
        order, inverse = SE.m_order(LMAX, self.mmax)
        xm = x.index_select(-2, SE.index_on_device(("m_order", self.mmax), lambda: order, x))
        if self.radial:
            rad = torch.split(self.RadialFunction_0(x_edge), self.sizes, dim=-1)
        x0 = xm[..., : self.n_l0, :].reshape(lead + (self.n_l0 * C,))
        if self.radial:
            x0 = x0 * rad[0]
        x0 = self.TorchLinear_0(x0)
        extra = x0[..., : self.extra]
        # the pieces in m-major order: the m=0 rows, then each m's -m and +m rows
        pieces = [x0[..., self.extra:].reshape(lead + (self.n_l0, self.m_out))]
        start = self.n_l0
        for mi, n in enumerate(self.n_lm):
            pair = xm[..., start: start + 2 * n, :].reshape(lead + (2, n * C))  # [-m; +m]
            start += 2 * n
            if self.radial:
                pair = pair * rad[mi + 1][..., None, :]
            out = F.linear(pair, cast_like(getattr(self, f"Dense_{mi}").weight, pair))
            x_r, x_i = out.chunk(2, dim=-1)
            pieces += [(x_r[..., 0, :] - x_i[..., 1, :]).reshape(lead + (n, self.m_out)),
                       (x_r[..., 1, :] + x_i[..., 0, :]).reshape(lead + (n, self.m_out))]
        out = torch.cat(pieces, dim=-2).index_select(
            -2, SE.index_on_device(("m_order_inverse", self.mmax), lambda: inverse, x))
        return (out, extra) if self.extra else out


def _grid(mmax: int, like: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    to_g = SE.on_device(("to_grid", mmax), lambda: SE.s2_grid_mats(LMAX, mmax)[0], like)
    from_g = SE.on_device(("from_grid", mmax), lambda: SE.s2_grid_mats(LMAX, mmax)[1], like)
    return to_g, from_g


def _grid_silu(x: torch.Tensor, mmax: int) -> torch.Tensor:
    """SiLU of the signal on the S2 grid, back to coefficients."""
    to_g, from_g = _grid(mmax, x)
    return from_g @ F.silu(to_g @ x)


class SeparableS2Act(nn.Module):
    """SiLU on the grid for the l>0 rows, ``silu(gating)`` as the l=0 row."""

    def __init__(self, mmax: int = 1):
        super().__init__()
        self.mmax = mmax

    def forward(self, gating_scalars: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        x_sph = _grid_silu(x, self.mmax)
        return torch.cat([F.silu(gating_scalars)[..., None, :], x_sph[..., 1:, :]], dim=-2)


class GateActivationSH(nn.Module):
    """Sigmoid gates, one a (l > 0, channel), expanded over each l's rows of
    the restricted layout, scale the l>0 rows; SiLU on the l=0 row."""

    def __init__(self, lmax: int = LMAX, mmax: int = 1):
        super().__init__()
        self.lmax, self.mmax = lmax, mmax
        self.expand = [l - 1 for l in range(1, lmax + 1) for _ in range(min(2 * l + 1,
                                                                          2 * mmax + 1))]

    def forward(self, gating_scalars: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        C = x.shape[-1]
        g = torch.sigmoid(gating_scalars).reshape(gating_scalars.shape[:-1] + (self.lmax, C))
        rows = SE.index_on_device(("gate_rows", self.lmax, self.mmax), lambda: self.expand, x)
        return torch.cat([F.silu(x[..., :1, :]), x[..., 1:, :] * g.index_select(-2, rows)],
                         dim=-2)


class S2Act(nn.Module):
    """SiLU on the full grid signal, l=0 included."""

    def __init__(self, mmax: int = 1):
        super().__init__()
        self.mmax = mmax

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _grid_silu(x, self.mmax)


def _restrict_rows(mmax: int, like: torch.Tensor) -> torch.Tensor:
    return SE.index_on_device(("restricted", mmax), lambda: SE.restricted_indices(LMAX, mmax),
                              like)


class SO2Attention(nn.Module):
    """Equivariant graph attention through SO(2) convolutions: the message
    ``[x_s, x_r]`` rotated into each edge's frame, ``SO2Conv_0`` (radial
    modulated, with the attention's extra m=0 channels), the activation,
    ``SO2Conv_1``, the attention weights (``LayerNorm_0``, smooth leaky ReLU,
    ``alpha_dot``, a softmax over senders, alpha dropout), the values rotated
    back, summed at the receiver and mixed by ``SO3Linear_0``.  Output
    ``[B, N, 9, output_channels]``."""

    def __init__(self, sphere_channels: int, hidden_channels: int, num_heads: int,
                 alpha_channels: int, value_channels: int, output_channels: int,
                 edge_channels: int, edge_in: int, alpha_drop: float = 0.1,
                 use_gate_act: bool = False, use_sep_s2_act: bool = True,
                 use_m_share_rad: bool = False, use_attn_renorm: bool = True,
                 use_atom_edge_embedding: bool = True, max_num_elements: int = 90,
                 weight_init: str = "normal", mmax: int = 1):
        super().__init__()
        C = sphere_channels
        self.C, self.heads, self.alpha_ch, self.value_ch = C, num_heads, alpha_channels, value_channels
        self.alpha_drop, self.mmax = alpha_drop, mmax
        self.use_gate_act, self.use_sep_s2_act = use_gate_act, use_sep_s2_act
        self.use_m_share_rad, self.use_attn_renorm = use_m_share_rad, use_attn_renorm
        self.use_atom_edge = use_atom_edge_embedding
        if use_atom_edge_embedding:
            _add_atom_edge(self, "", max_num_elements, edge_channels)
            edge_in += 2 * edge_channels
        if use_m_share_rad:
            self.RadialFunction_0 = RadialFunction([edge_in, edge_channels, edge_channels,
                                                    2 * C * (LMAX + 1)])
        n_alpha = num_heads * alpha_channels
        self.n_alpha = n_alpha
        if use_gate_act:
            extra_ch = n_alpha + LMAX * hidden_channels
            self.act = GateActivationSH(mmax=mmax)
        elif use_sep_s2_act:
            extra_ch = n_alpha + hidden_channels
            self.act = SeparableS2Act(mmax)
        else:
            extra_ch = n_alpha
            self.act = S2Act(mmax)
        self.SO2Conv_0 = SO2Conv(2 * C, hidden_channels, mmax, extra_ch,
                                 None if use_m_share_rad else (edge_in, edge_channels,
                                                               edge_channels), weight_init)
        self.SO2Conv_1 = SO2Conv(hidden_channels, num_heads * value_channels, mmax,
                                 weight_init=weight_init)
        if use_attn_renorm:
            self.LayerNorm_0 = LayerNorm(alpha_channels)
        self.alpha_dot = nn.Parameter(_uniform_(torch.empty(num_heads, alpha_channels),
                                                1.0 / math.sqrt(alpha_channels)))
        self.SO3Linear_0 = SO3Linear(num_heads * value_channels, output_channels,
                                     weight_init=weight_init)

    def forward(self, x, x_edge, D, D_inv, adj, charges, alpha_keep=None):
        """x ``[B,N,9,C]``; x_edge ``[B,N,N,Ce]``; D ``[B,N,N,7,9]`` (rotate and
        restrict); D_inv ``[B,N,N,9,7]``; adj ``[B,N,N]`` (receiver r from
        senders s); charges ``[B,N]`` int64; ``alpha_keep`` the alpha dropout's
        kept entries ``[B,N,N,heads]`` (bool), or None for no dropout."""
        B, N = x.shape[:2]
        C = self.C
        if self.use_atom_edge:
            x_edge = _concat_atom_edge(self, "", x_edge, charges)
        shape = (B, N, N, KFULL, C)
        msg = torch.cat([x[:, None].expand(shape), x[:, :, None].expand(shape)], dim=-1)
        if self.use_m_share_rad:
            rad = self.RadialFunction_0(x_edge).reshape(x_edge.shape[:-1] + (LMAX + 1, 2 * C))
            l_of = SE.index_on_device(("l_of", LMAX, None), lambda: SE.l_expand_index(LMAX), x)
            msg = msg * rad.index_select(-2, l_of)
        msg = D @ msg  # [B,N,N,7,2C]
        msg, extra = self.SO2Conv_0(msg, x_edge)
        alpha_feat = extra[..., : self.n_alpha]
        if self.use_gate_act or self.use_sep_s2_act:
            msg = self.act(extra[..., self.n_alpha:], msg)
        else:
            msg = self.act(msg)
        msg = self.SO2Conv_1(msg)

        a = alpha_feat.reshape(alpha_feat.shape[:-1] + (self.heads, self.alpha_ch))
        if self.use_attn_renorm:
            a = self.LayerNorm_0(a)
        a = smooth_leaky_relu(a)
        alpha = torch.sum(a * cast_like(self.alpha_dot, a), dim=-1)  # [B,N,N,H]
        no_edge = ~adj[..., None]
        alpha = torch.softmax(alpha.masked_fill(no_edge, -1e9), dim=2)  # over senders
        alpha = alpha.masked_fill(no_edge, 0.0)
        if alpha_keep is not None:
            alpha = (alpha / (1.0 - self.alpha_drop)).masked_fill(~alpha_keep, 0.0)

        v = msg.reshape(msg.shape[:-1] + (self.heads, self.value_ch))
        v = (v * alpha[..., None, :, None]).reshape(msg.shape)
        v = D_inv @ v  # [B,N,N,9,HV]
        return self.SO3Linear_0(G.masked_segment_sum(v, adj))


class FeedForward(nn.Module):
    """The feed-forward with the S2 (separable or not), gate or grid-MLP
    activation, between ``SO3Linear_0`` and ``SO3Linear_1``; ``TorchLinear_k``
    are the gating linear (where there is one) and the grid MLP's layers, in
    the order flax numbers them."""

    def __init__(self, sphere_channels: int, hidden_channels: int, output_channels: int,
                 use_gate_act: bool = False, use_grid_mlp: bool = False,
                 use_sep_s2_act: bool = True, weight_init: str = "normal"):
        super().__init__()
        C, H, wi = sphere_channels, hidden_channels, weight_init
        self.use_gate_act, self.use_grid_mlp, self.use_sep_s2_act = (
            use_gate_act, use_grid_mlp, use_sep_s2_act)
        k = 0
        if use_grid_mlp:
            if use_sep_s2_act:
                self.TorchLinear_0 = _linear(C, H, wi)
                k = 1
            self.SO3Linear_0 = SO3Linear(C, H, weight_init=wi)
            self.grid_layers = [f"TorchLinear_{k + i}" for i in range(3)]
            for name in self.grid_layers:
                self.add_module(name, _linear(H, H, wi, bias=False))
        elif use_gate_act:
            self.TorchLinear_0 = _linear(C, LMAX * H, wi)
            self.SO3Linear_0 = SO3Linear(C, H, weight_init=wi)
            self.act = GateActivationSH(mmax=LMAX)
        elif use_sep_s2_act:
            self.TorchLinear_0 = _linear(C, H, wi)
            self.SO3Linear_0 = SO3Linear(C, H, weight_init=wi)
            self.act = SeparableS2Act(mmax=LMAX)
        else:
            self.SO3Linear_0 = SO3Linear(C, H, weight_init=wi)
            self.act = S2Act(mmax=LMAX)
        self.SO3Linear_1 = SO3Linear(H, output_channels, weight_init=wi)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_grid_mlp:
            gating = F.silu(self.TorchLinear_0(x[..., 0, :])) if self.use_sep_s2_act else None
            h = self.SO3Linear_0(x)
            to_g, from_g = _grid(LMAX, h)
            hg = to_g @ h
            for i, name in enumerate(self.grid_layers):
                hg = getattr(self, name)(hg)
                if i < 2:
                    hg = F.silu(hg)
            h = from_g @ hg
            if self.use_sep_s2_act:
                h = torch.cat([gating[..., None, :], h[..., 1:, :]], dim=-2)
        elif self.use_gate_act or self.use_sep_s2_act:
            h = self.act(self.TorchLinear_0(x[..., 0, :]), self.SO3Linear_0(x))
        else:
            h = self.act(self.SO3Linear_0(x))
        return self.SO3Linear_1(h)


def _drop_path(h: torch.Tensor, keep_mask: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """``h * mask / keep`` with one kept-or-dropped draw a simulation."""
    if keep_mask is None:
        return h
    return h * keep_mask.to(h.dtype)[:, None, None, None] / (1.0 - rate)


class TransBlock(nn.Module):
    """Pre-norm attention and feed-forward with residuals and drop path:
    ``RMSNormSH_0``, ``SO2Attention_0``, ``RMSNormSH_1``, ``FeedForward_0``."""

    def __init__(self, sphere_channels: int, attn_hidden_channels: int, num_heads: int,
                 alpha_channels: int, value_channels: int, ffn_hidden_channels: int,
                 edge_channels: int, edge_in: int, alpha_drop: float, drop_path: float,
                 use_gate_act: bool, use_grid_mlp: bool, use_sep_s2_act: bool,
                 use_m_share_rad: bool, use_attn_renorm: bool, use_atom_edge_embedding: bool,
                 max_num_elements: int, weight_init: str, mmax: int):
        super().__init__()
        C = sphere_channels
        self.drop_path = drop_path
        self.RMSNormSH_0 = RMSNormSH(C)
        self.SO2Attention_0 = SO2Attention(
            C, attn_hidden_channels, num_heads, alpha_channels, value_channels, C,
            edge_channels, edge_in, alpha_drop, use_gate_act, use_sep_s2_act, use_m_share_rad,
            use_attn_renorm, use_atom_edge_embedding, max_num_elements, weight_init, mmax)
        self.RMSNormSH_1 = RMSNormSH(C)
        self.FeedForward_0 = FeedForward(C, ffn_hidden_channels, C, use_gate_act, use_grid_mlp,
                                         use_sep_s2_act, weight_init)

    def forward(self, x, x_edge, D, D_inv, adj, charges, alpha_keep=None, keep_attn=None,
                keep_ffn=None):
        h = self.SO2Attention_0(self.RMSNormSH_0(x), x_edge, D, D_inv, adj, charges, alpha_keep)
        x = x + _drop_path(h, keep_attn, self.drop_path)
        h = self.FeedForward_0(self.RMSNormSH_1(x))
        return x + _drop_path(h, keep_ffn, self.drop_path)


class EquiformerV2(nn.Module):
    """``forward(scene, mask, train=False, generator=None) -> [B, N, 6]``
    (pos_dt | vel).  Dropout follows ``self.training``; ``train`` is taken
    for the JAX signature's sake.  ``generator`` (a ``torch.Generator`` on
    the scene's device) draws the dropout masks; a training-mode forward
    with a rate above 0 needs one."""

    def __init__(
        self,
        num_layers: int = 4,
        sphere_channels: int = 64,
        attn_hidden_channels: int = 64,
        num_heads: int = 4,
        attn_alpha_channels: int = 8,
        attn_value_channels: int = 4,
        ffn_hidden_channels: int = 64,
        edge_channels: int = 64,
        num_distance_basis: int = 64,  # kept for config parity (projection path)
        max_neighbors: int = 5,
        max_radius: float = 4096.0,
        max_num_elements: int = 90,
        alpha_drop: float = 0.1,
        drop_path_rate: float = 0.05,
        lmax: int = 2,
        mmax: int = 1,
        use_gate_act: bool = False,
        use_grid_mlp: bool = False,
        use_sep_s2_act: bool = True,
        use_m_share_rad: bool = False,
        use_attn_renorm: bool = True,
        use_atom_edge_embedding: bool = True,
        share_atom_edge_embedding: bool = False,
        weight_init: str = "normal",
        equivariant_embedding: bool = False,
        distance_function: str = "projection",
        remat: bool = False,
    ):
        super().__init__()
        self.init_kwargs = {k: v for k, v in locals().items()
                            if k not in ("self", "__class__")}
        if lmax != LMAX:
            # the SH machinery (restricted layout, Wigner blocks, S2 grids,
            # SO3Linear tables) is specialised to lmax 2
            raise NotImplementedError(
                f"EquiformerV2 is specialised to lmax={LMAX}; got lmax={lmax}")
        if mmax != 1:
            # the JAX model's SO(2) convolutions and activations are built for
            # the mmax 1 layout whatever mmax the model is given
            raise NotImplementedError(f"EquiformerV2 is built for mmax=1; got mmax={mmax}")
        if distance_function not in ("projection", "gaussian", "exponential_decay"):
            raise ValueError(distance_function)
        C = sphere_channels
        self.sphere_channels, self.num_heads = C, num_heads
        self.max_num_elements, self.max_radius = max_num_elements, max_radius
        self.alpha_drop, self.drop_path_rate = alpha_drop, drop_path_rate
        self.mmax, self.remat = mmax, remat
        self.equivariant_embedding = equivariant_embedding
        self.distance_function = distance_function
        self.use_atom_edge = use_atom_edge_embedding
        self.share_atom_edge = use_atom_edge_embedding and share_atom_edge_embedding
        self.blocks_atom_edge = use_atom_edge_embedding and not share_atom_edge_embedding

        self.Embed_0 = nn.Embedding(max_num_elements, C)  # N(0, 1), torch's default
        linears = 0
        if equivariant_embedding:
            self.vel_gate = nn.Parameter(torch.ones(C))
        else:
            self.TorchLinear_0 = _linear(3, 3 * C, weight_init)
            linears = 1
        self.distance_linear = None
        if distance_function == "exponential_decay":
            self.decay_scale = nn.Parameter(torch.ones(()))
        if distance_function != "gaussian":
            self.distance_linear = f"TorchLinear_{linears}"
            self.add_module(self.distance_linear, _linear(1, DISTANCE_WIDTH, weight_init))
        edge_in = DISTANCE_WIDTH
        if self.share_atom_edge:
            _add_atom_edge(self, "shared_", max_num_elements, edge_channels)
            edge_in += 2 * edge_channels
        degree_in = edge_in
        if self.blocks_atom_edge:
            _add_atom_edge(self, "edge_degree_", max_num_elements, edge_channels)
            degree_in += 2 * edge_channels
        self.RadialFunction_0 = RadialFunction([degree_in, edge_channels, edge_channels,
                                                (LMAX + 1) * C])
        block = dict(attn_hidden_channels=attn_hidden_channels, num_heads=num_heads,
                     alpha_channels=attn_alpha_channels, value_channels=attn_value_channels,
                     edge_channels=edge_channels, edge_in=edge_in,
                     use_gate_act=use_gate_act, use_sep_s2_act=use_sep_s2_act,
                     use_m_share_rad=use_m_share_rad, use_attn_renorm=use_attn_renorm,
                     use_atom_edge_embedding=self.blocks_atom_edge,
                     max_num_elements=max_num_elements, weight_init=weight_init, mmax=mmax)
        self.blocks = nn.ModuleList(
            TransBlock(C, ffn_hidden_channels=ffn_hidden_channels, alpha_drop=alpha_drop,
                       drop_path=drop_path_rate, use_grid_mlp=use_grid_mlp, **block)
            for _ in range(num_layers))
        self.RMSNormSH_0 = RMSNormSH(C)
        head = dict(block)
        head.pop("attn_hidden_channels")
        self.SO2Attention_0 = SO2Attention(C, attn_hidden_channels, output_channels=2,
                                           alpha_drop=0.0, **head)

    @property
    def draws_dropout(self) -> bool:
        """Whether a forward now draws dropout masks (and so needs a generator)."""
        return self.training and (self.alpha_drop > 0.0 or self.drop_path_rate > 0.0)

    def draw_masks(self, B: int, N: int, generator: Optional[torch.Generator],
                   device) -> list:
        """Each block's ``(alpha_keep [B,N,N,H], keep_attn [B], keep_ffn [B])``
        (None where a rate is 0 or the model is in eval mode), drawn in block
        order from ``generator``: ``uniform < keep``, as ``jax.random.bernoulli``."""
        if not self.draws_dropout:
            return [(None, None, None)] * len(self.blocks)
        if generator is None:
            raise ValueError(
                "EquiformerV2 in training mode draws dropout masks (alpha_drop "
                f"{self.alpha_drop}, drop_path_rate {self.drop_path_rate}): pass a "
                "torch.Generator on the model's device as generator=, or call model.eval()")

        def keep(shape, rate):
            if rate <= 0.0:
                return None
            return torch.rand(shape, generator=generator, device=device) < 1.0 - rate

        return [(keep((B, N, N, self.num_heads), self.alpha_drop),
                 keep((B,), self.drop_path_rate), keep((B,), self.drop_path_rate))
                for _ in self.blocks]

    def forward(self, scene: Scene, mask: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        pos = scene.pos
        B, N = pos.shape[:2]
        C = self.sphere_channels
        dtype = pos.dtype
        masks = self.draw_masks(B, N, generator, pos.device)

        adj = mask.transpose(1, 2)
        edge_vec = -G.rel_positions(pos)  # pos_s - pos_r at [r, s]
        dist = G.safe_sqrt(torch.sum(edge_vec * edge_vec, dim=-1, keepdim=True))

        # per-edge frames and Wigner blocks, restricted to |m| <= mmax
        Dfull = SE.wigner_full(SE.edge_align_rotation(edge_vec))  # [B,N,N,9,9]
        ridx = _restrict_rows(self.mmax, pos)
        D = Dfull.index_select(-2, ridx)  # [., 7, 9]
        # rotate back; rows of degree l > mmax scaled by sqrt((2l+1)/(2 mmax+1))
        mmax = self.mmax
        l_of = SE.l_expand_index(LMAX)
        row_scale = SE.on_device(
            ("row_scale", mmax),
            lambda: [math.sqrt((2.0 * l + 1.0) / (2.0 * mmax + 1.0)) if l > mmax else 1.0
                     for l in l_of], pos)
        D_inv = Dfull.transpose(-1, -2).index_select(-1, ridx) * row_scale[:, None]

        # node init: charges -> l=0, velocity -> l=1; gravity scenes carry no
        # charge, and their mass (1) stands in
        q = scene.charge if scene.charge is not None else scene.mass
        charges = torch.clamp(q[..., 0].to(torch.int64), 0, self.max_num_elements - 1)
        sphere = cast_like(self.Embed_0(charges), pos)
        if self.equivariant_embedding:
            vel = scene.vel[..., [1, 2, 0]][..., None] * cast_like(self.vel_gate, pos)
        else:
            vel = self.TorchLinear_0(scene.vel).reshape(B, N, 3, C)
        x = torch.cat([sphere[:, :, None, :], vel, pos.new_zeros(B, N, KFULL - 4, C)], dim=-2)

        # distance expansion
        if self.distance_function == "projection":
            x_edge = getattr(self, self.distance_linear)(dist)
        elif self.distance_function == "gaussian":
            offsets = torch.linspace(0.0, self.max_radius, DISTANCE_WIDTH, dtype=dtype,
                                     device=pos.device)
            width = 2.0 * (self.max_radius / (DISTANCE_WIDTH - 1))
            coeff = -0.5 / width**2
            x_edge = torch.exp(coeff * (dist - offsets) ** 2)
        else:  # exponential_decay
            x_edge = getattr(self, self.distance_linear)(
                torch.exp(-cast_like(self.decay_scale, pos) * torch.abs(dist)))
        if self.share_atom_edge:
            x_edge = _concat_atom_edge(self, "shared_", x_edge, charges)

        # edge-degree embedding: radial -> m=0 rows, rotated back, summed at
        # the receiver over AVG_DEGREE
        x_edge_deg = x_edge
        if self.blocks_atom_edge:
            x_edge_deg = _concat_atom_edge(self, "edge_degree_", x_edge, charges)
        ed = self.RadialFunction_0(x_edge_deg).reshape(B, N, N, LMAX + 1, C)
        m0 = SE.index_on_device(("m0", mmax), lambda: SE.m_order_indices(LMAX, mmax)[0], pos)
        ed_back = D_inv.index_select(-1, m0) @ ed  # the m=0 columns; the rest meet zeros
        x = x + G.masked_segment_sum(ed_back, adj) / AVG_DEGREE

        for blk, drawn in zip(self.blocks, masks):
            args = (x, x_edge, D, D_inv, adj, charges, *drawn)
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(blk, *args, use_reentrant=False)
            else:
                x = blk(*args)

        x = self.RMSNormSH_0(x)
        pred = self.SO2Attention_0(x, x_edge, D, D_inv, adj, charges)
        # the l=1 rows (y, z, x) -> physical (x, y, z)
        vecs = pred[..., 1:4, :]  # [B,N,3,2]
        xyz = torch.stack([vecs[..., 2, :], vecs[..., 0, :], vecs[..., 1, :]], dim=-2)
        return torch.cat([xyz[..., 0], xyz[..., 1]], dim=-1)

    def get_model_size(self) -> int:
        """Width used by the Noam LR schedule."""
        return self.sphere_channels
