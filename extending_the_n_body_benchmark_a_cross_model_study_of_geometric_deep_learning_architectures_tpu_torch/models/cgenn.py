"""CGENN: Clifford group-equivariant network, dense.

Counterpart of the JAX package's ``models/cgenn.py`` on the port's own Cl(3)
tables (:mod:`..ops.clifford`).  Node state is ``[B, N, C, 8]`` multivectors.
Per layer an edge Clifford MLP on the messages ``h_i - h_j`` (receiver minus
sender, ``[B, N, N, C, 8]``), their masked mean over senders, a node Clifford
MLP on ``[h, agg]`` and the residual.  Each Clifford MLP sublayer is an
``MVLinear`` (channel mixing per grade, a bias on the scalar blade), an
``MVSiLU`` gate, a weighted geometric product and an ``MVLayerNorm``.

The algebra's signature is the eigenvalues of a frozen metric (``0.5 I + 1e-4
rand``, symmetrised), not (1, 1, 1); inputs are turned into its eigenbasis
and predictions back.  So the model is equivariant only up to that metric's
departure from the identity: a rotation leaves a residual far above rounding,
the same in both packages.

The geometric product's table is float32 whatever the input's dtype, as the
JAX model builds it: ``cayley * w8`` is formed in the parameters' dtype from
the float32-rounded table and only then cast to the input's; the gate and the
norms take the table in the input's dtype.  The product is contracted in two
steps, the right operand with the weight to ``[rows, C, 8, 8]``, then with the
left operand (a product and a sum over its blades), never materialising
``[rows, C, 8, 8, 8]``.  Scatters and repeats onto the blades are products
with 0/1 matrices, exact as the gathers they replace.

Submodules and parameters carry the flax names (``MVLinear_0`` the
embedding, ``MVLinear_1`` the readout; in each layer ``CEMLP_0`` (edge) and
``CEMLP_1`` (node), each with ``MVLinear_k``, ``MVSiLU_k``,
``SteerableGeometricProduct_k``, ``MVLayerNorm_k``); the layers, scanned over
a stacked parameter axis (``Scan_EGCL_0``) in the JAX model, are a
``ModuleList`` here, and ``remat`` recomputes each one in the backward pass
(``torch.utils.checkpoint``, non-reentrant) with the same parameters.  The
tables are non-persistent buffers, outside the ``state_dict``.  Plain
PyTorch; no dropout.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
from .. import _tf32  # noqa: F401  (TF32 off before torch is used)
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core import graph as G
from ..core.scene import Scene
from ..ops import clifford as cl
from .common import cast_like

# [8, 4]: 1 where a blade belongs to a grade.  A per-blade [..., 8] tensor
# times it sums each grade's blades; a per-grade [..., 4] tensor times its
# transpose repeats each grade over its blades (``jnp.repeat(...,
# SUBSPACES)``), exactly: every output is one input times 1 plus zeros
_GRADE_SUM = torch.from_numpy(
    (cl.GRADES[:, None] == np.arange(4)[None, :]).astype(np.float64))


def _repeat(t: torch.Tensor, grade_sum: torch.Tensor) -> torch.Tensor:
    """``[..., 4]`` per grade -> ``[..., 8]`` per blade."""
    return t @ cast_like(grade_sum, t).T


class _Tables(nn.Module):
    """A module holding the algebra's constants as non-persistent buffers:
    ``bc0`` (``[8]``, the beta signs times the diagonal of ``C[:, 0, :]``,
    in float64, cast with the model) and the grade table ``_GRADE_SUM``."""

    def __init__(self, algebra_sig):
        super().__init__()
        c0 = np.diagonal(cl.cayley_table(algebra_sig)[:, 0, :]).copy()
        self.register_buffer("bc0", torch.from_numpy(cl.BETA_SIGNS * c0), persistent=False)
        self.register_buffer("grade_sum", _GRADE_SUM.clone(), persistent=False)

    def repeat(self, t: torch.Tensor) -> torch.Tensor:
        return _repeat(t, self.grade_sum)

    def mag2(self, x: torch.Tensor) -> torch.Tensor:
        """Per-grade quadratic form ``[..., C, 8] -> [..., C, 4]``: the scalar
        part of ``beta(x) x`` within each grade.  ``C[:, 0, :]`` is diagonal
        (a blade times another has no scalar part), so the JAX model's
        ``(beta x) * (C0 @ x)`` is ``x * (beta c0 x)`` bit for bit."""
        full = x * (cast_like(self.bc0, x) * x)
        return full @ cast_like(self.grade_sum, x)


def _smooth_abs_sqrt(q: torch.Tensor, eps: float = 1e-16) -> torch.Tensor:
    return (q * q + eps) ** 0.25


class MVLinear(nn.Module):
    """Channel mixing per blade subspace: weight ``[out, in, 4]`` repeated to
    the 8 blades, or ``[out, in]`` for all blades with ``subspaces=False``;
    the bias goes to the scalar blade."""

    def __init__(self, in_features: int, out_features: int, subspaces: bool = True,
                 use_bias: bool = True):
        super().__init__()
        self.subspaces = subspaces
        shape = (out_features, in_features, 4) if subspaces else (out_features, in_features)
        self.weight = nn.Parameter(torch.empty(shape))
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / math.sqrt(in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None
        self.register_buffer("grade_sum", _GRADE_SUM.clone(), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # x [..., C_in, 8]
        w = self.weight
        if self.subspaces:
            w8 = cast_like(_repeat(w, self.grade_sum), x)  # [O, I, 8]
            out = torch.einsum("...mi,nmi->...ni", x, w8)
        else:
            out = torch.einsum("...mi,nm->...ni", x, cast_like(w, x))
        if self.bias is not None:
            out = torch.cat([out[..., :1] + cast_like(self.bias, x)[:, None], out[..., 1:]],
                            dim=-1)
        return out


class MVSiLU(nn.Module):
    """Sigmoid gate per grade from the invariants (the scalar blade, and the
    quadratic forms of grades 1-3), affine ``(a, b)`` per channel and grade."""

    def __init__(self, algebra_sig, channels: int):
        super().__init__()
        self.a = nn.Parameter(torch.ones(channels, 4))
        self.b = nn.Parameter(torch.zeros(channels, 4))
        self.tables = _Tables(algebra_sig)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.tables.mag2(x)  # [..., C, 4]
        invariants = torch.cat([x[..., :1], q[..., 1:]], dim=-1)
        gates = cast_like(self.a, x) * invariants + cast_like(self.b, x)
        return torch.sigmoid(self.tables.repeat(gates)) * x


class _Normalization(nn.Module):
    """The right operand divided by its per-grade norms, interpolated towards
    1 by ``sigmoid(a)``."""

    def __init__(self, algebra_sig, features: int, init: float = 0.0):
        super().__init__()
        self.a = nn.Parameter(torch.full((features, 4), float(init)))
        self.tables = _Tables(algebra_sig)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norms = _smooth_abs_sqrt(self.tables.mag2(x))  # [..., C, 4]
        s_a = torch.sigmoid(cast_like(self.a, x))
        norms = s_a * (norms - 1.0) + 1.0
        return x / (self.tables.repeat(norms) + 1e-6)


class SteerableGeometricProduct(nn.Module):
    """The weighted geometric product ``x (w * C) x_right``, one weight per
    channel and grade path, ``x_right`` a bias-free ``MVLinear`` of ``x``
    (normalised unless ``normalization_init`` is None), plus the first-order
    term ``MVLinear(x)``, over sqrt(2)."""

    def __init__(self, algebra_sig, features: int, normalization_init: Optional[float] = 0.0,
                 include_first_order: bool = True):
        super().__init__()
        n_paths = int(cl.geometric_product_paths().sum())
        self.weight = nn.Parameter(torch.empty(features, n_paths))
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / math.sqrt(cl.DIM + 1))
        # the table rounded to float32 (the JAX model's), held in float64 so
        # that a float64 model keeps exactly those values
        cayley32 = cl.cayley_table(algebra_sig).astype(np.float32).astype(np.float64)
        self.register_buffer("cayley", torch.from_numpy(cayley32), persistent=False)
        # [20, 512]: 1 where a path's weight goes onto a blade triple
        index = cl.path_index().reshape(-1)
        scatter = (np.arange(n_paths)[:, None] == index[None, :]).astype(np.float64)
        self.register_buffer("path_scatter", torch.from_numpy(scatter), persistent=False)
        self.MVLinear_0 = MVLinear(features, features, use_bias=False)
        if normalization_init is not None:
            self._Normalization_0 = _Normalization(algebra_sig, features, normalization_init)
        self.include_first_order = include_first_order
        if include_first_order:
            self.MVLinear_1 = MVLinear(features, features, use_bias=True)

    def product_weight(self) -> torch.Tensor:
        """``[C, 8, 8, 8]``: the table times the path weights scattered onto
        the grade grid and repeated onto the blades (exactly: every entry is
        one weight times 1 plus zeros), in the parameters' dtype."""
        w = self.weight
        w8 = (w @ cast_like(self.path_scatter, w)).view(w.shape[0], 8, 8, 8)
        return cast_like(self.cayley, w) * w8

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = cast_like(self.product_weight(), x)
        x_right = self.MVLinear_0(x)
        if hasattr(self, "_Normalization_0"):
            x_right = self._Normalization_0(x_right)
        C = weight.shape[0]
        rows = x_right.reshape(-1, C, 8).transpose(0, 1).contiguous()  # [C, rows, 8(k)]
        w = weight.permute(0, 3, 1, 2).reshape(C, 8, 64)  # [C, k, (i, j)]
        t = torch.bmm(rows, w).transpose(0, 1).reshape(x.shape + (8,))  # [..., C, 8(i), 8(j)]
        gp = torch.sum(x[..., :, None] * t, dim=-2)
        if self.include_first_order:
            return (self.MVLinear_1(x) + gp) / math.sqrt(2.0)
        return gp


class MVLayerNorm(nn.Module):
    """Division by the channel mean of each multivector's smoothed norm."""

    def __init__(self, algebra_sig, channels: int):
        super().__init__()
        self.a = nn.Parameter(torch.ones(channels))
        self.tables = _Tables(algebra_sig)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q_total = self.tables.mag2(x).sum(-1, keepdim=True)  # the whole multivector's q
        norm = _smooth_abs_sqrt(q_total).mean(dim=-2, keepdim=True) + 1e-6
        return cast_like(self.a, x)[:, None] * x / norm


class CEMLP(nn.Module):
    """``(MVLinear -> MVSiLU -> geometric product -> MVLayerNorm) x n_layers``."""

    def __init__(self, algebra_sig, in_features: int, hidden_features: int, out_features: int,
                 n_layers: int = 2, normalization_init: Optional[float] = 0.0):
        super().__init__()
        self.n_layers = n_layers
        feats = [hidden_features] * (n_layers - 1) + [out_features]
        for k, f in enumerate(feats):
            setattr(self, f"MVLinear_{k}", MVLinear(in_features, f))
            setattr(self, f"MVSiLU_{k}", MVSiLU(algebra_sig, f))
            setattr(self, f"SteerableGeometricProduct_{k}",
                    SteerableGeometricProduct(algebra_sig, f, normalization_init))
            setattr(self, f"MVLayerNorm_{k}", MVLayerNorm(algebra_sig, f))
            in_features = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for k in range(self.n_layers):
            for name in ("MVLinear", "MVSiLU", "SteerableGeometricProduct", "MVLayerNorm"):
                x = getattr(self, f"{name}_{k}")(x)
        return x


class _EGCL(nn.Module):
    """One Clifford message-passing layer: ``h [B, N, C, 8]``, ``mask [B, N,
    N]`` (receiver ``i`` aggregates over senders ``j``)."""

    def __init__(self, algebra_sig, hidden_features: int, residual: bool = True,
                 normalization_init: Optional[float] = 0.0):
        super().__init__()
        C = hidden_features
        self.residual = residual
        self.CEMLP_0 = CEMLP(algebra_sig, C, C, C, normalization_init=normalization_init)
        self.CEMLP_1 = CEMLP(algebra_sig, 2 * C, C, C, normalization_init=normalization_init)

    def forward(self, h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        msg = self.CEMLP_0(h[:, :, None] - h[:, None])  # [B, N, N, C, 8]: receiver - sender
        agg = G.masked_segment_mean(msg, mask)
        out = self.CEMLP_1(torch.cat([h, agg], dim=-2))
        return h + out if self.residual else out


class CGENN(nn.Module):
    """``forward(scene, mask, train=False) -> [B, N, 6]``: the position delta
    and the velocity.  ``train`` is taken for the JAX signature's sake (no
    dropout)."""

    def __init__(self, hidden_features: int = 96, num_layers: int = 4, in_features: int = 3,
                 out_features: int = 2, normalization_init: Optional[float] = 0.0,
                 residual: bool = True, metric_seed: int = 0, remat: bool = False):
        super().__init__()
        self.init_kwargs = {k: v for k, v in locals().items() if k not in ("self", "__class__")}
        self.hidden_features, self.in_features, self.remat = hidden_features, in_features, remat
        eigvals, P, P_inv = cl.reference_metric(metric_seed)
        sig = tuple(float(v) for v in eigvals)
        self.register_buffer("P", torch.from_numpy(P), persistent=False)
        self.register_buffer("P_inv", torch.from_numpy(P_inv), persistent=False)
        self.MVLinear_0 = MVLinear(in_features, hidden_features, subspaces=False)
        self.blocks = nn.ModuleList(
            _EGCL(sig, hidden_features, residual, normalization_init) for _ in range(num_layers))
        self.MVLinear_1 = MVLinear(hidden_features, out_features)

    def forward(self, scene: Scene, mask: torch.Tensor, train: bool = False) -> torch.Tensor:
        pos, vel = scene.pos, scene.vel
        P, P_inv = cast_like(self.P, pos), cast_like(self.P_inv, pos)
        loc_r = (pos - torch.mean(pos, dim=1, keepdim=True)) @ P
        vel_r = vel @ P
        charges = scene.charge if scene.charge is not None else scene.mass
        # invariants at grade 0 of channel 0, covariants at grade 1 of channels 1, 2
        mv = torch.stack([F.pad(charges, (0, 7)), F.pad(loc_r, (1, 4)), F.pad(vel_r, (1, 4))],
                         dim=2)
        if self.in_features > 3:
            mv = F.pad(mv, (0, 0, 0, self.in_features - 3))
        h = self.MVLinear_0(mv)
        for blk in self.blocks:
            if self.remat and torch.is_grad_enabled():
                h = checkpoint(blk, h, mask, use_reentrant=False)
            else:
                h = blk(h, mask)
        pred = self.MVLinear_1(h)  # [B, N, 2, 8]
        loc_pred, vel_pred = pred[..., 0, 1:4], pred[..., 1, 1:4]
        # the absolute prediction in the eigenbasis, then back, in the JAX
        # model's order of operations
        loc_abs = ((pos @ P) + loc_pred) @ P_inv
        vel_abs = (vel_r + vel_pred) @ P_inv
        pos_dt = loc_abs - pos @ P @ P_inv
        return torch.cat([pos_dt, vel_abs], dim=-1)

    def get_model_size(self) -> int:
        """Width used by the Noam LR schedule."""
        return self.hidden_features
