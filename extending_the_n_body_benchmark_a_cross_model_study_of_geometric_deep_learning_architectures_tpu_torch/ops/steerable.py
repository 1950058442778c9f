"""Steerable (O(3)-equivariant) linear algebra, without e3nn.

Counterpart of the JAX package's ``ops/steerable.py``, the port's own copy
(the port imports nothing of the JAX package):

* :class:`Irreps`: a minimal irreps container ("48x0e+48x1o" strings);
* :func:`spherical_harmonics`: real SH up to lmax=2, e3nn's component order
  (l=1 -> (y, z, x)) and 'integral' normalisation, on unit-normalised input;
* :func:`wigner_D_numpy` / :func:`clebsch_gordan`: solved numerically on the
  host in float64 (D^l from Y(Rv) = D Y(v) on sample points; each CG tensor
  the null space of the equivariance constraint over random rotations).  The
  numpy code is the JAX package's line for line, so on one machine both give
  the same arrays bit for bit; each tensor product makes its constant matrix
  of them once per device and dtype;
* :class:`SteerableTensorProduct`: the fully connected tensor product with
  per-path weights ``w_{a}_{b}_{c}`` of shape ``(mul1, mul2, mul_out)`` and
  biases ``b_{c}`` on scalar outputs, named and shaped as the flax module's;
* :class:`GateActivation`, :class:`SteerableInstanceNorm` and
  :class:`SteerableTPSwishGate`.

Everything acts on flat ``[..., irreps.dim]`` feature axes.  The products are
plain PyTorch: the JAX package computes them in plain einsums, outside any
Pallas kernel.
"""

from __future__ import annotations

import functools
import math
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
from .. import _tf32  # noqa: F401  (TF32 off before torch is used)
import torch
import torch.nn.functional as F
from torch import nn

from ..core.graph import safe_unit

# --------------------------------------------------------------------- irreps


class Irreps:
    """List of ``(mul, (l, parity))`` with e3nn-style string syntax."""

    def __init__(self, spec):
        if isinstance(spec, Irreps):
            self.items = list(spec.items)
        elif isinstance(spec, str):
            self.items = []
            for part in spec.replace(" ", "").split("+"):
                if not part:
                    continue
                m = re.fullmatch(r"(?:(\d+)x)?(\d+)([eo])", part)
                if not m:
                    raise ValueError(f"Bad irrep spec: {part}")
                mul = int(m.group(1) or 1)
                l = int(m.group(2))
                p = 1 if m.group(3) == "e" else -1
                if mul > 0:
                    self.items.append((mul, (l, p)))
        else:
            self.items = [(int(mul), (int(l), int(p))) for mul, (l, p) in spec]

    @staticmethod
    def spherical_harmonics(lmax: int) -> "Irreps":
        return Irreps([(1, (l, (-1) ** l)) for l in range(lmax + 1)])

    @property
    def dim(self) -> int:
        return sum(mul * (2 * l + 1) for mul, (l, _) in self.items)

    @property
    def num_irreps(self) -> int:
        return sum(mul for mul, _ in self.items)

    @property
    def lmax(self) -> int:
        return max(l for _, (l, _) in self.items)

    def slices(self) -> List[slice]:
        out, start = [], 0
        for mul, (l, _) in self.items:
            d = mul * (2 * l + 1)
            out.append(slice(start, start + d))
            start += d
        return out

    def simplify(self) -> "Irreps":
        merged: List[Tuple[int, Tuple[int, int]]] = []
        for mul, ir in self.items:
            if merged and merged[-1][1] == ir:
                merged[-1] = (merged[-1][0] + mul, ir)
            else:
                merged.append((mul, ir))
        return Irreps(merged)

    def sort(self) -> "Irreps":
        return Irreps(sorted(self.items, key=lambda t: (t[1][0], -t[1][1])))

    def __add__(self, other) -> "Irreps":
        return Irreps(self.items + Irreps(other).items)

    def __mul__(self, n: int) -> "Irreps":
        return Irreps([(mul * n, ir) for mul, ir in self.items])

    __rmul__ = __mul__

    def __iter__(self):
        return iter(self.items)

    def __eq__(self, other):
        return isinstance(other, Irreps) and self.items == other.items

    def __hash__(self):
        return hash(tuple(self.items))

    def __repr__(self):
        return "+".join(
            f"{mul}x{l}{'e' if p > 0 else 'o'}" for mul, (l, p) in self.items
        )


# ------------------------------------------------- real spherical harmonics

_SH_NORM = {
    0: 0.5 / math.sqrt(math.pi),  # 1/sqrt(4 pi)
    1: math.sqrt(3.0 / (4.0 * math.pi)),
}


def _sh_l2(x, y, z):
    """l=2 real SH (integral norm) in e3nn order (m = -2..2)."""
    c = math.sqrt(15.0 / math.pi)
    return [
        0.5 * c * x * y,
        0.5 * c * y * z,
        0.25 * math.sqrt(5.0 / math.pi) * (3.0 * z * z - 1.0),
        0.5 * c * z * x,
        0.25 * c * (x * x - y * y),
    ]


def spherical_harmonics(lmax: int, vec: torch.Tensor, normalize: bool = True,
                        eps: float = 1e-8) -> torch.Tensor:
    """Real SH of ``vec [..., 3]`` for all l <= lmax, concatenated (dim
    (lmax+1)^2), in e3nn's order and 'integral' normalisation.  With
    ``normalize`` the input is made unit length first; a zero vector (the
    masked diagonal's) becomes the zero vector, through a double ``where``
    that keeps its gradient finite."""
    if lmax > 2:
        raise NotImplementedError("lmax <= 2 supported (reference uses <= 2)")
    if normalize:
        vec = safe_unit(vec, eps)[0]
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    comps = [torch.full(x.shape, _SH_NORM[0], dtype=vec.dtype, device=vec.device)]
    if lmax >= 1:
        comps += [_SH_NORM[1] * y, _SH_NORM[1] * z, _SH_NORM[1] * x]
    if lmax >= 2:
        comps += _sh_l2(x, y, z)
    return torch.stack(comps, dim=-1)


# ------------------------------------------------------- wigner D / CG (f64)


def _sh_numpy(l: int, v: np.ndarray) -> np.ndarray:
    v = v / np.linalg.norm(v, axis=-1, keepdims=True)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    if l == 0:
        return np.full(x.shape + (1,), _SH_NORM[0])
    if l == 1:
        return np.stack([_SH_NORM[1] * y, _SH_NORM[1] * z, _SH_NORM[1] * x], -1)
    if l == 2:
        return np.stack(_sh_l2(x, y, z), -1)
    raise NotImplementedError


@functools.lru_cache(maxsize=None)
def _sample_points() -> np.ndarray:
    rng = np.random.default_rng(12345)
    v = rng.normal(size=(64, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def wigner_D_numpy(l: int, R: np.ndarray) -> np.ndarray:
    """D^l(R) in the real-SH basis: Y_l(R v) = D^l(R) Y_l(v)."""
    if l == 0:
        return np.ones((1, 1))
    V = _sample_points()
    Y0 = _sh_numpy(l, V)  # [K, 2l+1]
    Y1 = _sh_numpy(l, V @ R.T)
    D_T, *_ = np.linalg.lstsq(Y0, Y1, rcond=None)
    return D_T.T


@functools.lru_cache(maxsize=None)
def clebsch_gordan(l1: int, l2: int, l3: int) -> np.ndarray:
    """CG tensor ``C [2l3+1, 2l1+1, 2l2+1]`` with ||C||_F = 1, real-SH basis.

    Solved as the null space of the equivariance constraint
    ``D3(R) C = C (D1(R) (x) D2(R))`` over random rotations (unique up to
    sign for valid (l1, l2, l3); deterministic sign fix).
    """
    if not abs(l1 - l2) <= l3 <= l1 + l2:
        raise ValueError(f"No CG path {l1}x{l2}->{l3}")
    d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    rng = np.random.default_rng(l1 * 100 + l2 * 10 + l3)
    rows = []
    for _ in range(8):
        A = rng.normal(size=(3, 3))
        Q, r = np.linalg.qr(A)
        R = Q * np.sign(np.diag(r))
        if np.linalg.det(R) < 0:
            R[:, 0] *= -1
        D1, D2, D3 = (wigner_D_numpy(l, R) for l in (l1, l2, l3))
        # Row-major vec: vec(D3 C) = (D3 (x) I) vec(C);
        #                vec(C K12) = (I (x) K12^T) vec(C).
        K12 = np.kron(D1, D2)
        M = np.kron(D3, np.eye(d1 * d2)) - np.kron(np.eye(d3), K12.T)
        rows.append(M)
    M = np.concatenate(rows, axis=0)
    _, s, vh = np.linalg.svd(M)
    null = vh[-1]
    if s[-1] > 1e-8:
        raise RuntimeError(f"No CG null space for {l1}x{l2}->{l3}")
    C = null.reshape(d3, d1, d2)
    C /= np.linalg.norm(C)
    flat = C.reshape(-1)
    nz = flat[np.abs(flat) > 1e-6]
    if nz.size and nz[0] < 0:
        C = -C
    return C


# --------------------------------------------------------- tensor product


def tp_paths(
    irreps_in1: Irreps, irreps_in2: Irreps, irreps_out: Irreps
) -> List[Tuple[int, int, int]]:
    """Valid (i1, i2, iout) index triples (selection rules incl. parity)."""
    paths = []
    for a, (m1, (l1, p1)) in enumerate(irreps_in1):
        for b, (m2, (l2, p2)) in enumerate(irreps_in2):
            for c, (m3, (l3, p3)) in enumerate(irreps_out):
                if abs(l1 - l2) <= l3 <= l1 + l2 and p1 * p2 == p3:
                    paths.append((a, b, c))
    return paths


def tp_weight_numel(irreps_in1: Irreps, irreps_in2: Irreps, irreps_out: Irreps) -> int:
    """Weight count of the fully connected tensor product (e3nn's
    ``FullyConnectedTensorProduct.weight_numel``)."""
    n = 0
    for a, b, c in tp_paths(irreps_in1, irreps_in2, irreps_out):
        n += irreps_in1.items[a][0] * irreps_in2.items[b][0] * irreps_out.items[c][0]
    return n


def weight_balanced_irreps(
    scalar_features: int, irreps_in2: Irreps, lmax: int
) -> Irreps:
    """The reference's ``WeightBalancedIrreps``: the smallest n such that
    TP(n x sh(lmax), in2 -> same) has at least as many weights as
    Linear(scalar_features -> scalar_features)."""
    target = tp_weight_numel(
        Irreps(f"{scalar_features}x0e"), Irreps("1x0e"), Irreps(f"{scalar_features}x0e")
    )
    n = 1
    while True:
        cand = (Irreps.spherical_harmonics(lmax) * n).sort().simplify()
        if tp_weight_numel(cand, irreps_in2, cand) >= target:
            return cand
        n += 1


def _uniform(shape, bound: float) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound))


class SteerableTensorProduct(nn.Module):
    """Fully connected steerable bilinear layer:

    ``out_c = sqrt(2 l3 + 1) * sum_paths w[u,v,w'] C^{l3}_{l1 l2} x1_u x2_v + b_c``

    over the paths ``(a, b, c)`` of :func:`tp_paths`.  The weights are
    ``U(+-1/sqrt(fan_in))`` with ``fan_in`` the sum of ``mul1 * mul2`` over an
    output's paths, as are the biases of scalar outputs.  Parameters are
    float32 and are applied in the input's dtype.  ``irreps_in2=None`` is a
    second input of ones (``1x0e``): a steerable linear layer.

    Each path is contracted in a fixed order: the CG tensor with ``x2``, then
    with ``x1``, then the weights.  Few launches do it, since the eager host
    sets the pace at these sizes: one product of ``x2`` with every scaled CG
    tensor the paths need (a constant ``[dim2, *]`` matrix); for each output
    irrep, one batched product a group of paths that share an ``x2`` item and
    ``l1`` (their ``x1`` items stacked), and one product with the paths'
    weights stacked in the same order.
    """

    def __init__(self, irreps_in1, irreps_out, irreps_in2=None):
        super().__init__()
        self.irreps_in1 = Irreps(irreps_in1)
        self.irreps_in2 = Irreps(irreps_in2) if irreps_in2 is not None else Irreps("1x0e")
        self.irreps_out = Irreps(irreps_out)
        ir1, ir2, ir3 = self.irreps_in1, self.irreps_in2, self.irreps_out
        self.paths = tp_paths(ir1, ir2, ir3)
        if not self.paths:
            raise ValueError(f"No TP paths {ir1} x {ir2} -> {ir3}")
        fan_in: Dict[int, int] = {}
        for a, b, c in self.paths:
            fan_in[c] = fan_in.get(c, 0) + ir1.items[a][0] * ir2.items[b][0]
        for a, b, c in self.paths:
            shape = (ir1.items[a][0], ir2.items[b][0], ir3.items[c][0])
            self.register_parameter(f"w_{a}_{b}_{c}", _uniform(shape, 1.0 / math.sqrt(fan_in[c])))
        for c, (m3, (l3, _)) in enumerate(ir3.items):
            if l3 == 0:
                bound = 1.0 / math.sqrt(fan_in.get(c, 1))
                self.register_parameter(f"b_{c}", _uniform((m3,), bound))
        self._plan()
        self._cg: Dict[Tuple[torch.device, torch.dtype], torch.Tensor] = {}

    def _plan(self) -> None:
        """The contraction plan: the columns of the scaled CG matrix, each
        ``(b, l1, l3)`` block laid out ``(v, k, i)``; the stacks of ``x1``
        items (their slices, mul and ``2 l1 + 1``); and per output, its groups
        ``(CG columns, mul2, d1, stack)`` and the names of their weights in
        stacking order."""
        ir1, ir2, ir3 = self.irreps_in1, self.irreps_in2, self.irreps_out
        s1 = ir1.slices()
        blocks: Dict[Tuple[int, int, int], int] = {}
        stacks: Dict[Tuple[int, Tuple[int, ...]], int] = {}
        self._blocks, self._stacks, self._outputs = [], [], []
        width = 0
        for c, (m3, (l3, _)) in enumerate(ir3.items):
            d3 = 2 * l3 + 1
            members: Dict[Tuple[int, int], List[int]] = {}  # (b, l1) -> a, in path order
            for a, b, cc in self.paths:
                if cc == c:
                    members.setdefault((b, ir1.items[a][1][0]), []).append(a)
            parts, names = [], []
            for (b, l1), group in members.items():
                m2, d1 = ir2.items[b][0], 2 * l1 + 1
                if (b, l1, l3) not in blocks:
                    blocks[(b, l1, l3)] = width
                    self._blocks.append((b, l1, l3, width))
                    width += m2 * d3 * d1
                key = (l1, tuple(group))
                if key not in stacks:
                    stacks[key] = len(self._stacks)
                    self._stacks.append([(s1[a], ir1.items[a][0], d1) for a in group])
                off = blocks[(b, l1, l3)]
                parts.append((slice(off, off + m2 * d3 * d1), m2, d1, stacks[key]))
                names += [f"w_{a}_{b}_{c}" for a in group]
            same_m2 = len({ir2.items[b][0] for b, _ in members}) <= 1
            self._outputs.append((m3, d3, f"b_{c}" if l3 == 0 else None, parts, names, same_m2))
        self._width = width

    def _cg_matrix(self, like: torch.Tensor) -> torch.Tensor:
        """``[dim2, *]``: each block's ``sqrt(2 l3 + 1) C^{l3}_{l1 l2}`` at the
        rows of its ``x2`` item, made once per device and dtype from the float64
        tensors."""
        key = (like.device, like.dtype)
        if key not in self._cg:
            ir2 = self.irreps_in2
            s2 = ir2.slices()
            mat = np.zeros((ir2.dim, self._width))
            for b, l1, l3, off in self._blocks:
                m2, (l2, _) = ir2.items[b]
                d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
                scaled = math.sqrt(d3) * clebsch_gordan(l1, l2, l3)  # [k, i, j]
                for v in range(m2):
                    rows = slice(s2[b].start + v * d2, s2[b].start + (v + 1) * d2)
                    cols = slice(off + v * d3 * d1, off + (v + 1) * d3 * d1)
                    mat[rows, cols] = scaled.transpose(2, 0, 1).reshape(d2, d3 * d1)
            self._cg[key] = torch.as_tensor(mat, dtype=like.dtype, device=like.device)
        return self._cg[key]

    def forward(self, x1: torch.Tensor, x2: Optional[torch.Tensor] = None) -> torch.Tensor:
        lead, dtype = x1.shape[:-1], x1.dtype
        if x2 is None:
            x2 = torch.ones(lead + (1,), dtype=dtype, device=x1.device)
        # rows flattened; C x2 of every block, laid out (v, k, i): [R, width]
        att = (x2 @ self._cg_matrix(x1)).reshape(-1, self._width)
        x1 = x1.reshape(-1, x1.shape[-1])
        stacks = []
        for items in self._stacks:  # [R, M, d1]
            pieces = [x1[:, sl].reshape(-1, m1, d1) for sl, m1, d1 in items]
            stacks.append(torch.cat(pieces, dim=1) if len(pieces) > 1 else pieces[0])
        out = []
        for m3, d3, bias, parts, names, same_m2 in self._outputs:
            if bias is not None:
                bias = getattr(self, bias)
                bias = bias if bias.dtype == dtype else bias.to(dtype)
            if not parts:
                total = x1.new_zeros(lead + (m3 * d3,))
                out.append(total if bias is None else total + bias)
                continue
            zs = []
            for cols, m2, d1, stack in parts:
                xa = stacks[stack]
                cx2 = att[:, cols].reshape(-1, m2 * d3, d1)
                z = torch.bmm(cx2, xa.transpose(1, 2))  # [R, (v, k), u]
                if m2 > 1:
                    z = z.reshape(-1, m2, d3, xa.shape[1]).movedim(1, -1)  # [R, k, u, v]
                zs.append(z.reshape(-1, d3, xa.shape[1] * m2))
            z = torch.cat(zs, dim=-1) if len(zs) > 1 else zs[0]  # [R, d3, K]
            z = z.reshape(-1, z.shape[-1])
            ws = [getattr(self, n) for n in names]  # [m1, m2, m3] each
            if len(ws) == 1:
                w = ws[0].reshape(-1, m3)
            elif same_m2:
                w = torch.cat(ws).reshape(-1, m3)
            else:
                w = torch.cat([t.reshape(-1, m3) for t in ws])
            w = w if w.dtype == dtype else w.to(dtype)  # [K, m3]
            if bias is not None:
                out.append(torch.addmm(bias, z, w).reshape(lead + (m3,)))
            else:
                out.append((z @ w).reshape(-1, d3, m3).transpose(1, 2).reshape(lead + (m3 * d3,)))
        return torch.cat(out, dim=-1) if len(out) > 1 else out[0]


def gate_irreps(irreps_out: Irreps) -> Irreps:
    """Pre-gate irreps of ``O3TensorProductSwishGate``: the scalars, one 0e
    gate per non-scalar irrep, then the gated irreps."""
    items = list(Irreps(irreps_out).items)
    scalars = Irreps([items[0]])
    gated = Irreps(items[1:])
    n_gates = gated.num_irreps
    if n_gates == 0:
        return Irreps(items)
    return (scalars + Irreps(f"{n_gates}x0e") + gated).simplify()


class GateActivation(nn.Module):
    """e3nn's ``Gate``: SiLU on the leading scalars, sigmoid(gate) times each
    gated irrep.  ``irreps_out`` are the post-gate irreps, whose scalar count
    splits the (simplified) pre-gate scalars from the gates."""

    def __init__(self, irreps_out):
        super().__init__()
        self.irreps_out = Irreps(irreps_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        items = list(self.irreps_out.items)
        n_scalars = items[0][0]
        gated = Irreps(items[1:])
        n_gates = gated.num_irreps
        if n_gates == 0:
            return F.silu(x)
        lead = x.shape[:-1]
        scalars = F.silu(x[..., :n_scalars])
        gates = torch.sigmoid(x[..., n_scalars: n_scalars + n_gates])
        rest = x[..., n_scalars + n_gates:]
        pieces, g_idx, start = [scalars], 0, 0
        for mul, (l, _) in gated:
            d = mul * (2 * l + 1)
            seg = rest[..., start: start + d].reshape(lead + (mul, 2 * l + 1))
            g = gates[..., g_idx: g_idx + mul]
            pieces.append((seg * g[..., :, None]).reshape(lead + (d,)))
            start += d
            g_idx += mul
        return torch.cat(pieces, dim=-1)


class SteerableInstanceNorm(nn.Module):
    """Per-graph instance norm over irreps, dense: input ``[B, N,
    irreps.dim]``, each batch element one simulation graph.

    Scalars are mean-centred per graph; every irrep channel is divided by the
    square root of its graph-mean component norm (population means, ``eps``
    inside the root); learnable per-channel ``weight`` and per-scalar
    ``bias`` ('component' normalisation, 'mean' reduce)."""

    def __init__(self, irreps, eps: float = 1e-5, affine: bool = True):
        super().__init__()
        self.irreps = Irreps(irreps)
        self.eps = eps
        self.affine = affine
        if affine:
            num_scalar = sum(mul for mul, (l, _) in self.irreps if l == 0)
            self.weight = nn.Parameter(torch.ones(self.irreps.num_irreps))
            self.bias = nn.Parameter(torch.zeros(num_scalar))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pieces, iw, ib = [], 0, 0
        for sl, (mul, (l, _)) in zip(self.irreps.slices(), self.irreps):
            d = 2 * l + 1
            field = x[..., sl].reshape(x.shape[:-1] + (mul, d))
            if l == 0:
                field = field - torch.mean(field, dim=1, keepdim=True)
            norm = torch.mean(field * field, dim=-1)  # component normalisation
            norm = torch.mean(norm, dim=1, keepdim=True)  # per-graph reduce
            scale = (norm + self.eps) ** -0.5  # [B, 1, mul]
            if self.affine:
                scale = scale * self.weight[iw: iw + mul].to(x.dtype)
                iw += mul
            field = field * scale[..., None]
            if self.affine and l == 0:
                field = field + self.bias[ib: ib + mul].to(x.dtype)[:, None]
                ib += mul
            pieces.append(field.reshape(x.shape[:-1] + (mul * d,)))
        return torch.cat(pieces, dim=-1)


class SteerableTPSwishGate(nn.Module):
    """``O3TensorProductSwishGate``: a tensor product into the gate irreps,
    then the gate.  flax names the product ``SteerableTensorProduct_0``."""

    def __init__(self, irreps_in1, irreps_out, irreps_in2=None):
        super().__init__()
        self.tp = SteerableTensorProduct(irreps_in1, gate_irreps(irreps_out), irreps_in2)
        self.gate = GateActivation(irreps_out)

    def forward(self, x1: torch.Tensor, x2: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.gate(self.tp(x1, x2))
