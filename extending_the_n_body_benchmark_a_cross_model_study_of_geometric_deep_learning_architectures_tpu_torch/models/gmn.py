"""GMN: graph mechanics network with rigid-object constraint updates, dense.

Counterpart of the JAX package's ``models/gmn.py``.  Per layer: EGNN-style
invariant edge messages and a clipped equivariant "force" (the masked mean
over senders of ``w * (x_i - x_j)``); per-object updates of the generalised
coordinates (isolated bodies: a gated velocity plus the force; sticks: the
centre of mass and a Rodrigues rotation of the half-separation; hinges: a
pivot and two constrained beams); the scalar update from the masked sum of
the edge features.  Objects lie in contiguous node blocks ``[isolated |
stick pairs | hinge triples]``; the composition ``(n_isolated, n_stick,
n_hinge)`` is fixed at construction.  Inputs ``h = [|v|, charge]`` (the mass
where the scene has no charge), edge attribute ``q_i q_j``; output ``[B, N,
6]`` = (x_final - x_0, v_final).

Submodules carry the flax names, which follow the order in which the JAX
layer makes its modules, not the order in which it calls them: the edge MLP
``MLP_0``, ``TorchLinear_0`` and the bias-free ``Dense_0`` of the force
weight, the gates ``MLP_1`` (velocity, shared by every kind of object),
``MLP_2`` (angular velocity), ``MLP_3`` (centre, called twice), ``MLP_4``
(stick force) and ``MLP_5`` (hinge force), then the node MLP ``MLP_6``.  Only
the modules the composition calls have parameters, in both packages, so only
those are built.  ``coords_range`` is declared under ``tanh=True`` and never
applied, as in the reference.  The layers, scanned in the JAX model
(``Scan_GMNLayer_0``), are a ``ModuleList`` here, and ``remat`` recomputes
each one in the backward pass (``torch.utils.checkpoint``, non-reentrant).
Every ``.at[].set`` of the JAX model is built out of place.  Plain PyTorch;
no dropout.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core import graph as G
from ..core.scene import Scene
from .common import MLP, TorchLinear, xavier_uniform_gain


def _rodrigues_batched(theta: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``[..., 3, 3]`` rotation by ``theta`` about the unit axis ``d``."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    c, s = torch.cos(theta), torch.sin(theta)
    C = 1 - c
    rows = [
        c + C * x * x, C * x * y - s * z, C * x * z + s * y,
        C * x * y + s * z, c + C * y * y, C * y * z - s * x,
        C * x * z - s * y, C * y * z + s * x, c + C * z * z,
    ]
    return torch.stack(rows, dim=-1).reshape(theta.shape + (3, 3))


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + eps)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def _rotate(rot: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``einsum("...ij,...j->...i", rot, r)``."""
    return torch.einsum("...ij,...j->...i", rot, r)


def _sqnorm(v: torch.Tensor) -> torch.Tensor:
    return torch.sum(v * v, dim=-1, keepdim=True)


class _GMNLayer(nn.Module):
    """One GMN layer on the carry ``(h, x, v)``."""

    def __init__(self, hidden: int, edge_attr_dim: int = 1, coords_weight: float = 1.0,
                 recurrent: bool = False, norm_diff: bool = False, tanh: bool = False,
                 n_isolated: int = 5, n_stick: int = 0, n_hinge: int = 0):
        super().__init__()
        H = hidden
        self.hidden, self.coords_weight, self.recurrent = H, coords_weight, recurrent
        self.norm_diff, self.tanh = norm_diff, tanh
        self.n_isolated, self.n_stick, self.n_hinge = n_isolated, n_stick, n_hinge
        self.MLP_0 = MLP(2 * H + 1 + edge_attr_dim, [H], H)  # silu after it too
        self.TorchLinear_0 = TorchLinear(H, H)
        self.Dense_0 = TorchLinear(H, 1, bias=False)
        xavier_uniform_gain(0.001)(self.Dense_0.weight)
        if tanh:
            self.coords_range = nn.Parameter(torch.full((1,), 3.0))
        if n_isolated or n_stick or n_hinge:
            self.MLP_1 = MLP(H, [H], 1)  # the velocity gate
        if n_stick or n_hinge:
            self.MLP_2 = MLP(H, [H], 1)  # the angular-velocity gate
            self.MLP_3 = MLP(H, [H], H)  # the centre
        if n_stick:
            self.MLP_4 = MLP(1, [H], 1)  # the stick's basis force
        if n_hinge:
            self.MLP_5 = MLP(9, [H], 3)  # the hinge's basis force
        self.MLP_6 = MLP(3 * H, [H], H)  # the node model

    def _stick(self, x, v, f, h):
        B, st = x.shape[0], self.n_stick
        xs, vs = x.reshape(B, st, 2, 3), v.reshape(B, st, 2, 3)
        fs, hs = f.reshape(B, st, 2, 3), h.reshape(B, st, 2, self.hidden)
        x0, v0 = xs.mean(dim=2), vs.mean(dim=2)
        # the learned basis force per node, on the basis (f,)
        msg = self.MLP_4(_normalize(_sqnorm(fs)))  # [B, S, 2, 1]
        a0 = torch.mean(msg * fs, dim=2)
        r = (xs[:, :, 0] - xs[:, :, 1]) / 2.0
        rel_v = (vs[:, :, 0] - vs[:, :, 1]) / 2.0
        r_norm = torch.sqrt(_sqnorm(r))
        w_vec = _cross(_normalize(r), rel_v) / torch.clamp(r_norm, min=1e-5)
        J = _sqnorm(xs[:, :, 0] - x0) + _sqnorm(xs[:, :, 1] - x0)
        beta = (_cross(xs[:, :, 0] - x0, fs[:, :, 0]) + _cross(xs[:, :, 1] - x0, fs[:, :, 1])) / J
        h_c = self.MLP_3(hs[:, :, 0]) + self.MLP_3(hs[:, :, 1])
        w_vec = self.MLP_2(h_c) * w_vec + beta
        v0 = self.MLP_1(h_c) * v0 + a0
        x0 = x0 + v0
        theta = torch.sqrt(torch.sum(w_vec * w_vec, dim=-1) + 1e-30)
        r = _rotate(_rodrigues_batched(theta, _normalize(w_vec)), r)
        x_new = torch.stack([x0 + r, x0 - r], dim=2).reshape(B, 2 * st, 3)
        v_new = torch.stack([v0 + _cross(w_vec, r), v0 + _cross(w_vec, -r)], dim=2)
        return x_new, v_new.reshape(B, 2 * st, 3)

    def _hinge(self, x, v, f, h):
        B, hi = x.shape[0], self.n_hinge
        xh, vh = x.reshape(B, hi, 3, 3), v.reshape(B, hi, 3, 3)
        fh, hh = f.reshape(B, hi, 3, 3), h.reshape(B, hi, 3, self.hidden)
        x0, v0 = xh[:, :, 0], vh[:, :, 0]
        # the basis (f, x - x0, v - v0) with learned mixing
        basis = torch.stack([fh, xh - x0[:, :, None], vh - v0[:, :, None]], dim=-1)
        gram = torch.einsum("bhnda,bhndc->bhnac", basis, basis).reshape(B, hi, 3, 9)
        msg = self.MLP_5(_normalize(gram))  # [B, hi, 3, 3]
        a0 = torch.mean(torch.einsum("bhnda,bhna->bhnd", basis, msg), dim=2)

        def apply_g(cx, cf):
            return _cross(cx - x0, cf - a0) / _sqnorm(cx - x0)

        beta1, beta2 = apply_g(xh[:, :, 1], fh[:, :, 1]), apply_g(xh[:, :, 2], fh[:, :, 2])

        def c_metrics(cx, cv):
            r = cx - x0
            rn = torch.sqrt(_sqnorm(r))
            return r, _cross(_normalize(r), cv - v0) / torch.clamp(rn, min=1e-5)

        r1, w1 = c_metrics(xh[:, :, 1], vh[:, :, 1])
        r2, w2 = c_metrics(xh[:, :, 2], vh[:, :, 2])
        h_c = self.MLP_3(hh[:, :, 1]) + self.MLP_3(hh[:, :, 2])
        v0 = self.MLP_1(h_c) * v0 + a0
        x0 = x0 + v0

        def upd(wv, bv, rv, hv):
            wv = self.MLP_2(hv) * wv + bv
            th = torch.sqrt(torch.sum(wv * wv, dim=-1) + 1e-30)
            return _rotate(_rodrigues_batched(th, _normalize(wv)), rv), wv

        r1, w1 = upd(w1, beta1, r1, hh[:, :, 1])
        r2, w2 = upd(w2, beta2, r2, hh[:, :, 2])
        x_new = torch.stack([x0, x0 + r1, x0 + r2], dim=2).reshape(B, 3 * hi, 3)
        v_new = torch.stack([v0, v0 + _cross(w1, r1), v0 + _cross(w2, r2)], dim=2)
        return x_new, v_new.reshape(B, 3 * hi, 3)

    def forward(self, h, x, v, edge_attr, mask):
        B, N = x.shape[:2]
        H = self.hidden
        # invariant messages and the equivariant force
        coord_diff = G.rel_positions(x)
        radial = torch.sum(coord_diff * coord_diff, dim=-1, keepdim=True)
        if self.norm_diff:
            coord_diff = coord_diff / (G.safe_sqrt(radial) + 1.0)
        h_i = h[:, :, None, :].expand(B, N, N, H)
        h_j = h[:, None, :, :].expand(B, N, N, H)
        edge_feat = F.silu(self.MLP_0(torch.cat([h_i, h_j, radial, edge_attr], dim=-1)))
        w = self.Dense_0(F.silu(self.TorchLinear_0(edge_feat)))
        if self.tanh:
            w = torch.tanh(w)
        trans = torch.clamp(w * coord_diff, -100.0, 100.0)
        f = G.masked_segment_mean(trans, mask) * self.coords_weight  # [B, N, 3]

        # each object block from the layer's input state; untouched nodes kept
        iso, st, hi = self.n_isolated, self.n_stick, self.n_hinge
        xs: List[torch.Tensor] = []
        vs: List[torch.Tensor] = []
        if iso:
            v_new = self.MLP_1(h[:, :iso]) * v[:, :iso] + f[:, :iso]
            xs.append(x[:, :iso] + v_new)
            vs.append(v_new)
        if st:
            sl = slice(iso, iso + 2 * st)
            x_s, v_s = self._stick(x[:, sl], v[:, sl], f[:, sl], h[:, sl])
            xs.append(x_s)
            vs.append(v_s)
        rest = iso + 2 * st
        if hi:
            x_h, v_h = self._hinge(x[:, rest:], v[:, rest:], f[:, rest:], h[:, rest:])
            xs.append(x_h)
            vs.append(v_h)
        elif rest < N:
            xs.append(x[:, rest:])
            vs.append(v[:, rest:])
        if xs:
            x = xs[0] if len(xs) == 1 else torch.cat(xs, dim=1)
            v = vs[0] if len(vs) == 1 else torch.cat(vs, dim=1)

        # the node update (others = h)
        agg = G.masked_segment_sum(edge_feat, mask)
        out = self.MLP_6(torch.cat([h, h, agg], dim=-1))
        return (h + out if self.recurrent else out), x, v


class GMN(nn.Module):
    """``forward(scene, mask, train=False) -> [B, N, 6]``.  ``train`` is taken
    for the JAX signature's sake (no dropout)."""

    def __init__(self, hidden_features: int = 64, num_layers: int = 4, coords_weight: float = 1.0,
                 recurrent: bool = False, norm_diff: bool = False, tanh: bool = False,
                 n_isolated: int = 5, n_stick: int = 0, n_hinge: int = 0, remat: bool = False):
        super().__init__()
        self.init_kwargs = {k: v for k, v in locals().items() if k not in ("self", "__class__")}
        self.hidden_features, self.remat = hidden_features, remat
        self.TorchLinear_0 = TorchLinear(2, hidden_features)
        self.blocks = nn.ModuleList(
            _GMNLayer(hidden_features, 1, coords_weight, recurrent, norm_diff, tanh,
                      n_isolated, n_stick, n_hinge) for _ in range(num_layers))

    def forward(self, scene: Scene, mask: torch.Tensor, train: bool = False) -> torch.Tensor:
        charge = scene.charge if scene.charge is not None else scene.mass
        speed = torch.sqrt(torch.sum(scene.vel * scene.vel, dim=-1, keepdim=True))
        h = self.TorchLinear_0(torch.cat([speed, charge], dim=-1))
        qq = charge[:, :, None, :] * charge[:, None, :, :]  # the edge attribute q_i q_j
        x, v = scene.pos, scene.vel
        for blk in self.blocks:
            if self.remat and torch.is_grad_enabled():
                h, x, v = checkpoint(blk, h, x, v, qq, mask, use_reentrant=False)
            else:
                h, x, v = blk(h, x, v, qq, mask)
        return torch.cat([x - scene.pos, v], dim=-1)

    def get_model_size(self) -> int:
        """Width used by the Noam LR schedule."""
        return self.hidden_features
