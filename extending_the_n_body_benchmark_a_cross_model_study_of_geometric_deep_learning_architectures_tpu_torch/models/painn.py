"""PaiNN (polarizable atom interaction network), dense.

Counterpart of the JAX package's ``models/painn.py``.  State per body:
scalar features ``q [B, N, H]`` and vector features ``mu [B, N, 3, H]``.
Messages flow sender ``j`` -> receiver ``i`` along the edge vector
``pos_j - pos_i``, through Gaussian-RBF filters under a cosine cutoff, and
are aggregated by the masked, degree-normalised mean over senders.  The
stability toggles of the reference (tanh-squashed messages and mixing,
clipped aggregates, clipped ``q`` and ``|mu|``, residual scales, a filter
gain) are constructor arguments, off by default.  Plain PyTorch; no dropout.

Submodules and parameters carry the flax names (``MLP_0`` the ``q``
embedding, ``MLP_1`` the velocity scale, ``_Interaction_0`` / ``_Mixing_0``
in each block, ``EquivariantLinear_k`` with its ``[in, out]`` ``weight``,
``_Readout_0`` / ``_Readout_1``); the blocks, scanned over a stacked
parameter axis (``Scan_PaiNNBlock_0``) in the JAX model, are a
``ModuleList`` here, and ``remat`` recomputes each one in the backward pass
(``torch.utils.checkpoint``, non-reentrant) with the same parameters.
"""

from __future__ import annotations

from typing import Optional

from .. import _tf32  # noqa: F401  (TF32 off before torch is used)
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core import graph as G
from ..core.scene import Scene
from .common import MLP, cast_like, xavier_uniform_gain


def _tanh_scale(x: torch.Tensor, s: Optional[float]) -> torch.Tensor:
    return x if s is None else torch.tanh(x / s) * s


def _clip_norm(v: torch.Tensor, c: float) -> torch.Tensor:
    """``v [..., 3, H]`` with each channel's 3-vector scaled to length at
    most ``c``: ``min(c / (|v| + 1e-12), 1)``, ``|v|`` with 1e-12 under the
    square root."""
    norm = torch.sqrt(torch.sum(v * v, dim=-2) + 1e-12)
    return v * torch.clamp(c / (norm + 1e-12), max=1.0)[..., None, :]


class EquivariantLinear(nn.Module):
    """Channel mixing of ``[..., 3, F]`` vectors by an ``[F, out]`` weight, no
    bias (a bias would break equivariance)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, features))
        xavier_uniform_gain(1.0)(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ cast_like(self.weight, x)


class _Interaction(nn.Module):
    """The message block: filters from the RBF, source features at the
    sender, the masked mean over senders, the residual."""

    def __init__(self, hidden: int, num_rbf: int, residual_scale: float = 1.0,
                 tanh_message_scale: Optional[float] = None,
                 clip_scalar_msg_value: Optional[float] = None,
                 clip_vector_msg_norm: Optional[float] = None, filter_gain: float = 1.0):
        super().__init__()
        self.hidden, self.residual_scale = hidden, residual_scale
        self.tanh_message_scale, self.filter_gain = tanh_message_scale, filter_gain
        self.clip_scalar_msg_value = clip_scalar_msg_value
        self.clip_vector_msg_norm = clip_vector_msg_norm
        self.MLP_0 = MLP(num_rbf, [hidden], 3 * hidden)  # filters
        self.MLP_1 = MLP(hidden, [3 * hidden], 3 * hidden)  # source features

    def forward(self, q, mu, rbf, unit, cut, mask):
        H = self.hidden
        filters = self.MLP_0(rbf) * cut[..., None]
        if self.filter_gain != 1.0:
            filters = filters * self.filter_gain
        f_q, f_r, f_mu = torch.split(filters, H, dim=-1)  # [B, N, N, H] each
        x_q, x_r, x_mu = torch.split(self.MLP_1(q), H, dim=-1)  # [B, N, H] each

        # sender j's features at [:, i, j]
        s = self.tanh_message_scale
        x_q_src = _tanh_scale(x_q[:, None] * f_q, s)
        x_r_src = _tanh_scale(x_r[:, None] * f_r, s)
        x_mu_src = _tanh_scale(x_mu[:, None] * f_mu, s)

        scalar_msg = G.masked_segment_mean(x_q_src, mask)
        vec_new = unit[..., None] * x_r_src[..., None, :]  # [B, N, N, 3, H]
        vec_prop = mu[:, None] * x_mu_src[..., None, :]
        vector_msg = G.masked_segment_mean(vec_new + vec_prop, mask)

        if self.clip_scalar_msg_value is not None:
            c = self.clip_scalar_msg_value
            scalar_msg = torch.clamp(scalar_msg, -c, c)
        if self.clip_vector_msg_norm is not None:
            vector_msg = _clip_norm(vector_msg, self.clip_vector_msg_norm)
        return q + self.residual_scale * scalar_msg, mu + self.residual_scale * vector_msg


class _Mixing(nn.Module):
    """The equivariant update: ``mu`` split by one linear into ``mu_v`` and
    ``mu_w``, an MLP on ``[q, |mu_v|]`` gating the residuals."""

    def __init__(self, hidden: int, residual_scale: float = 1.0,
                 tanh_mixing_scale: Optional[float] = None, clip_mu_norm: Optional[float] = None,
                 clip_q_value: Optional[float] = None):
        super().__init__()
        self.hidden, self.residual_scale = hidden, residual_scale
        self.tanh_mixing_scale = tanh_mixing_scale
        self.clip_mu_norm, self.clip_q_value = clip_mu_norm, clip_q_value
        self.EquivariantLinear_0 = EquivariantLinear(hidden, 2 * hidden)
        self.MLP_0 = MLP(2 * hidden, [3 * hidden], 3 * hidden)

    def forward(self, q, mu):
        H = self.hidden
        mu_v, mu_w = torch.split(self.EquivariantLinear_0(mu), H, dim=-1)  # [B, N, 3, H]
        mu_v_norm = torch.sqrt(torch.sum(mu_v * mu_v, dim=-2) + 1e-8)  # [B, N, H]
        delta = self.MLP_0(torch.cat([q, mu_v_norm], dim=-1))
        dq, dmu_scale, dqmu = (_tanh_scale(d, self.tanh_mixing_scale)
                               for d in torch.split(delta, H, dim=-1))

        inner = torch.sum(mu_v * mu_w, dim=-2)  # [B, N, H]
        q = q + self.residual_scale * (dq + dqmu * inner)
        mu = mu + self.residual_scale * (mu_w * dmu_scale[..., None, :])
        if self.clip_q_value is not None:
            q = torch.clamp(q, -self.clip_q_value, self.clip_q_value)
        if self.clip_mu_norm is not None:
            mu = _clip_norm(mu, self.clip_mu_norm)
        return q, mu


class _Readout(nn.Module):
    """Gated vector readout: ``[B, N, 3, vector_outputs]``."""

    def __init__(self, hidden: int, vector_outputs: int = 1):
        super().__init__()
        self.MLP_0 = MLP(hidden, [hidden], hidden)
        self.EquivariantLinear_0 = EquivariantLinear(hidden, hidden)
        self.EquivariantLinear_1 = EquivariantLinear(hidden, vector_outputs)

    def forward(self, q, mu):
        gate = self.MLP_0(q)
        return self.EquivariantLinear_1(self.EquivariantLinear_0(mu * gate[:, :, None, :]))


class _PaiNNBlock(nn.Module):
    """An interaction and a mixing block."""

    def __init__(self, hidden: int, num_rbf: int, residual_scale_interaction: float = 1.0,
                 residual_scale_mixing: float = 1.0,
                 tanh_message_scale: Optional[float] = None,
                 tanh_mixing_scale: Optional[float] = None,
                 clip_scalar_msg_value: Optional[float] = None,
                 clip_vector_msg_norm: Optional[float] = None,
                 clip_q_value: Optional[float] = None, clip_mu_norm: Optional[float] = None,
                 filter_gain: float = 1.0):
        super().__init__()
        self._Interaction_0 = _Interaction(hidden, num_rbf, residual_scale_interaction,
                                           tanh_message_scale, clip_scalar_msg_value,
                                           clip_vector_msg_norm, filter_gain)
        self._Mixing_0 = _Mixing(hidden, residual_scale_mixing, tanh_mixing_scale,
                                 clip_mu_norm, clip_q_value)

    def forward(self, q, mu, rbf, unit, cut, mask):
        q, mu = self._Interaction_0(q, mu, rbf, unit, cut, mask)
        return self._Mixing_0(q, mu)


class PaiNN(nn.Module):
    """``forward(scene, mask, train=False) -> [B, N, 6]``: the position delta
    and the velocity, the velocity head residual on the input velocity.
    ``train`` is taken for the JAX signature's sake (no dropout)."""

    def __init__(
        self,
        hidden_features: int = 192,
        num_layers: int = 6,
        num_rbf: int = 64,
        cutoff: float = 10.0,
        use_velocity_input: bool = True,
        include_velocity_norm: bool = True,
        residual_scale_interaction: float = 1.0,
        residual_scale_mixing: float = 1.0,
        tanh_message_scale: Optional[float] = None,
        tanh_mixing_scale: Optional[float] = None,
        clip_scalar_msg_value: Optional[float] = None,
        clip_vector_msg_norm: Optional[float] = None,
        clip_q_value: Optional[float] = None,
        clip_mu_norm: Optional[float] = None,
        filter_gain: float = 1.0,
        remat: bool = False,
    ):
        super().__init__()
        H = hidden_features
        self.hidden_features, self.num_rbf, self.cutoff = H, num_rbf, cutoff
        self.use_velocity_input = use_velocity_input
        self.include_velocity_norm = include_velocity_norm
        self.remat = remat
        scalar_in = 2 if include_velocity_norm else 1
        self.MLP_0 = MLP(scalar_in, [H], H)
        if use_velocity_input:
            self.MLP_1 = MLP(scalar_in, [H], H)
        self.blocks = nn.ModuleList(
            _PaiNNBlock(H, num_rbf, residual_scale_interaction, residual_scale_mixing,
                        tanh_message_scale, tanh_mixing_scale, clip_scalar_msg_value,
                        clip_vector_msg_norm, clip_q_value, clip_mu_norm, filter_gain)
            for _ in range(num_layers))
        self._Readout_0 = _Readout(H)  # the position delta
        self._Readout_1 = _Readout(H)  # the velocity delta

    def forward(self, scene: Scene, mask: torch.Tensor, train: bool = False) -> torch.Tensor:
        H = self.hidden_features
        feats = [scene.mass]
        if self.include_velocity_norm:
            feats.append(torch.linalg.vector_norm(scene.vel, dim=-1, keepdim=True))
        scalar_in = torch.cat(feats, dim=-1)
        q = self.MLP_0(scalar_in)
        if self.use_velocity_input:
            mu = scene.vel[..., None] * self.MLP_1(scalar_in)[:, :, None, :]  # [B, N, 3, H]
        else:
            mu = scene.pos.new_zeros(scene.pos.shape[:2] + (3, H))

        edge_vec = -G.rel_positions(scene.pos)  # pos_j - pos_i at [i, j]
        unit, dist = G.safe_unit(edge_vec)
        rbf = G.gaussian_rbf(dist, self.num_rbf, self.cutoff)
        cut = G.cosine_cutoff(dist, self.cutoff)
        for blk in self.blocks:
            if self.remat and torch.is_grad_enabled():
                q, mu = checkpoint(blk, q, mu, rbf, unit, cut, mask, use_reentrant=False)
            else:
                q, mu = blk(q, mu, rbf, unit, cut, mask)

        pos_delta = self._Readout_0(q, mu)[..., 0]  # [B, N, 3]
        vel_delta = self._Readout_1(q, mu)[..., 0]
        return torch.cat([pos_delta, scene.vel + vel_delta], dim=-1)

    def get_model_size(self) -> int:
        """Width used by the Noam LR schedule."""
        return self.hidden_features
