"""SEGNN and SEConv: steerable E(3)-equivariant message passing, dense.

Counterpart of the JAX package's ``models/segnn.py``, on the port's steerable
stack (:mod:`..ops.steerable`).  All of it is plain PyTorch, as the JAX model
is plain einsums (no Pallas kernel).

* hidden irreps from ``weight_balanced_irreps`` (``224x0e+224x1o`` for 448
  features at lmax 1);
* each SEGNN layer: two gated tensor-product message layers steered by the
  edge SH, a masked *sum* over senders, two update layers steered by the node
  attribute, the residual, and the optional instance norm;
* featurisation: edge attribute SH(rel), node attribute the masked *mean* of
  the incident edges' SH plus SH(vel) (plus SH(force) with
  ``use_force_input``) with its trivial component set to 1, node features
  ``[pos - centre, vel, |vel|]`` (2x1o + 1x0e), message extras
  ``[dist, m_r * m_s]`` (2x0e).

Conventions kept from the JAX model:

* receiver ``r``, sender ``s``: ``adj[b, r, s] = mask[b, s, r]`` and ``rel =
  pos_s - pos_r`` (PONITA's direction, the transpose of EGNN-MC's); the
  message input is receiver first, ``[x_r, x_s, extras]``;
* physical 3-vectors are packed into 1o slots in the SH basis (y, z, x) and
  unpacked on output, so every 1o quantity lives in one basis;
* ``center_mode="coords"`` (the default) subtracts the mean over the
  *coordinate* axis, the reference's quirk, which breaks exact
  equivariance; ``"nodes"`` subtracts the centre of mass;
* the JAX model scans one layer body over a stacked parameter axis; here the
  layers are a ``ModuleList``, and ``remat`` checkpoints each layer
  (``torch.utils.checkpoint``, non-reentrant) with the same math.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core import graph as G
from ..core.scene import Scene
from ..ops.steerable import (
    GateActivation,
    Irreps,
    SteerableInstanceNorm,
    SteerableTensorProduct,
    SteerableTPSwishGate,
    gate_irreps,
    spherical_harmonics,
    weight_balanced_irreps,
)

_TO_YZX = (1, 2, 0)
_TO_XYZ = (2, 0, 1)

INPUT_IRREPS = Irreps("1x1o+1x1o+1x0e")
OUTPUT_IRREPS = Irreps("1x1o+1x1o")
ADDITIONAL_IRREPS = Irreps("2x0e")


def vec_to_1o(v: torch.Tensor) -> torch.Tensor:
    """Pack a physical (x, y, z) vector into the 1o basis (y, z, x)."""
    return v[..., _TO_YZX]


def irrep1o_to_vec(u: torch.Tensor) -> torch.Tensor:
    return u[..., _TO_XYZ]


def _pairs(x: torch.Tensor, additional: torch.Tensor) -> torch.Tensor:
    """The message input ``[x_r, x_s, additional]`` of every (receiver,
    sender) pair: ``[B, N, N, 2 D + A]``."""
    n = x.shape[1]
    shape = x.shape[:1] + (n, n, x.shape[-1])
    return torch.cat([x[:, :, None, :].expand(shape), x[:, None, :, :].expand(shape),
                      additional], dim=-1)


def featurize(scene: Scene, mask: torch.Tensor, lmax_attr: int, center_mode: str = "coords",
              use_force_input: bool = False):
    """``(x, edge_sh, node_attr, additional, adj)``: the dense ``O3Transform``
    of a scene; ``edge_sh`` and ``additional`` are ``[B, N, N, *]`` indexed
    (receiver, sender), ``adj [B, N, N]`` bool."""
    pos, vel, mass = scene.pos, scene.vel, scene.mass
    adj = mask.transpose(1, 2)
    rel = -G.rel_positions(pos)  # [b, r, s] = pos_s - pos_r
    edge_sh = spherical_harmonics(lmax_attr, rel)
    dist = G.safe_sqrt(torch.sum(rel * rel, dim=-1, keepdim=True))
    prod_mass = mass[:, :, None, :] * mass[:, None, :, :]
    additional = torch.cat([dist, prod_mass], dim=-1)

    node_attr = G.masked_segment_mean(edge_sh, adj) + spherical_harmonics(lmax_attr, vel)
    if use_force_input:
        node_attr = node_attr + spherical_harmonics(lmax_attr, scene.force)
    # the trivial irrep of the attributes stays 1
    node_attr = torch.cat([torch.ones_like(node_attr[..., :1]), node_attr[..., 1:]], dim=-1)

    if center_mode == "coords":
        centered = pos - torch.mean(pos, dim=-1, keepdim=True)
    else:
        centered = pos - torch.mean(pos, dim=1, keepdim=True)
    vel_abs = G.safe_sqrt(torch.sum(vel * vel, dim=-1, keepdim=True))
    x = torch.cat([vec_to_1o(centered), vec_to_1o(vel), vel_abs], dim=-1)
    return x, edge_sh, node_attr, additional, adj


def _readout(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([irrep1o_to_vec(x[..., 0:3]), irrep1o_to_vec(x[..., 3:6])], dim=-1)


class SEGNNLayer(nn.Module):
    """One message-passing layer, dense.  flax names its modules
    ``SteerableTPSwishGate_0..2`` (message1, message2, update1),
    ``SteerableTensorProduct_0`` (update2) and ``SteerableInstanceNorm_0``."""

    def __init__(self, hidden_irreps: Irreps, attr_irreps: Irreps, norm: Optional[str] = None):
        super().__init__()
        if norm not in (None, "none", "instance"):
            raise NotImplementedError(f"norm '{norm}' not supported")
        message_in = hidden_irreps + hidden_irreps + ADDITIONAL_IRREPS
        self.message1 = SteerableTPSwishGate(message_in, hidden_irreps, attr_irreps)
        self.message2 = SteerableTPSwishGate(hidden_irreps, hidden_irreps, attr_irreps)
        self.update1 = SteerableTPSwishGate(hidden_irreps + hidden_irreps, hidden_irreps,
                                            attr_irreps)
        self.update2 = SteerableTensorProduct(hidden_irreps, hidden_irreps, attr_irreps)
        self.norm = SteerableInstanceNorm(hidden_irreps) if norm == "instance" else None

    def forward(self, x, edge_sh, node_attr, additional, adj):
        m = self.message1(_pairs(x, additional), edge_sh)
        m = self.message2(m, edge_sh)
        msg = G.masked_segment_sum(m, adj)
        u = self.update1(torch.cat([x, msg], dim=-1), node_attr)
        x = x + self.update2(u, node_attr)
        return x if self.norm is None else self.norm(x)


class SEGNN(nn.Module):
    """``forward(scene, mask, train=False) -> [B, N, 6]`` (pos_dt | vel, the
    output irreps 2x1o).  ``train`` is taken for the JAX signature's sake:
    SEGNN has no dropout."""

    def __init__(
        self,
        hidden_features: int = 96,
        lmax_attr: int = 1,
        lmax_h: int = 1,
        num_layers: int = 20,
        normalization_type: Optional[str] = None,
        center_mode: str = "coords",
        use_force_input: bool = False,
        remat: bool = False,
    ):
        super().__init__()
        self.init_kwargs = {k: v for k, v in locals().items()
                            if k not in ("self", "__class__")}
        self.hidden_features = hidden_features
        self.lmax_attr = lmax_attr
        self.center_mode = center_mode
        self.use_force_input = use_force_input
        self.remat = remat
        self.attr_irreps = Irreps.spherical_harmonics(lmax_attr)
        self.hidden_irreps = weight_balanced_irreps(hidden_features, self.attr_irreps, lmax_h)
        self.embedding = SteerableTensorProduct(INPUT_IRREPS, self.hidden_irreps,
                                                self.attr_irreps)
        self.layers = nn.ModuleList(
            SEGNNLayer(self.hidden_irreps, self.attr_irreps, normalization_type)
            for _ in range(num_layers))
        self.pre_pool1 = SteerableTPSwishGate(self.hidden_irreps, self.hidden_irreps,
                                              self.attr_irreps)
        self.pre_pool2 = SteerableTensorProduct(self.hidden_irreps, OUTPUT_IRREPS,
                                                self.attr_irreps)

    def forward(self, scene: Scene, mask: torch.Tensor, train: bool = False) -> torch.Tensor:
        x, edge_sh, node_attr, additional, adj = featurize(
            scene, mask, self.lmax_attr, self.center_mode, self.use_force_input)
        x = self.embedding(x, node_attr)
        x = _run_layers(self.layers, self.remat, x, edge_sh, node_attr, additional, adj)
        x = self.pre_pool2(self.pre_pool1(x, node_attr), node_attr)
        return _readout(x)

    def get_model_size(self) -> int:
        """Width used by the Noam LR schedule."""
        return self.hidden_features


def _run_layers(layers, remat: bool, x, *inputs):
    """Each layer in turn; with ``remat`` each one is recomputed in the
    backward pass instead of keeping its activations."""
    for layer in layers:
        if remat and torch.is_grad_enabled():
            x = checkpoint(layer, x, *inputs, use_reentrant=False)
        else:
            x = layer(x, *inputs)
    return x


class SEConvLayer(nn.Module):
    """Steerable convolution layer: messages through one (``linear``) or two
    (``nonlinear``) tensor products into the gate irreps, a masked sum, the
    gate, the residual.  flax names its modules ``SteerableTPSwishGate_0``
    (message, nonlinear only) and ``SteerableTensorProduct_0`` (conv)."""

    def __init__(self, hidden_irreps: Irreps, attr_irreps: Irreps, conv_type: str = "linear"):
        super().__init__()
        message_in = hidden_irreps + hidden_irreps + ADDITIONAL_IRREPS
        irreps_g = gate_irreps(hidden_irreps)
        if conv_type == "linear":
            self.message = None
            self.conv = SteerableTensorProduct(message_in, irreps_g, attr_irreps)
        elif conv_type == "nonlinear":
            self.message = SteerableTPSwishGate(message_in, hidden_irreps, attr_irreps)
            self.conv = SteerableTensorProduct(hidden_irreps, irreps_g, attr_irreps)
        else:
            raise ValueError(f"Invalid conv_type {conv_type}")
        self.gate = GateActivation(hidden_irreps)

    def forward(self, x, edge_sh, node_attr, additional, adj):
        m = _pairs(x, additional)
        if self.message is not None:
            m = self.message(m, edge_sh)
        msg = G.masked_segment_sum(self.conv(m, edge_sh), adj)
        return x + self.gate(msg)


class SEConv(nn.Module):
    """The reference's alternative steerable convolution net, with SEGNN's
    featurisation: ``forward(scene, mask, train=False) -> [B, N, 6]``.  flax
    names its modules ``SteerableTensorProduct_0`` (embedding),
    ``Scan_SEConvLayer_0`` (the layers), ``SteerableTPSwishGate_0``
    (pre_pool1) and ``SteerableTensorProduct_1`` (pre_pool2)."""

    def __init__(
        self,
        hidden_features: int = 96,
        lmax_attr: int = 1,
        lmax_h: int = 1,
        num_layers: int = 8,
        conv_type: str = "linear",
        center_mode: str = "coords",
        remat: bool = False,
    ):
        super().__init__()
        self.init_kwargs = {k: v for k, v in locals().items()
                            if k not in ("self", "__class__")}
        self.hidden_features = hidden_features
        self.lmax_attr = lmax_attr
        self.center_mode = center_mode
        self.remat = remat
        self.attr_irreps = Irreps.spherical_harmonics(lmax_attr)
        self.hidden_irreps = weight_balanced_irreps(hidden_features, self.attr_irreps, lmax_h)
        self.embedding = SteerableTensorProduct(INPUT_IRREPS, self.hidden_irreps,
                                                self.attr_irreps)
        self.layers = nn.ModuleList(SEConvLayer(self.hidden_irreps, self.attr_irreps, conv_type)
                                    for _ in range(num_layers))
        self.pre_pool1 = SteerableTPSwishGate(self.hidden_irreps, self.hidden_irreps,
                                              self.attr_irreps)
        self.pre_pool2 = SteerableTensorProduct(self.hidden_irreps, OUTPUT_IRREPS,
                                                self.attr_irreps)

    def forward(self, scene: Scene, mask: torch.Tensor, train: bool = False) -> torch.Tensor:
        x, edge_sh, node_attr, additional, adj = featurize(scene, mask, self.lmax_attr,
                                                           self.center_mode)
        x = self.embedding(x, node_attr)
        x = _run_layers(self.layers, self.remat, x, edge_sh, node_attr, additional, adj)
        x = self.pre_pool2(self.pre_pool1(x, node_attr), node_attr)
        return _readout(x)

    def get_model_size(self) -> int:
        """Width used by the Noam LR schedule."""
        return self.hidden_features
