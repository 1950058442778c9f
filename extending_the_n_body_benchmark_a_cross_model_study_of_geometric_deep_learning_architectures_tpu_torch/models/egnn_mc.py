"""EGNN-MC: E(n)-equivariant GNN with a velocity channel and per-target heads.

Counterpart of the JAX package's ``models/egnn_mc.py``, in its dense and its
streaming form.  Featurisation (node features ``[|v|, m]``, edge attrs
``[m_i m_j, v_i . r_hat, v_j . r_hat, d^2]``) runs inside ``forward``.

Each layer's edge stage goes through one kernel wrapper, which on a CPU tensor
computes the dense masked-mean formula instead:

* dense (default): ``ops.egnn_messages.fused_egnn_messages``, kernel K1, fed
  the ``[B, N, N, 8]`` geometry that ``featurize`` and ``edge_inputs`` build;
* ``streaming=True``: ``ops.egnn_stream.streaming_egnn_messages``, kernel K3,
  which computes the geometry itself from the scene's ``pos``, ``vel`` and
  ``mass`` and the layer's coordinates, so no ``[B, N, N, *]`` tensor but the
  mask exists: the single-card path for large N.

Both share one parameter tree.  The first edge matmul is decomposed over the
concat ``[h_i, h_j, d^2, e_ij]`` into per-node projections ``hA``/``hB`` plus
a 5-feature geometric term, so no ``[B, N, N, 2H + 5]`` tensor exists.

Not ported yet, and refused: ``stream_elem_bf16``, ``body_ring`` (multi-GPU),
``fc_fast``, ``remat`` and ``compute_dtype="bfloat16"``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..core import graph as G
from ..core.scene import Scene
from ..ops import egnn_messages as EM
from ..ops import egnn_stream as ES
from .common import (
    MLP,
    TorchLinear,
    torch_bias_init_for,
    torch_kernel_init,
    xavier_uniform_gain,
)

_LATER = {
    "compute_dtype": "ROADMAP.md, still to come 1: K1 and K3 in bfloat16",
    "stream_elem_bf16": "ROADMAP.md, still to come 1: K3's bf16 elementwise stack",
    "fc_fast": "ROADMAP.md, queue 1 item 4 (fc_fast dense path)",
    "remat": "ROADMAP.md, queue 1 item 10 (training)",
    "body_ring": "ROADMAP.md, queue 1 item 15 (multi-GPU)",
}


class EGNNBlock(nn.Module):
    """One message-passing layer.  The edge-stage parameters are explicit
    ``[in, out]`` kernels, shared by the kernel and the plain path."""

    def __init__(
        self,
        hidden_node_dim: int,
        hidden_edge_dim: int,
        hidden_coord_dim: int,
        edge_attr_dim: int,
        activation: str = "silu",
        coords_weight: float = 1.0,
        recurrent: bool = True,
        norm_diff: bool = False,
        tanh: bool = False,
        streaming: bool = False,
    ):
        super().__init__()
        H, He, Hc = hidden_node_dim, hidden_edge_dim, hidden_coord_dim
        in_dim = 2 * H + 1 + edge_attr_dim

        def param(shape, init):
            return nn.Parameter(init(torch.empty(shape)))

        self.edge_w1 = param((in_dim, He), torch_kernel_init)
        self.edge_b1 = param((He,), torch_bias_init_for(in_dim))
        self.edge_w2 = param((He, He), torch_kernel_init)
        self.edge_b2 = param((He,), torch_bias_init_for(He))
        self.coord_w1 = param((He, Hc), torch_kernel_init)
        self.coord_b1 = param((Hc,), torch_bias_init_for(He))
        self.coord_w2 = param((Hc, 1), xavier_uniform_gain(0.001))
        self.vel_mlp = MLP(H, [Hc], 1, activation)  # velocity gate
        self.node_mlp = MLP(2 * H, [H], H, activation)
        self.hidden_node_dim = H
        self.activation = activation
        self.coords_weight = coords_weight
        self.recurrent = recurrent
        self.norm_diff = norm_diff
        self.tanh = tanh
        self.streaming = streaming

    def node_terms(self, h):
        """``hA = h W1[:H] + b1`` (receiver term) and ``hB = h W1[H:2H]`` (sender term)."""
        H = self.hidden_node_dim
        return h @ self.edge_w1[:H] + self.edge_b1, h @ self.edge_w1[H : 2 * H]

    def edge_inputs(self, h, coord, edge_attr):
        """The dense edge stage's per-call inputs: ``hA``, ``hB [B,N,He]`` and
        ``geom [B,N,N,8] = [d2, edge_attr(4), coord_diff(3)]``."""
        hA, hB = self.node_terms(h)
        # coord2radial: receiver-minus-sender differences
        coord_diff = G.rel_positions(coord)
        radial = torch.sum(coord_diff * coord_diff, dim=-1, keepdim=True)
        if self.norm_diff:
            coord_diff = coord_diff / torch.clamp(G.safe_sqrt(radial), min=1.0)
        return hA, hB, torch.cat([radial, edge_attr, coord_diff], dim=-1)

    def edge_weights(self):
        """``(w_geom, W2, b2, Wc1, bc1, wc2)`` as the edge stage takes them."""
        return (self.edge_w1[2 * self.hidden_node_dim :], self.edge_w2, self.edge_b2,
                self.coord_w1, self.coord_b1, self.coord_w2[:, 0])

    def forward(self, h, coord, velocity, edge_attr, mask) -> Tuple[torch.Tensor, torch.Tensor]:
        """``h [B,N,H]``, ``coord``/``velocity [B,N,3]``, ``mask [B,N,N]``, and
        ``edge_attr [B,N,N,E]`` -- or, under ``streaming``, the scene's
        ``(pos [B,N,3], mass [B,N,1])`` -> ``(h, coord)``."""
        if self.streaming:
            pos0, mass = edge_attr
            hA, hB = self.node_terms(h)
            agg, trans = ES.streaming_egnn_messages(
                hA, hB, pos0, velocity, mass, coord, mask, *self.edge_weights(),
                tanh=self.tanh, norm_diff=self.norm_diff, activation=self.activation,
            )
        else:
            hA, hB, geom = self.edge_inputs(h, coord, edge_attr)
            agg, trans = EM.fused_egnn_messages(
                hA, hB, geom, mask, *self.edge_weights(),
                tanh=self.tanh, activation=self.activation,
            )
        coord = coord + trans.to(coord.dtype) * self.coords_weight
        # velocity-gated coordinate update, then the node model
        coord = coord + self.vel_mlp(h) * velocity
        h_out = self.node_mlp(torch.cat([h, agg], dim=-1))
        if self.recurrent:
            h_out = h + h_out
        return h_out, coord


class EGNNMC(nn.Module):
    """Embedding, ``num_layers`` blocks and one vector head per target.

    ``forward(scene, mask) -> [B, N, 3 * num_targets]`` (pos_dt | vel).
    ``pallas_tile`` and ``stream_tile_j`` are the JAX model's TPU tile sizes,
    taken for its signature's sake; they change nothing here.
    """

    def __init__(
        self,
        hidden_node_dim: int = 128,
        hidden_edge_dim: int = 128,
        hidden_coord_dim: int = 128,
        num_layers: int = 6,
        node_input_dim: int = 2,
        edge_attr_dim: int = 4,
        activation: str = "silu",
        coords_weight: float = 1.0,
        recurrent: bool = True,
        norm_diff: bool = True,
        tanh: bool = True,
        num_targets: int = 2,
        streaming: bool = False,
        pallas_tile: int = 32,
        stream_tile_j: int = 128,
        stream_elem_bf16: bool = False,
        body_ring: bool = False,
        fc_fast: bool = False,
        remat: bool = False,
        compute_dtype: str = "",
    ):
        super().__init__()
        for name, value in (("stream_elem_bf16", stream_elem_bf16), ("body_ring", body_ring),
                            ("fc_fast", fc_fast), ("remat", remat),
                            ("compute_dtype", compute_dtype)):
            if value:
                raise NotImplementedError(f"EGNNMC({name}=...) is not ported yet: {_LATER[name]}")
        H = hidden_node_dim
        self.hidden_node_dim = H
        self.streaming = streaming
        self.embedding = TorchLinear(node_input_dim, H)
        self.layers = nn.ModuleList(
            EGNNBlock(H, hidden_edge_dim, hidden_coord_dim, edge_attr_dim, activation,
                      coords_weight, recurrent, norm_diff, tanh, streaming)
            for _ in range(num_layers)
        )
        self.heads = nn.ModuleList(
            MLP(H + 6, [H, H], 3, activation) for _ in range(num_targets)
        )

    @staticmethod
    def featurize(scene: Scene) -> Tuple[torch.Tensor, torch.Tensor]:
        """Node features ``[B,N,2]`` and edge attributes ``[B,N,N,4]``."""
        speed = torch.linalg.vector_norm(scene.vel, dim=-1, keepdim=True)
        x = torch.cat([speed, scene.mass], dim=-1)
        edge_vec = G.rel_positions(scene.pos)  # pos_i - pos_j
        dist_sq = torch.sum(edge_vec * edge_vec, dim=-1, keepdim=True)
        dist = torch.clamp(G.safe_sqrt(dist_sq), min=1e-12)
        direction = edge_vec / dist
        proj_i = torch.sum(scene.vel[:, :, None, :] * direction, dim=-1, keepdim=True)
        proj_j = torch.sum(scene.vel[:, None, :, :] * direction, dim=-1, keepdim=True)
        mass_prod = scene.mass[:, :, None, :] * scene.mass[:, None, :, :]
        return x, torch.cat([mass_prod, proj_i, proj_j, dist_sq], dim=-1)

    def forward(self, scene: Scene, mask: torch.Tensor) -> torch.Tensor:
        if self.streaming:  # the edge kernel featurises from the O(N) node data
            speed = torch.linalg.vector_norm(scene.vel, dim=-1, keepdim=True)
            x, edge_attr = torch.cat([speed, scene.mass], dim=-1), (scene.pos, scene.mass)
        else:
            x, edge_attr = self.featurize(scene)
        h = self.embedding(x)
        coord = scene.pos
        maskf = mask.to(scene.dtype)  # converted once for all layers
        for layer in self.layers:
            h, coord = layer(h, coord, scene.vel, edge_attr, maskf)
        head_in = torch.cat([h, coord - scene.pos, scene.vel], dim=-1)
        return torch.cat([head(head_in) for head in self.heads], dim=-1)

    def get_model_size(self) -> int:
        """Width used by the Noam LR schedule."""
        return self.hidden_node_dim
