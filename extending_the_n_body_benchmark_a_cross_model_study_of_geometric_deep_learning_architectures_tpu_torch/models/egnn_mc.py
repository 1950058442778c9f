"""EGNN-MC: E(n)-equivariant GNN with a velocity channel and per-target heads.

Counterpart of the JAX package's ``models/egnn_mc.py``, in its dense and its
streaming form.  Featurisation (node features ``[|v|, m]``, edge attrs
``[m_i m_j, v_i . r_hat, v_j . r_hat, d^2]``) runs inside ``forward``.

Each layer's edge stage runs one of three ways:

* ``edge_impl="kernel"`` (default): ``ops.egnn_messages.fused_egnn_messages``,
  kernel K1, fed the ``[B, N, N, 8]`` geometry that ``featurize`` and
  ``edge_inputs`` build (on a CPU tensor the wrapper computes the dense
  masked-mean formula instead);
* ``streaming=True``: ``ops.egnn_stream.streaming_egnn_messages``, kernel K3,
  which computes the geometry itself from the scene's ``pos``, ``vel`` and
  ``mass`` and the layer's coordinates, so no ``[B, N, N, *]`` tensor but the
  mask exists: the single-card path for large N;
* ``edge_impl="dense"``: :meth:`EGNNBlock.dense_edge_stage`, the JAX model's
  own XLA edge stage (``use_pallas=False``, ``models/egnn_mc.py:141-201``)
  written in torch ops on any device.  It materialises the ``[B, N, N, He]``
  messages and autograd differentiates it: the kernels have no backward, so
  training runs it (``forward(..., edge_impl="dense")``).  Streaming has no
  dense form: the JAX model streams only through its kernel.

Both share one parameter tree.  The first edge matmul is decomposed over the
concat ``[h_i, h_j, d^2, e_ij]`` into per-node projections ``hA``/``hB`` plus
a 5-feature geometric term, so no ``[B, N, N, 2H + 5]`` tensor exists.

``compute_dtype="bfloat16"`` is the JAX model's mixed precision
(``models/egnn_mc.py:261-264``): ``h`` is cast after the embedding, each block
casts its parameters to ``h.dtype`` at use (they stay float32), and the
edge kernels run their bf16 forms; coordinates, geometry, ``trans`` and the
heads stay float32.  ``stream_elem_bf16`` runs the streaming kernel's
elementwise stack in bf16.

``remat=True`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``, the JAX model's ``nn.remat`` of its scanned
block): the same numbers for less activation memory.

``body_ring=True`` is the body-sharded ring (``parallel/ring_egnn.py``, the
JAX model's ``body_ring``): the forward runs on this rank's block of bodies
and takes the ``body`` group as ``forward(..., ring=group)``
(``parallel.sharded.make_body_ring_rollout_fn`` passes it); the edge stage
featurises from the O(N) node data, as the streaming one does, over fully
connected graphs (no mask), in plain PyTorch with silu, and autograd
differentiates it through the ring (each rank's parameter gradients are
then its block's share: their sum over the ``body`` group is the whole
sim's).  The parameter tree is the dense model's.

``forward(..., senders=Senders(scene, gather))`` is the receiver-rows form
of the dense edge stage (``parallel.sharded.make_sharded_train_step(...,
shard_bodies=True)``): ``scene`` and ``mask [B, n, N]`` are this rank's
receivers' rows, ``Senders.scene`` every body of their sims, and
``Senders.gather`` takes a node tensor of the receivers' rows to every
sender's (differentiable); every edge tensor is ``[B, n, N, *]``, on any
mask.

``fc_fast=True`` is the JAX model's fully connected fast path of the dense
edge stage (``models/egnn_mc.py:178-197``): no mask multiplies, ``trans``
summed over the senders and divided by N-1 (its diagonal is exactly 0), and
the diagonal message ``m_ii`` computed at O(B N) and subtracted from the sum
of messages before the same division.  It is exact only for a fully
connected mask, which the caller guarantees, as in the JAX package.  The
kernel, streaming and ring edge stages ignore it, as the JAX model's Pallas,
streaming and ring branches do, and so does the receiver-rows form
(``senders=``), whose diagonal is not the square's.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

from .. import _tf32  # noqa: F401  (TF32 off before torch is used)
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core import graph as G
from ..core.scene import Scene
from ..ops import egnn_messages as EM
from ..ops import egnn_stream as ES
from ..parallel.ring_egnn import ring_edge_stage
from .common import (
    MLP,
    TorchLinear,
    get_activation,
    torch_bias_init_for,
    torch_kernel_init,
    xavier_uniform_gain,
)

EDGE_IMPLS = ("kernel", "dense")

class Senders(NamedTuple):
    """Every sender of a receiver-rows forward: ``scene`` the whole sims'
    (``[B, N, *]``), ``gather`` a node tensor of the receivers' rows ``[B, n,
    *]`` to every sender's ``[B, N, *]``, differentiable."""

    scene: Scene
    gather: Callable[[torch.Tensor], torch.Tensor]


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
        elem_bf16: bool = False,
        body_ring: bool = False,
        fc_fast: bool = False,
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
        self.node_mlp = MLP(H + He, [H], H, activation)  # on [h, agg]
        self.hidden_node_dim = H
        self.activation = activation
        self.coords_weight = coords_weight
        self.recurrent = recurrent
        self.norm_diff = norm_diff
        self.tanh = tanh
        self.streaming = streaming
        self.elem_bf16 = elem_bf16
        self.body_ring = body_ring
        self.fc_fast = fc_fast

    def node_terms(self, h):
        """``hA = h W1[:H] + b1`` (receiver term) and ``hB = h W1[H:2H]`` (sender term),
        in ``h``'s dtype."""
        H = self.hidden_node_dim
        W1, b1 = self.edge_w1.to(h.dtype), self.edge_b1.to(h.dtype)
        return h @ W1[:H] + b1, h @ W1[H : 2 * H]

    def edge_inputs(self, h, coord, edge_attr, gather=None):
        """The dense edge stage's per-call inputs: ``hA``, ``hB [B,N,He]`` and
        ``geom [B,N,N,8] = [d2, edge_attr(4), coord_diff(3)]``.  ``gather``
        (the receiver-rows form): ``hB`` and the senders' coordinates are
        every sender's, ``geom`` the receivers' rows ``[B,n,N,8]``."""
        hA, hB = self.node_terms(h)
        coord_s = coord
        if gather is not None:
            hB, coord_s = gather(hB), gather(coord)
        # coord2radial: receiver-minus-sender differences
        coord_diff = coord[..., :, None, :] - coord_s[..., None, :, :]
        radial = torch.sum(coord_diff * coord_diff, dim=-1, keepdim=True)
        if self.norm_diff:
            coord_diff = coord_diff / torch.clamp(G.safe_sqrt(radial), min=1.0)
        return hA, hB, torch.cat([radial, edge_attr, coord_diff], dim=-1)

    def edge_weights(self, dtype=None):
        """``(w_geom, W2, b2, Wc1, bc1, wc2)`` as the edge stage takes them, cast to
        ``dtype`` (default: the parameters' own)."""
        w = (self.edge_w1[2 * self.hidden_node_dim :], self.edge_w2, self.edge_b2,
             self.coord_w1, self.coord_b1, self.coord_w2[:, 0])
        return w if dtype is None else tuple(t.to(dtype) for t in w)

    def dense_edge_stage(self, h, coord, edge_attr, mask,
                         gather=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The JAX model's XLA edge stage (``models/egnn_mc.py:141-201``) in torch
        ops, differentiable: ``(agg [B,N,He], trans [B,N,3])``, the masked means
        over senders of the messages and of the clipped coordinate terms; with
        ``gather``, the receivers' rows against every sender.  Under
        ``fc_fast`` (whole sims only) the means are those of a fully connected
        mask, taken without it."""
        act = get_activation(self.activation)
        hA, hB, geom = self.edge_inputs(h, coord, edge_attr, gather)
        w_geom, W2, b2, Wc1, bc1, wc2 = self.edge_weights(h.dtype)
        g_term = geom[..., :5].to(h.dtype) @ w_geom  # [d2, edge_attr] @ W1[2H:]
        m_ij = act(act(hA[:, :, None, :] + hB[:, None, :, :] + g_term) @ W2 + b2)
        w = act(m_ij @ Wc1 + bc1) @ wc2  # [B,N,N], a scalar weight per edge
        if self.tanh:
            w = torch.tanh(w)
        # the coordinate update stays in the coordinates' dtype
        trans = torch.clamp(w[..., None].to(coord.dtype) * geom[..., 5:], -100.0, 100.0)
        if self.fc_fast and gather is None:
            n = h.shape[1]
            # the self pair: radial 0, the edge attributes' diagonal
            ea_diag = torch.diagonal(edge_attr, dim1=1, dim2=2).movedim(-1, 1).to(h.dtype)
            m_diag = act(act(hA + hB + ea_diag @ w_geom[1:]) @ W2 + b2)  # [B,N,He]
            return (m_ij.sum(dim=2) - m_diag) / (n - 1), trans.sum(dim=2) / (n - 1)
        return G.masked_segment_mean(m_ij, mask), G.masked_segment_mean(trans, mask)

    def forward(self, h, coord, velocity, edge_attr, mask, edge_impl: str = "kernel",
                ring=None, gather=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``h [B,N,H]``, ``coord``/``velocity [B,N,3]``, ``mask [B,N,N]``, and
        ``edge_attr [B,N,N,E]`` -- or, under ``streaming`` and ``body_ring``, the
        scene's ``(pos [B,N,3], mass [B,N,1])`` -> ``(h, coord)``.  ``edge_impl``
        picks the dense edge stage's form (``"kernel"`` or ``"dense"``);
        ``ring`` is the ``body`` group of ``body_ring``; ``gather`` is
        :class:`Senders`'s (the dense stage's receiver-rows form)."""
        if self.body_ring:
            pos0, mass = edge_attr
            hA, hB = self.node_terms(h)
            agg, trans = ring_edge_stage(hA, hB, pos0, velocity, mass, coord,
                                         *self.edge_weights(h.dtype), tanh=self.tanh,
                                         norm_diff=self.norm_diff, group=ring)
        elif edge_impl == "dense":
            agg, trans = self.dense_edge_stage(h, coord, edge_attr, mask, gather)
        elif self.streaming:
            pos0, mass = edge_attr
            hA, hB = self.node_terms(h)
            agg, trans = ES.streaming_egnn_messages(
                hA, hB, pos0, velocity, mass, coord, mask, *self.edge_weights(h.dtype),
                tanh=self.tanh, norm_diff=self.norm_diff, elem_bf16=self.elem_bf16,
                activation=self.activation,
            )
        else:
            hA, hB, geom = self.edge_inputs(h, coord, edge_attr)
            agg, trans = EM.fused_egnn_messages(
                hA, hB, geom, mask, *self.edge_weights(h.dtype),
                tanh=self.tanh, activation=self.activation,
            )
        coord = coord + trans.to(coord.dtype) * self.coords_weight
        # velocity-gated coordinate update (a bf16 gate promotes against the f32
        # velocity), then the node model in h's dtype
        coord = coord + self.vel_mlp(h) * velocity
        h_out = self.node_mlp(torch.cat([h, agg], dim=-1)).to(h.dtype)
        if self.recurrent:
            h_out = h + h_out
        return h_out, coord


class EGNNMC(nn.Module):
    """Embedding, ``num_layers`` blocks and one vector head per target.

    ``forward(scene, mask) -> [B, N, 3 * num_targets]`` (pos_dt | vel).
    ``edge_impl`` is the edge stage's form (``"kernel"`` or ``"dense"``), which
    ``forward(..., edge_impl=...)`` overrides for one call.
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
        edge_impl: str = "kernel",
    ):
        super().__init__()
        self.init_kwargs = {k: v for k, v in locals().items()
                            if k not in ("self", "__class__")}
        if body_ring and activation != "silu":
            raise ValueError(f"body_ring computes its edge MLP with silu, not {activation!r}")
        if compute_dtype not in ("", "float32", "bfloat16"):
            raise ValueError(f"compute_dtype {compute_dtype!r}: '', 'float32' or 'bfloat16'")
        self.streaming = streaming
        self.body_ring = body_ring
        self.edge_impl = self._check_impl(edge_impl)
        H = hidden_node_dim
        self.hidden_node_dim = H
        self.remat = remat
        self.compute_dtype = getattr(torch, compute_dtype) if compute_dtype else None
        self.embedding = TorchLinear(node_input_dim, H)
        self.layers = nn.ModuleList(
            EGNNBlock(H, hidden_edge_dim, hidden_coord_dim, edge_attr_dim, activation,
                      coords_weight, recurrent, norm_diff, tanh, streaming, stream_elem_bf16,
                      body_ring, fc_fast)
            for _ in range(num_layers)
        )
        self.heads = nn.ModuleList(
            MLP(H + 6, [H, H], 3, activation) for _ in range(num_targets)
        )

    @staticmethod
    def featurize(scene: Scene, senders: Optional[Scene] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Node features ``[B,N,2]`` and edge attributes ``[B,N,N,4]``; with
        ``senders`` (every body of ``scene``'s sims), the rows ``[B,n,N,4]`` of
        ``scene``'s receivers."""
        s = scene if senders is None else senders
        speed = torch.linalg.vector_norm(scene.vel, dim=-1, keepdim=True)
        x = torch.cat([speed, scene.mass], dim=-1)
        edge_vec = scene.pos[..., :, None, :] - s.pos[..., None, :, :]  # pos_i - pos_j
        dist_sq = torch.sum(edge_vec * edge_vec, dim=-1, keepdim=True)
        dist = torch.clamp(G.safe_sqrt(dist_sq), min=1e-12)
        direction = edge_vec / dist
        proj_i = torch.sum(scene.vel[:, :, None, :] * direction, dim=-1, keepdim=True)
        proj_j = torch.sum(s.vel[:, None, :, :] * direction, dim=-1, keepdim=True)
        mass_prod = scene.mass[:, :, None, :] * s.mass[:, None, :, :]
        return x, torch.cat([mass_prod, proj_i, proj_j, dist_sq], dim=-1)

    def _check_impl(self, edge_impl: str) -> str:
        if edge_impl not in EDGE_IMPLS:
            raise ValueError(f"edge_impl {edge_impl!r}: one of {EDGE_IMPLS}")
        if edge_impl == "dense" and self.streaming:
            raise ValueError("streaming=True runs only through its kernel (edge_impl='kernel'), "
                             "as the JAX model streams only through its Pallas kernel")
        return edge_impl

    def forward(self, scene: Scene, mask: Optional[torch.Tensor],
                edge_impl: Optional[str] = None, ring=None,
                senders: Optional[Senders] = None) -> torch.Tensor:
        """``ring``: the ``body`` process group of a ``body_ring`` model, whose
        ``scene`` is this rank's block of bodies and whose ``mask`` is unused
        (fully connected).  ``senders``: the receiver-rows form of the dense
        edge stage, ``scene`` and ``mask [B,n,N]`` the receivers' rows (see
        the module note)."""
        impl = self.edge_impl if edge_impl is None else self._check_impl(edge_impl)
        if self.body_ring and ring is None:
            raise ValueError("a body_ring model runs inside a ring: pass forward(..., "
                             "ring=<the body group>), as make_body_ring_rollout_fn does")
        if senders is not None and (impl != "dense" or self.body_ring):
            raise ValueError("the receiver-rows form (senders=) runs the dense edge stage "
                             "(edge_impl='dense') of a model without body_ring")
        if self.streaming or self.body_ring:  # the edge stage featurises from the node data
            speed = torch.linalg.vector_norm(scene.vel, dim=-1, keepdim=True)
            x, edge_attr = torch.cat([speed, scene.mass], dim=-1), (scene.pos, scene.mass)
        else:
            x, edge_attr = self.featurize(scene, None if senders is None else senders.scene)
        gather = None if senders is None else senders.gather
        h = self.embedding(x)
        if self.compute_dtype is not None:
            h = h.to(self.compute_dtype)
        coord = scene.pos
        maskf = None if self.body_ring else mask.to(scene.dtype)  # converted once for all layers
        for layer in self.layers:
            if self.remat and torch.is_grad_enabled():
                h, coord = checkpoint(layer, h, coord, scene.vel, edge_attr, maskf, impl, ring,
                                      gather, use_reentrant=False)
            else:
                h, coord = layer(h, coord, scene.vel, edge_attr, maskf, impl, ring, gather)
        head_in = torch.cat([h.to(coord.dtype), coord - scene.pos, scene.vel], dim=-1)
        return torch.cat([head(head_in) for head in self.heads], dim=-1)

    def get_model_size(self) -> int:
        """Width used by the Noam LR schedule."""
        return self.hidden_node_dim
