"""GraphTransformer: a post-LN transformer encoder over each simulation's bodies.

Counterpart of the JAX package's ``models/graph_transformer.py``: the input
is ``concat(pos, vel)`` (no mass), full attention over the N bodies (the
neighbour mask is taken and unused, so the model is permutation-equivariant
only), each layer MHA -> dropout -> add -> LayerNorm -> Linear(2048) -> ReLU
-> dropout -> Linear(H) -> dropout -> add -> LayerNorm, then the
``MLP([H, H], 6, relu)`` head.  Plain PyTorch: the attention is written out
(``einsum`` and ``softmax``) as flax 0.12's ``MultiHeadDotProductAttention``
computes it: per-head ``query`` / ``key`` / ``value`` projections with bias,
the query divided by ``sqrt(head_dim)`` before the product, the softmax over
keys, the ``out`` projection over ``(heads, head_dim)``.

Submodules and parameters carry the flax names (``TorchLinear_0``,
``MultiHeadDotProductAttention_0`` with ``query`` / ``key`` / ``value`` /
``out`` kernels in flax's shapes, ``LayerNorm_k``, ``Dropout_k``,
``MLP_0``); the encoder layers are ``blocks`` here and ``_EncoderLayer_k``
there, so ``weights`` maps a key to its flax path by rule.  LayerNorms use
flax's epsilon (:class:`.common.LayerNorm`).

Dropout is live in training mode (``self.training``): flax's attention
draws one keep mask of shape ``[1, 1, N, N]`` a layer (its default
``broadcast_dropout``), shared by every simulation and head, and the three
``Dropout``s draw masks of their input's full shape.  The masks come from an
explicit ``torch.Generator`` that the caller passes (``generator=``) on the
model's device, all drawn before the first layer runs; a training-mode
forward with a rate above 0 and no generator raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.scene import Scene
from .common import MLP, LayerNorm, TorchLinear, cast_like


def _lecun_normal_(t: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's default kernel init: a normal truncated at two standard
    deviations, scaled to variance ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std)


class Dropout(nn.Module):
    """flax's ``nn.Dropout`` with its keep mask drawn outside:
    ``where(keep, x / (1 - rate), 0)``, and ``x`` unchanged without a mask."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        if keep is None:
            return x
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class HeadProjection(nn.Module):
    """flax's ``DenseGeneral`` onto ``(heads, head_dim)``: ``kernel [in,
    heads, head_dim]``, ``bias [heads, head_dim]`` (the ``query``, ``key``
    and ``value`` projections)."""

    def __init__(self, in_features: int, heads: int, head_dim: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, heads, head_dim))
        self.bias = nn.Parameter(torch.zeros(heads, head_dim))
        _lecun_normal_(self.kernel, in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        heads, head_dim = self.bias.shape
        k = cast_like(self.kernel, x).reshape(x.shape[-1], heads * head_dim)
        y = F.linear(x, k.t(), cast_like(self.bias, x).reshape(-1))
        return y.reshape(*x.shape[:-1], heads, head_dim)


class OutProjection(nn.Module):
    """flax's ``DenseGeneral`` over the ``(heads, head_dim)`` axes:
    ``kernel [heads, head_dim, out]``, ``bias [out]``."""

    def __init__(self, heads: int, head_dim: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(heads, head_dim, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        _lecun_normal_(self.kernel, heads * head_dim)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        heads, head_dim, out = self.kernel.shape
        k = cast_like(self.kernel, y).reshape(heads * head_dim, out)
        return F.linear(y.reshape(*y.shape[:-2], heads * head_dim), k.t(), cast_like(self.bias, y))


class MultiHeadDotProductAttention(nn.Module):
    """Self-attention as flax's ``MultiHeadDotProductAttention`` computes it,
    with its attention-weight dropout given as a broadcast keep mask."""

    def __init__(self, features: int, num_heads: int, dropout: float):
        super().__init__()
        if features % num_heads:
            raise ValueError(f"{features} features do not split into {num_heads} heads")
        head_dim = features // num_heads
        self.head_dim, self.dropout = head_dim, dropout
        self.query = HeadProjection(features, num_heads, head_dim)
        self.key = HeadProjection(features, num_heads, head_dim)
        self.value = HeadProjection(features, num_heads, head_dim)
        self.out = OutProjection(num_heads, head_dim, features)

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        q, k, v = self.query(x), self.key(x), self.value(x)  # [B, N, heads, head_dim]
        q = q / math.sqrt(self.head_dim)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        if keep is not None:  # [1, 1, N, N]: one draw for every simulation and head
            keep_prob = 1.0 - self.dropout
            w = w * (keep.to(w.dtype) / keep_prob)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v))


class _EncoderLayer(nn.Module):
    """Post-LN encoder layer (torch ``TransformerEncoderLayer`` semantics:
    ``dim_feedforward`` 2048, dropout 0.1, relu, ``norm_first=False``)."""

    def __init__(self, model_dim: int, num_heads: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1):
        super().__init__()
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            model_dim, num_heads, dropout)
        self.Dropout_0 = Dropout(dropout)
        self.LayerNorm_0 = LayerNorm(model_dim)
        self.TorchLinear_0 = TorchLinear(model_dim, dim_feedforward)
        self.Dropout_1 = Dropout(dropout)
        self.TorchLinear_1 = TorchLinear(dim_feedforward, model_dim)
        self.Dropout_2 = Dropout(dropout)
        self.LayerNorm_1 = LayerNorm(model_dim)

    def forward(self, x: torch.Tensor, keeps=(None, None, None, None)) -> torch.Tensor:
        attn_keep, keep0, keep1, keep2 = keeps
        attn = self.Dropout_0(self.MultiHeadDotProductAttention_0(x, attn_keep), keep0)
        x = self.LayerNorm_0(x + attn)
        ff = self.Dropout_1(F.relu(self.TorchLinear_0(x)), keep1)
        ff = self.Dropout_2(self.TorchLinear_1(ff), keep2)
        return self.LayerNorm_1(x + ff)


class GraphTransformer(nn.Module):
    """``forward(scene, mask=None, train=False, generator=None) -> [B, N, 6]``
    (pos_dt | vel).  Dropout follows ``self.training``; ``train`` is taken
    for the JAX signature's sake, and ``mask`` is unused (full attention).
    ``generator`` (a ``torch.Generator`` on the scene's device) draws the
    dropout masks; a training-mode forward with a rate above 0 needs one."""

    def __init__(self, hidden_features: int = 96, num_layers: int = 4, num_heads: int = 4,
                 num_targets: int = 2, dim_feedforward: int = 2048, dropout: float = 0.1):
        super().__init__()
        self.hidden_features, self.num_heads = hidden_features, num_heads
        self.dim_feedforward, self.dropout = dim_feedforward, dropout
        self.TorchLinear_0 = TorchLinear(6, hidden_features)
        self.blocks = nn.ModuleList(
            _EncoderLayer(hidden_features, num_heads, dim_feedforward, dropout)
            for _ in range(num_layers))
        self.MLP_0 = MLP(hidden_features, [hidden_features, hidden_features], 3 * num_targets,
                         activation="relu")

    @property
    def draws_dropout(self) -> bool:
        """Whether a forward now draws dropout masks (and so needs a generator)."""
        return self.training and self.dropout > 0.0

    def draw_masks(self, B: int, N: int, generator: Optional[torch.Generator],
                   device) -> list:
        """Each layer's keep masks, in flax's order of draws: the attention
        weights' ``[1, 1, N, N]``, then the three dropouts' ``[B, N, H]``,
        ``[B, N, dim_feedforward]`` and ``[B, N, H]``; drawn layer by layer
        from ``generator`` as ``uniform < keep``, as ``jax.random.bernoulli``
        draws them.  None each in eval mode or at rate 0."""
        if not self.draws_dropout:
            return [(None,) * 4] * len(self.blocks)
        if generator is None:
            raise ValueError(
                f"GraphTransformer in training mode draws dropout masks (dropout "
                f"{self.dropout}): pass a torch.Generator on the model's device as "
                "generator=, or call model.eval()")
        H, keep = self.hidden_features, 1.0 - self.dropout
        shapes = ((1, 1, N, N), (B, N, H), (B, N, self.dim_feedforward), (B, N, H))
        return [tuple(torch.rand(s, generator=generator, device=device) < keep for s in shapes)
                for _ in self.blocks]

    def forward(self, scene: Scene, mask: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = torch.cat([scene.pos, scene.vel], dim=-1)  # [B, N, 6]
        B, N = x.shape[:2]
        masks = self.draw_masks(B, N, generator, x.device)
        h = self.TorchLinear_0(x)
        for blk, keeps in zip(self.blocks, masks):
            h = blk(h, keeps)
        return self.MLP_0(h)

    def get_model_size(self) -> int:
        """Width used by the Noam LR schedule."""
        return self.hidden_features
