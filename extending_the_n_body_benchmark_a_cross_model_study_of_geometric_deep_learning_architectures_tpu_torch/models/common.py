"""Shared model building blocks (dense ``[B, N, ...]`` layout).

Counterpart of the JAX package's ``models/common.py``.  torch's ``nn.Linear``
(which :class:`TorchLinear` extends) already initialises kernel and bias as
``U(-1/sqrt(fan_in), +1/sqrt(fan_in))``, the scale the reference models rely
on; the init functions below reproduce it (and the small-gain Xavier of EGNN's
coordinate head) for parameters that are not held by an ``nn.Linear``.  Kernels kept outside ``nn.Linear`` use the JAX
package's ``[in, out]`` layout.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def cast_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` in ``like``'s dtype (parameters are applied in the input's
    dtype), with no op where they already agree."""
    return t if t.dtype == like.dtype else t.to(like.dtype)


def torch_kernel_init(t: torch.Tensor):
    """In place: ``U(+-1/sqrt(fan_in))`` for an ``[in, out]`` kernel."""
    bound = 1.0 / math.sqrt(t.shape[0])
    with torch.no_grad():
        return t.uniform_(-bound, bound)


def torch_bias_init_for(fan_in: int) -> Callable:
    def init(t: torch.Tensor):
        bound = 1.0 / math.sqrt(fan_in)
        with torch.no_grad():
            return t.uniform_(-bound, bound)

    return init


def xavier_uniform_gain(gain: float) -> Callable:
    def init(t: torch.Tensor):
        fan_in, fan_out = t.shape[0], t.shape[1]
        bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
        with torch.no_grad():
            return t.uniform_(-bound, bound)

    return init


class TorchLinear(nn.Linear):
    """``nn.Linear`` that computes in its input's dtype, as the JAX package's
    ``TorchLinear`` (flax ``nn.Dense(dtype=x.dtype, param_dtype=float32)``) does.

    The parameters stay as they are (float32 in a mixed-bf16 model) and are
    cast to the input's dtype at use.  A cast call rounds where JAX does: the
    product is rounded to that dtype, then the bias add."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return F.linear(x, self.weight, self.bias)
        out = x @ self.weight.to(x.dtype).T
        return out if self.bias is None else out + self.bias.to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis with flax's epsilon (1e-6, where torch's
    is 1e-5), applied in the input's dtype."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return F.layer_norm(x, self.normalized_shape, self.weight, self.bias, self.eps)
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


ACTIVATIONS = {
    "silu": F.silu,
    "relu": F.relu,
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.2),
    "lrelu": lambda x: F.leaky_relu(x, negative_slope=0.2),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
}


def get_activation(name: str) -> Callable:
    name = name.lower()
    if name not in ACTIVATIONS:
        raise ValueError(f"Unsupported activation '{name}'.")
    return ACTIVATIONS[name]


class MLP(nn.Module):
    """Linear -> act -> ... -> Linear; ``hidden`` lists the hidden widths."""

    def __init__(self, in_features: int, hidden: Sequence[int], out: int,
                 activation: str = "silu"):
        super().__init__()
        widths = [in_features, *hidden, out]
        self.layers = nn.ModuleList(TorchLinear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.act = get_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = self.act(layer(x))
        return self.layers[-1](x)
