"""PONITA: the position-orientation fiber-bundle network, dense.

Counterpart of the JAX package's ``models/ponita.py``.  The features live on
a shared grid of ``num_ori`` orientations on the sphere, ``x [B, N, O, C]``;
each layer is a separable convolution (a depthwise spatial one over the
neighbours, then one over the orientations) inside a ConvNeXt block.  All of
it is plain PyTorch: matrix products and elementwise operations, as the JAX
model is plain einsums and ``Dense`` layers (no Pallas kernel).

Conventions kept from the JAX model:

* receiver ``r``, sender ``s``: the convolution sums over ``adj[b, r, s] =
  mask[b, s, r]`` with ``rel = pos_s - pos_r`` (the transpose of EGNN-MC's);
* GELU is exact (``approximate="none"``), not ``models.common``'s tanh form;
* LayerNorm's epsilon is flax's 1e-6 (flax takes the variance as
  E[x^2] - E[x]^2, torch in two passes: the same up to rounding);
* the bias-free ``Dense`` layers keep flax's ``[in, out]`` kernel and compute
  in their input's dtype;
* ``layer_scale=0.0`` (or None) disables the layer scale;
* the readout is the mean of every layer's readout under
  ``multiple_readouts``, else the last layer's.

Each convolution keeps the statistics of the model's last calibration
(:func:`calibrate_params`) as buffers ``std_in``, ``std_1`` and ``std_2``
(ones before any): the JAX model's ``calib`` collection, which its
checkpoints carry beside the parameters and its parameter count includes.
They take no part in the forward pass.  The orientation grid is a device
tensor made once per device and dtype from ``ops.s2grid``, outside the
``state_dict``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core import graph as G
from ..core.scene import Scene
from ..ops.s2grid import uniform_grid_s2
from .common import LayerNorm, TorchLinear, torch_kernel_init

CALIB_STATS = ("std_in", "std_1", "std_2")


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def polynomial_features(x: torch.Tensor, degree: int) -> torch.Tensor:
    """``x``, ``x (x) x``, ... up to the ``degree``-th tensor power, flattened
    and concatenated along the last axis."""
    feats = [x]
    for _ in range(1, degree):
        feats.append((feats[-1][..., :, None] * x[..., None, :]).reshape(
            x.shape[:-1] + (feats[-1].shape[-1] * x.shape[-1],)))
    return torch.cat(feats, dim=-1)


class Dense(nn.Module):
    """flax's bias-free ``nn.Dense``: an ``[in, out]`` kernel, applied in the
    input's dtype."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch_kernel_init(torch.empty(in_features, out_features)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel.to(x.dtype)


class BasisNet(nn.Module):
    """Polynomial features -> Linear -> GELU -> Linear -> GELU."""

    def __init__(self, in_features: int, hidden_dim: int, basis_dim: int, degree: int = 3):
        super().__init__()
        n_feat = sum(in_features**k for k in range(1, degree + 1))
        self.degree = degree
        self.layers = nn.ModuleList([TorchLinear(n_feat, hidden_dim),
                                     TorchLinear(hidden_dim, basis_dim)])

    def forward(self, attr: torch.Tensor) -> torch.Tensor:
        h = _gelu(self.layers[0](polynomial_features(attr, self.degree)))
        return _gelu(self.layers[1](h))


class FiberBundleConv(nn.Module):
    """The separable convolution on position-orientation space: a spatial
    kernel per edge and orientation, summed over senders, then a kernel over
    orientation pairs."""

    def __init__(self, channels: int, basis_dim: int):
        super().__init__()
        self.spatial = Dense(basis_dim, channels)  # flax Dense_0
        self.fiber = Dense(basis_dim, channels)  # flax Dense_1
        self.bias = nn.Parameter(torch.zeros(channels))
        for name in CALIB_STATS:
            self.register_buffer(name, torch.ones(()))
        self.measure = False  # set by calibrate_params for one forward pass
        self.measured: Optional[torch.Tensor] = None

    def forward(self, x, kernel_basis, fiber_kernel_basis, adj):
        """``x [B,N,O,C]``; ``kernel_basis [B,N,N,O,basis]`` (receiver,
        sender); ``fiber_kernel_basis [O,O,basis]``; ``adj [B,N,N]``."""
        num_ori = x.shape[-2]
        kernel = self.spatial(kernel_basis)  # [B,N,N,O,C]
        x1 = G.masked_segment_sum(kernel * x[:, None], adj)  # [B,N,O,C]
        x2 = torch.einsum("bnoc,opc->bnpc", x1, self.fiber(fiber_kernel_basis)) / num_ori
        if self.measure:  # population stds, as jnp.std
            self.measured = torch.stack([t.std(correction=0) for t in (x, x1, x2)])
        return x2 + self.bias.to(x.dtype)


class ConvNextBlock(nn.Module):
    """Convolution, LayerNorm, a widening MLP with GELU, the layer scale and
    the residual."""

    def __init__(self, channels: int, basis_dim: int, widening_factor: int = 4,
                 layer_scale: Optional[float] = 1e-6):
        super().__init__()
        self.conv = FiberBundleConv(channels, basis_dim)
        self.norm = LayerNorm(channels)
        self.mlp_in = TorchLinear(channels, widening_factor * channels)
        self.mlp_out = TorchLinear(widening_factor * channels, channels)
        if layer_scale is None:
            self.register_parameter("layer_scale", None)
        else:
            self.layer_scale = nn.Parameter(torch.full((channels,), float(layer_scale)))

    def forward(self, x, kernel_basis, fiber_kernel_basis, adj):
        out = self.conv(x, kernel_basis, fiber_kernel_basis, adj)
        out = self.mlp_out(_gelu(self.mlp_in(self.norm(out))))
        if self.layer_scale is not None:
            out = self.layer_scale.to(out.dtype) * out
        return out + x if out.shape == x.shape else out


class PONITA(nn.Module):
    """``forward(scene, mask, train=False) -> [B, N, 3 * out_channels_vec]``
    (pos_dt | vel).  The inputs are the mass (a scalar on every orientation)
    and the velocity (projected on each orientation).  ``train`` is taken for
    the JAX signature's sake: PONITA has no dropout."""

    def __init__(
        self,
        hidden_features: int = 128,
        num_layers: int = 8,
        num_ori: int = 20,
        basis_dim: int = 128,
        degree: int = 3,
        widening_factor: int = 4,
        layer_scale: Optional[float] = 1e-6,
        radius: Optional[float] = None,
        multiple_readouts: bool = True,
        out_channels_vec: int = 2,
    ):
        super().__init__()
        self.init_kwargs = {k: v for k, v in locals().items()
                            if k not in ("self", "__class__")}
        H = hidden_features
        self.hidden_features = H
        self.num_ori = num_ori
        self.radius = radius
        self.multiple_readouts = multiple_readouts
        self.out_channels_vec = out_channels_vec
        # flax _BasisNet_0 (spatial: inv1, inv2) and _BasisNet_1 (fiber: inv3)
        self.basis_nets = nn.ModuleList([BasisNet(2, H, basis_dim, degree),
                                         BasisNet(1, H, basis_dim, degree)])
        self.embedding = Dense(2, H)  # flax Dense_0, on [mass, vel . ori]
        scale = layer_scale if layer_scale else None
        self.blocks = nn.ModuleList(ConvNextBlock(H, basis_dim, widening_factor, scale)
                                    for _ in range(num_layers))
        self.readouts = nn.ModuleList(TorchLinear(H, out_channels_vec)
                                      for _ in range(num_layers if multiple_readouts else 1))
        self._grids = {}

    def orientations(self, like: torch.Tensor) -> torch.Tensor:
        """The ``[O, 3]`` grid on ``like``'s device in its dtype, made once."""
        key = (like.device, like.dtype)
        if key not in self._grids:
            self._grids[key] = torch.as_tensor(uniform_grid_s2(self.num_ori), dtype=like.dtype,
                                               device=like.device)
        return self._grids[key]

    def forward(self, scene: Scene, mask: torch.Tensor, train: bool = False) -> torch.Tensor:
        ori = self.orientations(scene.pos)
        O = ori.shape[0]
        adj = mask.transpose(1, 2).to(scene.dtype)  # adj[b, r, s] = mask[b, s, r]
        rel = -G.rel_positions(scene.pos)  # [b, r, s] = pos_s - pos_r

        # rotation-invariant attributes of each (edge, orientation) and orientation pair
        rel_e = rel[..., None, :]  # [B,N,N,1,3]
        inv1 = torch.sum(rel_e * ori, dim=-1, keepdim=True)  # [B,N,N,O,1]
        perp = rel_e - inv1 * ori
        inv2 = G.safe_sqrt(torch.sum(perp * perp, dim=-1, keepdim=True))
        inv3 = torch.sum(ori[:, None, :] * ori[None, :, :], dim=-1, keepdim=True)  # [O,O,1]

        kernel_basis = self.basis_nets[0](torch.cat([inv1, inv2], dim=-1))
        if self.radius is not None:
            dists = G.safe_sqrt(torch.sum(rel * rel, dim=-1, keepdim=True))
            kernel_basis = kernel_basis * G.polynomial_cutoff(dists, self.radius)[..., None, :]
        fiber_kernel_basis = self.basis_nets[1](inv3)

        # lift the inputs to the sphere: the mass on every orientation, the
        # velocity's projection on each
        mass = scene.mass
        scalar = mass[:, :, None, :].expand(mass.shape[:2] + (O, mass.shape[-1]))
        vec = torch.einsum("bnd,od->bno", scene.vel, ori)[..., None]
        x = self.embedding(torch.cat([scalar, vec], dim=-1))  # [B,N,O,H]

        readouts = []
        last = len(self.blocks) - 1
        for i, block in enumerate(self.blocks):
            x = block(x, kernel_basis, fiber_kernel_basis, adj)
            if self.multiple_readouts or i == last:
                readouts.append(self.readouts[len(readouts)](x))
        readout = sum(readouts) / len(readouts)  # [B,N,O,2]

        vecs = torch.einsum("bnoc,od->bncd", readout, ori) / O  # back from the sphere
        return vecs.reshape(vecs.shape[:2] + (3 * self.out_channels_vec,))

    def get_model_size(self) -> int:
        """Width used by the Noam LR schedule."""
        return self.hidden_features


@torch.no_grad()
def calibrate_params(model: PONITA, scene: Scene, mask: torch.Tensor) -> PONITA:
    """The one-time rescaling of the convolution kernels, in place: one forward
    pass (eval mode, no gradients) takes each convolution's ``std_in`` (of its
    input), ``std_1`` (after the spatial sum) and ``std_2`` (after the fiber
    product); then each spatial kernel is scaled by ``std_in / std_1`` and each
    fiber kernel by ``std_1 / std_2`` (a zero std leaves its kernel as it is).
    The statistics are kept in the convolutions' buffers.  One device-to-host
    fetch.  Returns ``model``."""
    convs = [block.conv for block in model.blocks]
    was_training = model.training
    model.eval()
    for conv in convs:
        conv.measure = True
    try:
        model(scene, mask)
    finally:
        for conv in convs:
            conv.measure = False
        model.train(was_training)
    stats = torch.stack([conv.measured for conv in convs]).to(torch.float64).cpu().tolist()
    for conv, (std_in, std_1, std_2) in zip(convs, stats):
        for name, value in zip(CALIB_STATS, (std_in, std_1, std_2)):
            getattr(conv, name).fill_(value)
        if std_1 > 0:
            conv.spatial.kernel.mul_(std_in / std_1)
        if std_2 > 0:
            conv.fiber.kernel.mul_(std_1 / std_2)
        conv.measured = None
    return model
