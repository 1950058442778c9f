"""Dense graph geometry: ``[B, N, N]`` neighbour masks and masked reductions.

Counterpart of the JAX package's ``core/graph.py``.  ``mask[b, i, j]`` is True
iff the directed edge ``j -> i`` exists (receiver ``i``, sender ``j``).
"""

from __future__ import annotations

import math
from typing import Tuple

from .. import _tf32  # noqa: F401  (TF32 off before torch is used)
import torch


def pairwise_sq_dists(pos: torch.Tensor) -> torch.Tensor:
    """``[..., N, N]`` squared distances, ``d2[i, j] = |r_i - r_j|^2``."""
    rel = rel_positions(pos)
    return torch.sum(rel * rel, dim=-1)


def rel_positions(pos: torch.Tensor) -> torch.Tensor:
    """``rel[..., i, j, :] = pos_i - pos_j``: receiver minus sender."""
    return pos[..., :, None, :] - pos[..., None, :, :]


def knn_mask(pos: torch.Tensor, num_neighbors: int, rows: slice = slice(None)) -> torch.Tensor:
    """Bool ``[B, N, N]``: ``j`` is one of the ``num_neighbors`` nearest
    non-self nodes of ``i``.  ``num_neighbors == N - 1`` short-circuits to the
    fully connected pattern.  ``rows``: only those receivers' rows ``[B, n,
    N]``, with no ``[B, N, N]`` tensor made (each row's squared distances are
    the whole mask's, elementwise, and the same top-k picks its neighbours)."""
    n = pos.shape[-2]
    if not 0 < num_neighbors < n:
        raise ValueError(
            "Graph cannot have more neighbors than there are nodes in simulation - 1"
        )
    recv = torch.arange(n, device=pos.device)[rows]
    self_ = recv[:, None] == torch.arange(n, device=pos.device)  # [n, N]
    if num_neighbors == n - 1:
        return (~self_).expand(pos.shape[:-2] + self_.shape)
    rel = pos[..., rows, None, :] - pos[..., None, :, :]
    d2 = torch.sum(rel * rel, dim=-1).masked_fill(self_, float("inf"))
    idx = torch.topk(d2, num_neighbors, dim=-1, largest=False).indices
    mask = torch.zeros(d2.shape, dtype=torch.bool, device=pos.device)
    return mask.scatter_(-1, idx, True)


def fully_connected_mask(batch_size: int, n: int, device="cuda") -> torch.Tensor:
    """``[B, N, N]`` all-pairs-except-self mask."""
    eye = torch.eye(n, dtype=torch.bool, device=device)
    return (~eye).expand(batch_size, n, n)


def masked_segment_sum(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sum over senders ``j``: ``[B, N, N, ...] -> [B, N, ...]``."""
    m = mask.to(values.dtype)
    m = m.reshape(m.shape + (1,) * (values.ndim - m.ndim))
    return torch.sum(values * m, dim=2)


def masked_segment_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over senders ``j`` (``[B, N, N, ...] -> [B, N, ...]``), dividing
    by ``max(degree, 1)``."""
    m = mask.to(values.dtype)
    deg = torch.clamp(torch.sum(m, dim=2), min=1.0)  # [B, N]
    m = m.reshape(m.shape + (1,) * (values.ndim - m.ndim))
    deg = deg.reshape(deg.shape + (1,) * (values.ndim - 1 - deg.ndim))
    return torch.sum(values * m, dim=2) / deg


def safe_sqrt(x: torch.Tensor, eps: float = 1e-24) -> torch.Tensor:
    """sqrt with the argument clamped below at ``eps`` (finite gradient at 0)."""
    return torch.sqrt(torch.clamp(x, min=eps))


def safe_unit(vec: torch.Tensor, eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(unit, norm)``: unit vectors and their lengths, both zero where the
    length is at most ``eps``, with finite gradients at zero length (the
    square root never sees a zero)."""
    sq = torch.sum(vec * vec, dim=-1, keepdim=True)
    good = sq > eps * eps
    norm = torch.sqrt(torch.where(good, sq, torch.ones_like(sq)))
    unit = torch.where(good, vec / norm, torch.zeros_like(vec))
    return unit, torch.where(good, norm, torch.zeros_like(norm))[..., 0]


def gaussian_rbf(d: torch.Tensor, num_rbf: int, cutoff: float, start: float = 0.0) -> torch.Tensor:
    """Gaussian radial basis ``[..., num_rbf]``: centres on
    ``linspace(start, cutoff, num_rbf)``, the width the grid step."""
    offsets = torch.linspace(start, cutoff, num_rbf, dtype=d.dtype, device=d.device)
    step = (torch.abs(offsets[1] - offsets[0]) if num_rbf > 1
            else torch.tensor(cutoff - start, dtype=d.dtype, device=d.device))
    coeff = -0.5 / step**2
    diff = d[..., None] - offsets
    return torch.exp(coeff * diff * diff)


def cosine_cutoff(d: torch.Tensor, cutoff: float) -> torch.Tensor:
    """Behler's cosine window, zero from ``cutoff`` on."""
    vals = 0.5 * (torch.cos(d * math.pi / cutoff) + 1.0)
    return vals * (d < cutoff).to(d.dtype)


def polynomial_cutoff(d: torch.Tensor, cutoff: float, p: int = 6) -> torch.Tensor:
    """DimeNet's polynomial window of degree ``p``, zero from ``cutoff`` on
    (PONITA's spatial window)."""
    x = d / cutoff
    a = -(p + 1.0) * (p + 2.0) / 2.0
    b = p * (p + 2.0)
    c = -p * (p + 1.0) / 2.0
    out = 1.0 + a * x**p + b * x ** (p + 1) + c * x ** (p + 2)
    return out * (x < 1.0).to(d.dtype)
