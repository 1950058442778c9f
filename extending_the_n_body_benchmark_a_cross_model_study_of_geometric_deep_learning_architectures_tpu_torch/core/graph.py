"""Dense graph geometry: ``[B, N, N]`` neighbour masks and masked reductions.

Counterpart of the JAX package's ``core/graph.py``.  ``mask[b, i, j]`` is True
iff the directed edge ``j -> i`` exists (receiver ``i``, sender ``j``).
"""

from __future__ import annotations

import torch


def pairwise_sq_dists(pos: torch.Tensor) -> torch.Tensor:
    """``[..., N, N]`` squared distances, ``d2[i, j] = |r_i - r_j|^2``."""
    rel = rel_positions(pos)
    return torch.sum(rel * rel, dim=-1)


def rel_positions(pos: torch.Tensor) -> torch.Tensor:
    """``rel[..., i, j, :] = pos_i - pos_j``: receiver minus sender."""
    return pos[..., :, None, :] - pos[..., None, :, :]


def knn_mask(pos: torch.Tensor, num_neighbors: int) -> torch.Tensor:
    """Bool ``[B, N, N]``: ``j`` is one of the ``num_neighbors`` nearest
    non-self nodes of ``i``.  ``num_neighbors == N - 1`` short-circuits to the
    fully connected pattern."""
    n = pos.shape[-2]
    if not 0 < num_neighbors < n:
        raise ValueError(
            "Graph cannot have more neighbors than there are nodes in simulation - 1"
        )
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    if num_neighbors == n - 1:
        return (~eye).expand(pos.shape[:-1] + (n,))
    d2 = pairwise_sq_dists(pos).masked_fill(eye, float("inf"))
    idx = torch.topk(d2, num_neighbors, dim=-1, largest=False).indices
    mask = torch.zeros(d2.shape, dtype=torch.bool, device=pos.device)
    return mask.scatter_(-1, idx, True)


def fully_connected_mask(batch_size: int, n: int, device="cuda") -> torch.Tensor:
    """``[B, N, N]`` all-pairs-except-self mask."""
    eye = torch.eye(n, dtype=torch.bool, device=device)
    return (~eye).expand(batch_size, n, n)


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
