"""The dense scene struct: a batch of B independent N-body systems.

Counterpart of the JAX package's ``core/scene.py``: ``[B, N, ...]`` tensors
instead of edge-indexed graphs; the topology is a ``[B, N, N]`` neighbour mask
(``core/graph.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Scene:
    """``pos``, ``vel``, ``force`` ``[B, N, 3]`` and ``mass`` ``[B, N, 1]``.
    ``force`` may be zeros during rollout: the model is never asked to
    predict it."""

    pos: torch.Tensor
    vel: torch.Tensor
    force: torch.Tensor
    mass: torch.Tensor

    @property
    def dtype(self) -> torch.dtype:
        return self.pos.dtype

    @property
    def device(self) -> torch.device:
        return self.pos.device
