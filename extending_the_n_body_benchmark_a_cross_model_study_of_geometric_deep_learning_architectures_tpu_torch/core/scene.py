"""The dense scene struct: a batch of B independent N-body systems.

Counterpart of the JAX package's ``core/scene.py``: ``[B, N, ...]`` tensors
instead of edge-indexed graphs; the topology is a ``[B, N, N]`` neighbour mask
(``core/graph.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class Scene:
    """``pos``, ``vel``, ``force`` ``[B, N, 3]``, ``mass`` ``[B, N, 1]`` and
    optional ``charge`` ``[B, N, 1]`` (the offline charged dataset's).
    ``force`` may be zeros during rollout: the model is never asked to
    predict it."""

    pos: torch.Tensor
    vel: torch.Tensor
    force: torch.Tensor
    mass: torch.Tensor
    charge: Optional[torch.Tensor] = None

    @property
    def dtype(self) -> torch.dtype:
        return self.pos.dtype

    @property
    def device(self) -> torch.device:
        return self.pos.device

    @classmethod
    def stationary(cls, batch_size: int, num_bodies: int, dtype=torch.float32,
                   device="cuda") -> "Scene":
        """All-zero scene with unit masses, for shape checks."""
        z = torch.zeros((batch_size, num_bodies, 3), dtype=dtype, device=device)
        m = torch.ones((batch_size, num_bodies, 1), dtype=dtype, device=device)
        return cls(pos=z, vel=z, force=z, mass=m)

    def astype(self, dtype) -> "Scene":
        return Scene(pos=self.pos.to(dtype), vel=self.vel.to(dtype), force=self.force.to(dtype),
                     mass=self.mass.to(dtype),
                     charge=None if self.charge is None else self.charge.to(dtype))
