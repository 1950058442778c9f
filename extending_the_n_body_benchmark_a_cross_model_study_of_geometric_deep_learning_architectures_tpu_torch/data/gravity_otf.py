"""Fresh ground-truth gravity trajectories for self-feed evaluation.

The part of the JAX package's ``data/gravity_otf.py`` that the rollout needs:
``generate_trajectories`` and ``get_ground_truth_trajectories``, on the device
the caller names.  It writes nothing to disk.  The sha256 trajectory cache and
the frame-pair training queue come with the trainer, in a later slice.
"""

from __future__ import annotations

import random
from typing import Dict, Optional

import torch

from ..core.physics import GravityParams, sample_trajectory_batch
from ..core.targets import TARGETS


class GravityDatasetOtf:
    """Generator of fresh on-device trajectory batches."""

    def __init__(
        self,
        target: str = "pos_dt+vel",
        batch_size: int = 64,
        sim_length: int = 10000,
        sample_freq: int = 10,
        noise_var: float = 0.0,
        num_nodes: int = 5,
        interaction_strength: float = 2.0,
        dt: float = 0.01,
        softening: float = 0.2,
        double_precision: bool = False,
        seed: Optional[int] = None,
        device="cuda",
    ):
        if target not in TARGETS:
            raise ValueError(f"Wrong target {target}")
        self.target = target
        self.batch_size = batch_size
        self.sample_freq = sample_freq
        self.sim_length = sim_length - (sim_length % sample_freq)
        self.num_nodes = num_nodes
        self.dtype = torch.float64 if double_precision else torch.float32
        self.device = torch.device(device)
        self.params = GravityParams(
            interaction_strength=interaction_strength,
            softening=softening,
            dt=dt,
            noise_var=noise_var,
        )
        seed = seed if seed is not None else random.SystemRandom().randint(0, 2**31 - 1)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def generate_trajectories(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """``loc/vel/force [B, T, N, 3]`` and ``mass [B, N, 1]`` on the device."""
        loc, vel, force, mass = sample_trajectory_batch(
            batch_size,
            self.num_nodes,
            T=self.sim_length,
            sample_freq=self.sample_freq,
            params=self.params,
            dtype=self.dtype,
            device=self.device,
            generator=self.generator,
        )
        return {"loc": loc, "vel": vel, "force": force, "mass": mass}

    def get_ground_truth_trajectories(self, batch_size: Optional[int] = None):
        """Fresh GT rollout targets: ``(loc, vel, force, mass)``."""
        traj = self.generate_trajectories(batch_size or self.batch_size)
        return traj["loc"], traj["vel"], traj["force"], traj["mass"]
