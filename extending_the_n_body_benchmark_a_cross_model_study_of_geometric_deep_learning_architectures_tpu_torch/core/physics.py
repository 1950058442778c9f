"""Softened-gravity leapfrog physics on tensors.

Counterpart of the JAX package's ``core/physics.py``:

* ``compute_acceleration`` -- pairwise softened gravity; on a CUDA tensor it
  is kernel K2 (``ops/gravity.py``), on a CPU tensor its plain version.
* ``leapfrog_step`` -- one kick-drift-kick step.
* ``sample_initial_conditions`` -- CoM-frame random initial states.
* ``simulate`` / ``sample_trajectory_batch`` -- B independent trajectories,
  each frame saved *before* stepping, saved force = acc * mass, optional
  observation noise.  The JAX package nests two ``lax.scan``s; here it is a
  Python loop over substeps whose every step is a few batched launches.
* ``energies`` -- kinetic / potential / total energy.

Randomness comes from an explicit ``torch.Generator``; it does not give the
numbers ``jax.random`` gives for the same seed, so the parity tests feed both
packages the same initial states.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.gravity import acceleration


class GravityParams(NamedTuple):
    """Physical constants of the simulator."""

    interaction_strength: float = 2.0  # "G"
    softening: float = 0.2
    dt: float = 0.01
    noise_var: float = 0.0


def compute_acceleration(pos: torch.Tensor, mass: torch.Tensor, G, softening) -> torch.Tensor:
    """``a_i = G * sum_j (r_j - r_i) / (|r_j - r_i|^2 + eps^2)^{3/2} * m_j``.

    ``pos [..., N, 3]``, ``mass [..., N, 1]`` -> ``[..., N, 3]``.
    """
    return acceleration(pos, mass, G, softening)


def leapfrog_step(pos, vel, acc, mass, params: GravityParams):
    """One kick-drift-kick step; returns ``(pos, vel, acc)``."""
    dt = params.dt
    vel = vel + acc * (dt / 2.0)
    pos = pos + vel * dt
    acc = compute_acceleration(pos, mass, params.interaction_strength, params.softening)
    vel = vel + acc * (dt / 2.0)
    return pos, vel, acc


def sample_initial_conditions(
    batch_size: int,
    n_bodies: int,
    dim: int = 3,
    dtype=torch.float32,
    device="cuda",
    generator: Optional[torch.Generator] = None,
):
    """Random CoM-frame initial states ``pos, vel [B, N, dim]``, ``mass [B, N, 1]``.

    Positions are standard normal scaled by ``cbrt(N/5)`` (the density of the
    5-body experiment); velocities standard normal, shifted to zero momentum.
    """
    shape = (batch_size, n_bodies, dim)
    std_dev = (n_bodies / 5.0) ** (1.0 / 3.0)
    pos = torch.randn(shape, dtype=dtype, device=device, generator=generator) * std_dev
    vel = torch.randn(shape, dtype=dtype, device=device, generator=generator)
    mass = torch.ones((batch_size, n_bodies, 1), dtype=dtype, device=device)
    vel = vel - torch.mean(mass * vel, dim=1, keepdim=True) / torch.mean(mass, dim=1, keepdim=True)
    return pos, vel, mass


def simulate(
    pos: torch.Tensor,
    vel: torch.Tensor,
    mass: torch.Tensor,
    T: int = 10000,
    sample_freq: int = 10,
    params: GravityParams = GravityParams(),
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Integrate ``T`` substeps from the given states ``[B, N, d]``.

    Returns ``loc, vel, force [B, T // sample_freq, N, d]``: frame ``k`` is the
    state after ``k * sample_freq`` substeps, and force is ``acc * mass``.
    Observation noise (``params.noise_var``) is drawn from ``generator``.
    """
    if T % sample_freq:
        raise ValueError(f"T={T} is not a multiple of sample_freq={sample_freq}")
    t_save = T // sample_freq
    B, N, d = pos.shape
    loc_s = torch.empty((B, t_save, N, d), dtype=pos.dtype, device=pos.device)
    vel_s = torch.empty_like(loc_s)
    force_s = torch.empty_like(loc_s)
    acc = compute_acceleration(pos, mass, params.interaction_strength, params.softening)
    for t in range(t_save):
        loc_s[:, t] = pos
        vel_s[:, t] = vel
        force_s[:, t] = acc * mass
        for _ in range(sample_freq):
            pos, vel, acc = leapfrog_step(pos, vel, acc, mass, params)
    if params.noise_var:
        for arr in (loc_s, vel_s, force_s):
            noise = torch.randn(arr.shape, dtype=arr.dtype, device=arr.device, generator=generator)
            arr += noise * params.noise_var
    return loc_s, vel_s, force_s


def sample_trajectory_batch(
    batch_size: int,
    n_bodies: int,
    T: int = 10000,
    sample_freq: int = 10,
    params: GravityParams = GravityParams(),
    dim: int = 3,
    dtype=torch.float32,
    device="cuda",
    generator: Optional[torch.Generator] = None,
):
    """``batch_size`` independent trajectories from random initial states:
    ``loc, vel, force [B, T // sample_freq, N, dim]`` and ``mass [B, N, 1]``."""
    pos, vel, mass = sample_initial_conditions(
        batch_size, n_bodies, dim, dtype, device, generator
    )
    loc, vel, force = simulate(pos, vel, mass, T, sample_freq, params, generator)
    return loc, vel, force, mass


def energies(pos, vel, mass, G, softening):
    """Kinetic, potential and total energy, each of shape ``[...]``.

    ``pos, vel [..., N, 3]``; ``mass [..., N, 1]`` (or broadcastable).
    """
    ke = 0.5 * torch.sum(mass * vel * vel, dim=(-1, -2))
    rel = pos[..., None, :, :] - pos[..., :, None, :]
    r = torch.sqrt(torch.sum(rel * rel, dim=-1) + softening**2)
    good = r > 0
    inv_r = torch.where(good, 1.0 / torch.where(good, r, torch.ones_like(r)), torch.zeros_like(r))
    n = pos.shape[-2]
    iu = torch.triu(torch.ones((n, n), dtype=torch.bool, device=pos.device), diagonal=1)
    mass = mass.expand(pos.shape[:-1] + (1,))
    mm = mass[..., :, 0, None] * mass[..., None, :, 0]
    pe = G * torch.sum(torch.where(iu, -mm * inv_r, torch.zeros_like(inv_r)), dim=(-1, -2))
    return ke, pe, ke + pe
