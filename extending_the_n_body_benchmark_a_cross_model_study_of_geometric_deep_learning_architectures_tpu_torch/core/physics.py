"""Softened-gravity leapfrog physics on tensors.

Counterpart of the JAX package's ``core/physics.py``:

* ``compute_acceleration`` -- pairwise softened gravity; on a CUDA tensor it
  is kernel K2 (``ops/gravity.py``), on a CPU tensor its plain version.
* ``leapfrog_step`` -- one kick-drift-kick step.
* ``sample_initial_conditions`` -- CoM-frame random initial states.
* ``simulate`` / ``sample_trajectory_batch`` -- B independent trajectories,
  each frame saved *before* stepping, saved force = acc * mass, optional
  observation noise.  The JAX package nests two ``lax.scan``s; here, on the
  card, one launch of the integrator K2-leapfrog (``ops/gravity.py``) runs a
  whole batch where ``integrator_takes`` says so by shape, and elsewhere (N
  past its shared memory, or sims so large that K2 over the whole card is
  faster than a cluster of at most 16 blocks a sim) a Python loop runs one
  K2 launch (and the kicks around it) a substep.  The two give bitwise the same trajectories.
* ``energies`` -- kinetic / potential / total energy; ``energy_series`` --
  their batch means per frame, for rollout scoring.

Randomness comes from an explicit ``torch.Generator``; it does not give the
numbers ``jax.random`` gives for the same seed, so the parity tests feed both
packages the same initial states.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import _build
from ..ops.gravity import acceleration, integrator_takes, kick_drift_kick, leapfrog, leapfrog_loop


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
    return kick_drift_kick(pos, vel, acc, mass, params.interaction_strength, params.softening,
                           params.dt, compute_acceleration)


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
    On the card the rule is by shape (``integrator_takes``): the integrator
    or the loop of K2 launches; on the CPU both compute the plain loop.
    """
    args = (pos, vel, mass, T, sample_freq, params.interaction_strength, params.softening,
            params.dt)
    if not _build.wants_kernel(pos) or integrator_takes(pos.shape[0], pos.shape[-2],
                                                         _build.sm_count(pos)):
        loc_s, vel_s, force_s = leapfrog(*args)
    else:
        loc_s, vel_s, force_s = leapfrog_loop(*args, compute_acceleration)
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


def energy_series(loc, vel, G, softening) -> Dict[str, np.ndarray]:
    """Per-frame batch-mean energies for rollout scoring: unit masses, ``loc,
    vel [B, T, N, 3]`` (tensors or arrays) -> ``potential``, ``kinetic`` and
    ``total``, each a float64 ``[T]`` array.  The energies are computed in the
    input's dtype and averaged over sims in float64, as the JAX package does."""
    loc, vel = torch.as_tensor(loc), torch.as_tensor(vel)
    mass = torch.ones(loc.shape[:-1] + (1,), dtype=loc.dtype, device=loc.device)
    ke, pe, _ = energies(loc, vel, mass, G, softening)  # [B, T]
    ke = ke.cpu().numpy().astype(np.float64).mean(axis=0)
    pe = pe.cpu().numpy().astype(np.float64).mean(axis=0)
    return {"potential": pe, "kinetic": ke, "total": pe + ke}
