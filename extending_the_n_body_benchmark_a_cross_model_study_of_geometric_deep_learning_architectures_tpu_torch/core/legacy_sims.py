"""Legacy NRI-style simulators: springs and charged particles.

Counterpart of the JAX package's ``core/legacy_sims.py``: the reference's
Euler integration with clipped forces, its initial wall clamp, the force cap
``0.1 / dt``, its edge and charge distributions and its ``T // sample_freq -
1`` frame layout.  Where the JAX package vmaps one sim over keys, a batch of S
sims runs here as one ``[S, N, dim]`` loop on the tensors' device, free of
host syncs.

The sampler and the integrator are apart: :func:`simulate` takes given
initial arrays and couplings, so that the tests can hand it the JAX
package's.  The samplers draw from an explicit ``torch.Generator``, which does
not give the numbers ``jax.random`` gives, so they are held to the JAX
package's by distribution.

Returned layout is the reference's, batched: ``loc``/``vel`` ``[S, T_save,
dim, N]``, the ``[S, N, N]`` edges (springs) or the ``[S, N, 1]`` charges.  The
JAX package's one-sim forms are the batch of one.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch


class SpringParams(NamedTuple):
    box_size: float = 5.0
    loc_std: float = 0.5
    vel_norm: float = 0.5
    interaction_strength: float = 0.1
    noise_var: float = 0.0
    dt: float = 0.001


class ChargedParams(NamedTuple):
    box_size: float = 5.0
    loc_std: float = 1.0
    vel_norm: float = 0.5
    interaction_strength: float = 1.0
    noise_var: float = 0.0
    dt: float = 0.001


def _clamp(loc, vel, box):
    """Elastic wall reflection."""
    over = loc > box
    loc = torch.where(over, 2 * box - loc, loc)
    vel = torch.where(over, -vel.abs(), vel)
    under = loc < -box
    loc = torch.where(under, -2 * box - loc, loc)
    vel = torch.where(under, vel.abs(), vel)
    return loc, vel


def _pair_force(loc, forces_size, max_f):
    """``F_i = sum_j forces_size[i, j] (r_i - r_j)``, each component capped;
    ``loc [S, N, d]``, ``forces_size [S, N, N]``."""
    rel = loc[:, :, None, :] - loc[:, None, :, :]
    return torch.clamp(torch.sum(forces_size[..., None] * rel, dim=2), -max_f, max_f)


def simulate(loc0: torch.Tensor, vel0: torch.Tensor,
             forces_size_fn: Callable[[torch.Tensor], torch.Tensor], params, T: int,
             sample_freq: int, generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The shared Euler loop from initial ``loc0``, ``vel0 [S, N, d]``, with
    ``forces_size_fn(loc) -> [S, N, N]``: after an initial kick ``vel +=
    dt F(loc0)``, each iteration drifts ``loc += dt vel``, saves ``(loc, vel)``
    every ``sample_freq``-th iteration (before this iteration's kick), then
    kicks ``vel += dt F(loc)``.  The reference's first save overwrites its
    initial frame, so the initial state never appears: ``T // sample_freq - 1``
    frames.  ``noise_var`` adds Gaussian noise drawn from ``generator``.
    Returns ``(loc, vel)`` ``[S, T_save, d, N]``."""
    dt = params.dt
    max_f = 0.1 / dt
    t_save = T // sample_freq - 1
    S, n, d = loc0.shape
    locs = loc0.new_empty((S, t_save, n, d))
    vels = loc0.new_empty((S, t_save, n, d))
    loc = loc0
    vel = vel0 + dt * _pair_force(loc0, forces_size_fn(loc0), max_f)
    for i in range(1, t_save * sample_freq + 1):
        loc = loc + dt * vel
        if i % sample_freq == 0:
            locs[:, i // sample_freq - 1] = loc
            vels[:, i // sample_freq - 1] = vel
        vel = vel + dt * _pair_force(loc, forces_size_fn(loc), max_f)
    if params.noise_var:
        locs = locs + torch.randn(locs.shape, generator=generator, dtype=locs.dtype,
                                  device=locs.device) * params.noise_var
        vels = vels + torch.randn(vels.shape, generator=generator, dtype=vels.dtype,
                                  device=vels.device) * params.noise_var
    return locs.transpose(2, 3), vels.transpose(2, 3)


def charged_forces(edges: torch.Tensor, interaction_strength: float):
    """``forces_size_fn`` of the charged sims: the Coulomb ``q_i q_j / r^3``
    kernel from ``edges = q q^T [S, N, N]``, 0 where r = 0 (the diagonal among
    them)."""
    strength = interaction_strength * edges

    def forces(loc):
        rel = loc[:, :, None, :] - loc[:, None, :, :]
        r2 = torch.sum(rel * rel, dim=-1)
        pos = r2 > 0
        return strength * torch.where(pos, torch.where(pos, r2, 1.0) ** -1.5, 0.0)

    return forces


def _choose(values, probs, shape, generator, dtype, device):
    """Draws of ``values`` with probabilities ``probs``, by inverse CDF."""
    cdf = torch.cumsum(torch.tensor(probs, dtype=torch.float64, device=device), 0)
    u = torch.rand(shape, generator=generator, dtype=torch.float64, device=device)
    idx = torch.clamp(torch.searchsorted(cdf, u, right=True), max=len(values) - 1)
    return torch.tensor(values, dtype=dtype, device=device)[idx]


def _initial(S, n, dim, loc_std, params, generator, dtype, device):
    loc0 = torch.randn((S, n, dim), generator=generator, dtype=dtype, device=device) * loc_std
    vel0 = torch.randn((S, n, dim), generator=generator, dtype=dtype, device=device)
    vel0 = vel0 * params.vel_norm / torch.linalg.vector_norm(vel0, dim=-1, keepdim=True)
    return _clamp(loc0, vel0, params.box_size)


def spring_initial(batch_size: int, n_balls: int = 5, params: SpringParams = SpringParams(),
                   dim: int = 3, generator: Optional[torch.Generator] = None,
                   dtype=torch.float32, device="cuda"):
    """The spring sampler's draws: ``(loc0, vel0 [S, N, dim], edges [S, N, N])``;
    spring constants from {0, 0.5, 1} with probabilities (0.5, 0, 0.5),
    symmetrised, zero diagonal; positions and speeds clamped to the box."""
    S = batch_size
    edges = _choose((0.0, 0.5, 1.0), (0.5, 0.0, 0.5), (S, n_balls, n_balls), generator, dtype,
                    device)
    edges = torch.tril(edges) + torch.tril(edges, -1).transpose(1, 2)
    edges = edges * (1.0 - torch.eye(n_balls, dtype=dtype, device=device))
    return (*_initial(S, n_balls, dim, params.loc_std, params, generator, dtype, device), edges)


def charged_initial(batch_size: int, n_balls: int = 5, params: ChargedParams = ChargedParams(),
                    dim: int = 3, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
    """The charged sampler's draws: ``(loc0, vel0 [S, N, dim], edges [S, N, N],
    charges [S, N, 1])``; charges +-1 with probability 1/2 each, ``edges = q
    q^T``, the density-scaled ``loc_std (N / 5)^(1/3)``."""
    S = batch_size
    charges = _choose((-1.0, 0.0, 1.0), (0.5, 0.0, 0.5), (S, n_balls, 1), generator, dtype,
                      device)
    loc_std = params.loc_std * (n_balls / 5.0) ** (1.0 / 3.0)
    loc0, vel0 = _initial(S, n_balls, dim, loc_std, params, generator, dtype, device)
    return loc0, vel0, charges @ charges.transpose(1, 2), charges


def sample_spring_batch(batch_size: int, n_balls: int = 5, T: int = 10000,
                        sample_freq: int = 10, params: SpringParams = SpringParams(),
                        dim: int = 3, generator: Optional[torch.Generator] = None,
                        dtype=torch.float32, device="cuda"):
    """``batch_size`` spring sims (:func:`spring_initial`, then
    :func:`simulate`): ``(loc, vel [S, T_save, dim, N], edges [S, N, N])``."""
    loc0, vel0, edges = spring_initial(batch_size, n_balls, params, dim, generator, dtype,
                                       device)
    forces = -params.interaction_strength * edges
    loc, vel = simulate(loc0, vel0, lambda loc: forces, params, T, sample_freq, generator)
    return loc, vel, edges


def sample_charged_batch(batch_size: int, n_balls: int = 5, T: int = 10000,
                         sample_freq: int = 10, params: ChargedParams = ChargedParams(),
                         dim: int = 3, generator: Optional[torch.Generator] = None,
                         dtype=torch.float32, device="cuda"):
    """``batch_size`` charged sims (:func:`charged_initial`, then
    :func:`simulate`): ``(loc, vel [S, T_save, dim, N], edges [S, N, N],
    charges [S, N, 1])``."""
    loc0, vel0, edges, charges = charged_initial(batch_size, n_balls, params, dim, generator,
                                                 dtype, device)
    loc, vel = simulate(loc0, vel0, charged_forces(edges, params.interaction_strength), params,
                        T, sample_freq, generator)
    return loc, vel, edges, charges

