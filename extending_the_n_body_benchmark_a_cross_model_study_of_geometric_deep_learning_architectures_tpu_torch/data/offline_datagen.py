"""Offline charged-systems datagen: isolated balls, rigid sticks and hinges.

Counterpart of the JAX package's ``data/offline_datagen.py``, with its
semantics:

* Coulomb ``q_i q_j / r^3`` forces, each component capped at ``0.1 / dt``;
* the density-scaled initial spread ``loc_std (N / 5)^(1/3) + 0.1``;
* a stick moves as its centre of mass plus an angular velocity integrated by
  a Rodrigues rotation;
* a hinge pivots on its node 0 with two constrained beams, the pivot's
  acceleration from a 3x3 solve;
* a frame is saved after the first step of each block of ``sample_freq``
  steps;
* the node blocks are contiguous: ``[isolated | stick pairs | hinge
  triples]``.

Where the JAX package vmaps one system over keys, a split's S systems run
here as one ``[S, N, 3]`` Euler loop on the tensors' device, every object
kind vectorised over its objects, free of host syncs.  The hinge's 3x3 solve
is the closed form ``adj(A) a / det(A)`` (``A = I + P1 + P2`` is symmetric
with eigenvalues in [1, 3]), elementwise on the device, where
``torch.linalg.solve`` would check for a singular matrix on the host each
step.

The sampler and the integrator are apart: :func:`integrate_systems` takes
given initial positions, velocities and charges, so that the tests can hand
it the JAX package's draws.  The draws come from an explicit
``torch.Generator``, one a split seeded from the dataset's seed
(:func:`split_generator`); they are not the numbers ``jax.random`` gives.

Files are the JAX package's layout, ``{loc,vel,edges,charges}_{split}_
charged<I>_<S>_<H><suffix>.npy`` and ``cfg_*.pkl``, float32 by default (what
the JAX package writes without x64).  Run on the card unless ``--device cpu``:

    python -m <package>.data.offline_datagen --n_isolated 3 --n_stick 2 --n_hinge 1
"""

from __future__ import annotations

import os
import pickle
from typing import NamedTuple, Optional, Tuple

import numpy as np
from .. import _tf32  # noqa: F401  (TF32 off before torch is used)
import torch

SPLITS = ("train", "valid", "test")


class OfflineParams(NamedTuple):
    delta_t: float = 0.001
    loc_std: float = 1.0
    vel_norm: float = 0.5
    interaction_strength: float = 1.0


def _dot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def _rotate(v, axis, theta):
    """``v [..., 3]`` turned by ``theta [..., 1]`` about the unit ``axis
    [..., 3]``: the Rodrigues matrix ``c I + s [k]x + (1 - c) k k^T`` applied
    to ``v``, without the matrix."""
    c = torch.cos(theta)
    return c * v + torch.sin(theta) * _cross(axis, v) + (1 - c) * _dot(axis, v) * axis


def _proj(va, vb):
    return _dot(va, vb) / _dot(vb, vb) * vb


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


# ------------------------------------------------------------ object updates


def _stick_init(x, v):
    """``x, v [..., 2, 3]`` -> the constraint-consistent ``v`` and the state
    ``(xc, vc, wc)``."""
    d = (x[..., 1, :] - x[..., 0, :])[..., None, :]
    pro = _proj(v, d)
    v = v - pro + pro.mean(dim=-2, keepdim=True)
    xc, vc = x.mean(dim=-2), v.mean(dim=-2)
    r0 = x[..., 0, :] - xc
    wc = _cross(r0, v[..., 0, :] - vc) / _dot(r0, r0)
    return v, (xc, vc, wc)


def _stick_update(x, v, f, state, dt):
    """One step of sticks ``x, v, f [..., 2, 3]``: the centre of mass moves
    with the mean force, the angular velocity with the torque over the moment
    of inertia, and the pair turns about it."""
    xc, vc, wc = state
    r = x - xc[..., None, :]
    vc = vc + f.mean(dim=-2) * dt
    xc = xc + vc * dt
    J = torch.sum(r * r, dim=(-2, -1))[..., None]
    wc = wc + (_cross(r, f).sum(dim=-2) / J) * dt
    w_norm = torch.sqrt(_dot(wc, wc) + 1e-30)
    w = wc[..., None, :]
    r_new = _rotate(r, w / w_norm[..., None, :], (w_norm * dt)[..., None, :])
    return xc[..., None, :] + r_new, vc[..., None, :] + _cross(w, r_new), (xc, vc, wc)


def _hinge_init(x, v):
    """``x, v [..., 3, 3]`` (the pivot first) -> the constraint-consistent
    ``v`` and the beams' angular velocities ``w [..., 2, 3]``."""
    d = x[..., 1:, :] - x[..., :1, :]
    v0 = v[..., :1, :]
    vb = _proj(v0, d) + (v[..., 1:, :] - _proj(v[..., 1:, :], d))
    w = _cross(d, vb - v0) / _dot(d, d)
    return torch.cat([v0, vb], dim=-2), w


def _solve3(A, a):
    """``A^-1 a`` for ``A [..., 3, 3]`` symmetric, by the adjugate."""
    c0, c1, c2 = A[..., 0, :], A[..., 1, :], A[..., 2, :]
    adj = torch.stack([_cross(c1, c2), _cross(c2, c0), _cross(c0, c1)], dim=-2)
    return torch.sum(adj * a[..., None, :], dim=-1) / _dot(c0, adj[..., 0, :])


def _hinge_update(x, v, f, w, dt):
    """One step of hinges ``x, v, f [..., 3, 3]`` with beam angular velocities
    ``w [..., 2, 3]``: the pivot's acceleration ``a0`` from ``(I + P1 + P2)
    a0 = sum f - sum w_b x v_0b - sum (I - P_b) f_b`` (``P_b`` the projector on
    beam b), then each beam turns about its updated angular velocity."""
    r = x[..., 1:, :] - x[..., :1, :]  # the beams [..., 2, 3]
    vr = v[..., 1:, :] - v[..., :1, :]
    fb = f[..., 1:, :]
    r2 = _dot(r, r)
    e = r / torch.sqrt(r2)
    A = torch.eye(3, dtype=x.dtype, device=x.device) + torch.sum(
        e[..., :, None] * e[..., None, :], dim=-3)
    a = f.sum(dim=-2) - torch.sum(_cross(w, vr) + fb - e * _dot(e, fb), dim=-2)
    a0 = _solve3(A, a)

    v0 = v[..., 0, :] + a0 * dt
    x0 = x[..., 0, :] + v0 * dt
    w = w + _cross(r, fb - a0[..., None, :]) / r2 * dt
    n = torch.sqrt(_dot(w, w) + 1e-30)
    rn = _rotate(r, w / n, n * dt)
    x_new = torch.cat([x0[..., None, :], x0[..., None, :] + rn], dim=-2)
    v_new = torch.cat([v0[..., None, :], v0[..., None, :] + _cross(w, rn)], dim=-2)
    return x_new, v_new, w


# ----------------------------------------------------------------- systems


def sample_initial_state(n_sims: int, n: int, params: OfflineParams = OfflineParams(),
                         generator: Optional[torch.Generator] = None, dtype=torch.float32,
                         device="cuda") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``n_sims`` systems' initial ``(X, V [S, N, 3], charges [S, N, 1])``:
    charges +-1 with probability 1/2 each, positions normal at the
    density-scaled spread, speeds ``vel_norm`` in random directions (before
    the constraints adjust them, in :func:`integrate_systems`)."""
    kw = dict(generator=generator, dtype=dtype, device=device)
    charges = torch.where(torch.rand((n_sims, n, 1), **kw) < 0.5, 1.0, -1.0).to(dtype)
    X = torch.randn((n_sims, n, 3), **kw) * (params.loc_std * (n / 5.0) ** (1.0 / 3.0) + 0.1)
    V = torch.randn((n_sims, n, 3), **kw)
    V = V / torch.linalg.vector_norm(V, dim=-1, keepdim=True) * params.vel_norm
    return X, V, charges


def integrate_systems(X: torch.Tensor, V: torch.Tensor, charges: torch.Tensor, n_isolated: int,
                      n_stick: int, n_hinge: int, T: int = 5000, sample_freq: int = 100,
                      params: OfflineParams = OfflineParams()):
    """S systems from initial ``X, V [S, N, 3]`` and ``charges [S, N, 1]``
    (nodes in blocks: isolated | sticks (pairs) | hinges (triples)): the
    constraints' initial velocities, then ``T // sample_freq`` blocks of
    ``sample_freq`` Euler steps, a frame saved after each block's first step.
    Returns ``(loc, vel [S, T // freq, N, 3], edges [S, N, N], charges)``."""
    S, n = X.shape[:2]
    if n != n_isolated + 2 * n_stick + 3 * n_hinge:
        raise ValueError(f"{n} nodes, but {n_isolated} isolated, {n_stick} sticks and "
                         f"{n_hinge} hinges")
    dt = params.delta_t
    max_f = 0.1 / dt
    edges = charges @ charges.transpose(1, 2)
    i0, i1 = n_isolated, n_isolated + 2 * n_stick
    fs_const = params.interaction_strength * edges

    X, V = X.clone(), V.clone()
    stick = hinge = None
    if n_stick:
        vs, stick = _stick_init(X[:, i0:i1].reshape(S, n_stick, 2, 3),
                                V[:, i0:i1].reshape(S, n_stick, 2, 3))
        V[:, i0:i1] = vs.reshape(S, -1, 3)
    if n_hinge:
        vh, hinge = _hinge_init(X[:, i1:].reshape(S, n_hinge, 3, 3),
                                V[:, i1:].reshape(S, n_hinge, 3, 3))
        V[:, i1:] = vh.reshape(S, -1, 3)

    def forces(X):
        # q_i q_j / r^3, 0 where r = 0 (the diagonal among them)
        rel = X[:, :, None, :] - X[:, None, :, :]
        r2 = torch.sum(rel * rel, dim=-1)
        pos = r2 > 0
        fs = fs_const * torch.where(pos, torch.where(pos, r2, 1.0) ** -1.5, 0.0)
        return torch.clamp(torch.sum(fs[..., None] * rel, dim=2), -max_f, max_f)

    def step(X, V, stick, hinge):
        F = forces(X)
        parts_x, parts_v = [], []
        if n_isolated:
            v_iso = V[:, :i0] + F[:, :i0] * dt
            parts_x.append(X[:, :i0] + v_iso * dt)
            parts_v.append(v_iso)
        if n_stick:
            xs, vs, stick = _stick_update(X[:, i0:i1].reshape(S, n_stick, 2, 3),
                                          V[:, i0:i1].reshape(S, n_stick, 2, 3),
                                          F[:, i0:i1].reshape(S, n_stick, 2, 3), stick, dt)
            parts_x.append(xs.reshape(S, -1, 3))
            parts_v.append(vs.reshape(S, -1, 3))
        if n_hinge:
            xh, vh, hinge = _hinge_update(X[:, i1:].reshape(S, n_hinge, 3, 3),
                                          V[:, i1:].reshape(S, n_hinge, 3, 3),
                                          F[:, i1:].reshape(S, n_hinge, 3, 3), hinge, dt)
            parts_x.append(xh.reshape(S, -1, 3))
            parts_v.append(vh.reshape(S, -1, 3))
        return torch.cat(parts_x, dim=1), torch.cat(parts_v, dim=1), stick, hinge

    frames = T // sample_freq
    locs = X.new_empty((S, frames, n, 3))
    vels = X.new_empty((S, frames, n, 3))
    for t in range(frames * sample_freq):
        X, V, stick, hinge = step(X, V, stick, hinge)
        if t % sample_freq == 0:
            locs[:, t // sample_freq] = X
            vels[:, t // sample_freq] = V
    return locs, vels, edges, charges


def split_generator(seed: int, split: int, device="cuda") -> torch.Generator:
    """The generator that draws split ``split`` (0 train, 1 valid, 2 test) of
    the dataset of ``seed``."""
    return torch.Generator(device=device).manual_seed(3 * seed + split)


def object_config(n_isolated: int, n_stick: int, n_hinge: int) -> dict:
    """The ``cfg_*.pkl`` entry of a system: each object's node indices."""
    cfg, idx = {}, 0
    if n_isolated:
        cfg["Isolated"] = [[i] for i in range(n_isolated)]
        idx = n_isolated
    if n_stick:
        cfg["Stick"] = [[idx + 2 * s, idx + 2 * s + 1] for s in range(n_stick)]
        idx += 2 * n_stick
    if n_hinge:
        cfg["Hinge"] = [[idx + 3 * h, idx + 3 * h + 1, idx + 3 * h + 2] for h in range(n_hinge)]
    return cfg


def generate_offline_dataset(
    path: str,
    n_isolated: int = 5,
    n_stick: int = 0,
    n_hinge: int = 0,
    num_train: int = 100,
    num_valid: int = 20,
    num_test: int = 20,
    length: int = 5000,
    length_test: int = 5000,
    sample_freq: int = 100,
    seed: int = 42,
    suffix: str = "",
    params: OfflineParams = OfflineParams(),
    device="cuda",
    dtype=torch.float32,
) -> str:
    """Write the three splits' npy / pkl files into ``path``; returns the tag
    ``_charged<I>_<S>_<H><suffix>``.  Each split draws its systems from its
    own generator (:func:`split_generator`); the splits of one length run
    through one integrator loop on ``device`` (all three at the default
    ``length == length_test``)."""
    os.makedirs(path, exist_ok=True)
    tag = f"_charged{n_isolated}_{n_stick}_{n_hinge}{suffix}"
    n = n_isolated + 2 * n_stick + 3 * n_hinge
    cfg_entry = object_config(n_isolated, n_stick, n_hinge)
    sims = dict(zip(SPLITS, (num_train, num_valid, num_test)))
    lengths = dict(zip(SPLITS, (length, length, length_test)))
    for T in sorted(set(lengths.values())):
        group = [s for s in SPLITS if lengths[s] == T]
        drawn = [sample_initial_state(sims[s], n, params,
                                      split_generator(seed, SPLITS.index(s), device), dtype, device)
                 for s in group]
        arrays = integrate_systems(*(torch.cat(a) for a in zip(*drawn)), n_isolated, n_stick,
                                   n_hinge, T, sample_freq, params)
        arrays = [a.cpu().numpy() for a in arrays]
        start = 0
        for split in group:
            stop = start + sims[split]
            for name, a in zip(("loc", "vel", "edges", "charges"), arrays):
                np.save(os.path.join(path, f"{name}_{split}{tag}.npy"), a[start:stop])
            with open(os.path.join(path, f"cfg_{split}{tag}.pkl"), "wb") as f:
                pickle.dump([cfg_entry] * sims[split], f)
            start = stop
    return tag


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="Generate the offline charged-systems dataset")
    p.add_argument("--path", default="datasets_offline/data")
    p.add_argument("--num-train", type=int, default=100)
    p.add_argument("--num-valid", type=int, default=20)
    p.add_argument("--num-test", type=int, default=20)
    p.add_argument("--length", type=int, default=5000)
    p.add_argument("--length_test", type=int, default=5000)
    p.add_argument("--sample-freq", type=int, default=100)
    p.add_argument("--n_isolated", type=int, default=5)
    p.add_argument("--n_stick", type=int, default=0)
    p.add_argument("--n_hinge", type=int, default=0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--suffix", default="")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    tag = generate_offline_dataset(
        a.path, a.n_isolated, a.n_stick, a.n_hinge, a.num_train, a.num_valid, a.num_test,
        a.length, a.length_test, a.sample_freq, a.seed, a.suffix, device=a.device)
    print(f"wrote dataset {tag} to {a.path}")


if __name__ == "__main__":
    main()
