"""The legacy spring and charged-particle sims of the port against the JAX package's.

* The integrator (``core/legacy_sims.py:simulate``) from the JAX package's own
  initial arrays and couplings (drawn here from the JAX sampler's key as the
  sampler draws them) gives the JAX sampler's trajectories in float64, within
  1e-10 of the largest value, one sim and a vmapped batch, springs and
  charges.
* It keeps the reference's save / kick order: equal, to 1e-12, to the
  literal numpy transcription of ``tests/test_legacy_sims.py``.
* The samplers draw what the JAX samplers draw, by distribution: the
  coupling and charge values and their frequencies, and two-sample KS tests
  of the first frame's positions and speeds (p >= 0.01 each, fixed seeds).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

TPU = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu"
JL = importlib.import_module(TPU + ".core.legacy_sims")
PL = importlib.import_module(TPU + "_torch.core.legacy_sims")

RTOL = 1e-10


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _jax_spring_draws(key, n, dim=3, params=JL.SpringParams()):
    """The JAX spring sampler's initial arrays and couplings for ``key``."""
    k_e, k_l, k_v, _ = jax.random.split(key, 4)
    idx = jax.random.choice(k_e, 3, (n, n), p=jnp.asarray([0.5, 0.0, 0.5]))
    edges = jnp.asarray([0.0, 0.5, 1.0])[idx]
    edges = (jnp.tril(edges) + jnp.tril(edges, -1).T) * (1.0 - jnp.eye(n))
    loc0 = jax.random.normal(k_l, (n, dim)) * params.loc_std
    vel0 = jax.random.normal(k_v, (n, dim))
    vel0 = vel0 * params.vel_norm / jnp.linalg.norm(vel0, axis=-1, keepdims=True)
    loc0, vel0 = JL._clamp(loc0, vel0, params.box_size)
    return np.asarray(loc0), np.asarray(vel0), np.asarray(edges)


def _jax_charged_draws(key, n, dim=3, params=JL.ChargedParams()):
    k_c, k_l, k_v, _ = jax.random.split(key, 4)
    charges = jnp.asarray([-1.0, 0.0, 1.0])[
        jax.random.choice(k_c, 3, (n, 1), p=jnp.asarray([0.5, 0.0, 0.5]))]
    loc0 = jax.random.normal(k_l, (n, dim)) * (params.loc_std * (n / 5.0) ** (1.0 / 3.0))
    vel0 = jax.random.normal(k_v, (n, dim))
    vel0 = vel0 * params.vel_norm / jnp.linalg.norm(vel0, axis=-1, keepdims=True)
    loc0, vel0 = JL._clamp(loc0, vel0, params.box_size)
    return np.asarray(loc0), np.asarray(vel0), np.asarray(charges)


def _port_spring(draws, T, freq, params=PL.SpringParams()):
    loc0, vel0, edges = (torch.from_numpy(np.stack(a)) for a in zip(*draws))
    fs = -params.interaction_strength * edges
    return PL.simulate(loc0, vel0, lambda loc: fs, params, T, freq)


def _port_charged(draws, T, freq, params=PL.ChargedParams()):
    loc0, vel0, charges = (torch.from_numpy(np.stack(a)) for a in zip(*draws))
    edges = charges @ charges.transpose(1, 2)
    return PL.simulate(loc0, vel0, PL.charged_forces(edges, params.interaction_strength),
                       params, T, freq)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("n", [5, 8])
def test_spring_integrator_matches_jax(seed, n):
    key = jax.random.PRNGKey(seed)
    want_loc, want_vel, want_edges = JL.sample_spring_trajectory(key, n_balls=n, T=500,
                                                                 sample_freq=10)
    draws = _jax_spring_draws(key, n)
    np.testing.assert_array_equal(draws[2], np.asarray(want_edges))
    loc, vel = _port_spring([draws], 500, 10)
    assert loc.shape == (1, 49, 3, n) and loc.dtype == torch.float64
    assert _rel(loc[0], want_loc) <= RTOL and _rel(vel[0], want_vel) <= RTOL


@pytest.mark.parametrize("seed", [1, 4])
@pytest.mark.parametrize("n", [5, 8])
def test_charged_integrator_matches_jax(seed, n):
    key = jax.random.PRNGKey(seed)
    want = JL.sample_charged_trajectory(key, n_balls=n, T=500, sample_freq=10)
    draws = _jax_charged_draws(key, n)
    np.testing.assert_array_equal(draws[2], np.asarray(want[3]))
    loc, vel = _port_charged([draws], 500, 10)
    assert _rel(loc[0], want[0]) <= RTOL and _rel(vel[0], want[1]) <= RTOL


@pytest.mark.parametrize("kind", ["spring", "charged"])
def test_batched_integrator_matches_the_jax_vmap(kind):
    key = jax.random.PRNGKey(9)
    S, n = 4, 5
    if kind == "spring":
        want = JL.sample_spring_batch(key, S, n_balls=n, T=300, sample_freq=10)
        draws = [_jax_spring_draws(k, n) for k in jax.random.split(key, S)]
        got = _port_spring(draws, 300, 10)
    else:
        want = JL.sample_charged_batch(key, S, n_balls=n, T=300, sample_freq=10)
        draws = [_jax_charged_draws(k, n) for k in jax.random.split(key, S)]
        got = _port_charged(draws, 300, 10)
    assert got[0].shape == (S, 29, 3, n)
    for g, w in zip(got, want[:2]):
        assert _rel(g, w) <= RTOL


def _numpy_euler_reference(loc0, vel0, forces_size_fn, dt, T, freq, max_f):
    """The reference's save / kick order, literally (``tests/test_legacy_sims.py``)."""
    t_save = T // freq - 1
    locs = np.zeros((t_save,) + loc0.shape)
    vels = np.zeros_like(locs)
    loc, vel = loc0.copy(), vel0.copy()

    def pair_force(loc):
        rel = loc[:, None, :] - loc[None, :, :]
        F = (forces_size_fn(loc)[..., None] * rel).sum(axis=1)
        return np.clip(F, -max_f, max_f)

    counter = 0
    vel = vel + dt * pair_force(loc)
    for i in range(1, T):
        loc = loc + dt * vel
        if i % freq == 0:
            locs[counter], vels[counter] = loc, vel
            counter += 1
        vel = vel + dt * pair_force(loc)
    return locs, vels


def test_simulate_keeps_the_references_order():
    rng = np.random.default_rng(0)
    n, T, freq = 4, 200, 10
    loc0, vel0 = rng.normal(size=(n, 3)) * 0.5, rng.normal(size=(n, 3)) * 0.5
    edges = rng.choice([0.0, 0.5, 1.0], size=(n, n))
    edges = np.tril(edges) + np.tril(edges, -1).T
    np.fill_diagonal(edges, 0.0)
    params = PL.SpringParams()
    fs = -params.interaction_strength * edges
    want_loc, want_vel = _numpy_euler_reference(loc0, vel0, lambda loc: fs, params.dt, T, freq,
                                                0.1 / params.dt)
    fs_t = torch.from_numpy(fs)[None]
    got_loc, got_vel = PL.simulate(torch.from_numpy(loc0)[None], torch.from_numpy(vel0)[None],
                                   lambda loc: fs_t, params, T, freq)
    np.testing.assert_allclose(got_loc[0].numpy(), want_loc.swapaxes(1, 2), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_vel[0].numpy(), want_vel.swapaxes(1, 2), rtol=0, atol=1e-12)


def test_noise_is_drawn_from_the_generator():
    params = PL.ChargedParams(noise_var=0.1)
    runs = [PL.sample_charged_batch(2, 5, T=100, sample_freq=10, params=params,
                                    generator=torch.Generator().manual_seed(s), device="cpu")
            for s in (5, 5, 6)]
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert not torch.equal(runs[0][0], runs[2][0])


S_DIST = 400


def test_the_spring_samplers_draw_the_same_distribution():
    jloc, _, jedges = JL.sample_spring_batch(jax.random.PRNGKey(21), S_DIST, n_balls=5, T=20,
                                             sample_freq=10)
    tloc, tvel, tedges = PL.sample_spring_batch(S_DIST, 5, T=20, sample_freq=10,
                                                generator=torch.Generator().manual_seed(21),
                                                device="cpu")
    assert tloc.shape == (S_DIST, 1, 3, 5) and tloc.dtype == torch.float32
    te = tedges.numpy()
    np.testing.assert_array_equal(te, te.transpose(0, 2, 1))
    assert np.all(np.diagonal(te, axis1=1, axis2=2) == 0)
    assert set(np.unique(te)) == set(np.unique(np.asarray(jedges))) == {0.0, 1.0}
    off = ~np.eye(5, dtype=bool)
    assert abs(te[:, off].mean() - 0.5) < 0.03
    assert stats.ks_2samp(tloc.numpy().ravel(), np.asarray(jloc).ravel()).pvalue >= 0.01


def test_the_charged_samplers_draw_the_same_distribution():
    jloc, jvel, jedges, jq = JL.sample_charged_batch(jax.random.PRNGKey(22), S_DIST, n_balls=5,
                                                     T=20, sample_freq=10)
    tloc, tvel, tedges, tq = PL.sample_charged_batch(S_DIST, 5, T=20, sample_freq=10,
                                                     generator=torch.Generator().manual_seed(22),
                                                     device="cpu")
    q = tq.numpy()
    assert set(np.unique(q)) == set(np.unique(np.asarray(jq))) == {-1.0, 1.0}
    assert abs(q.mean()) < 0.05
    np.testing.assert_array_equal(tedges.numpy(), q @ q.transpose(0, 2, 1))
    assert stats.ks_2samp(tloc.numpy().ravel(), np.asarray(jloc).ravel()).pvalue >= 0.01
    speed = lambda v: np.linalg.norm(np.asarray(v)[:, 0], axis=1).ravel()  # noqa: E731
    assert stats.ks_2samp(speed(tvel.numpy()), speed(jvel)).pvalue >= 0.01


@pytest.mark.parametrize("kind", ["spring", "charged"])
def test_the_batch_samplers_give_the_references_layout(kind):
    sample = PL.sample_spring_batch if kind == "spring" else PL.sample_charged_batch
    out = sample(3, 5, T=100, sample_freq=10, generator=torch.Generator().manual_seed(3),
                 device="cpu")
    assert out[0].shape == out[1].shape == (3, 9, 3, 5) and out[2].shape == (3, 5, 5)
    assert all(bool(torch.isfinite(t).all()) for t in out)
    if kind == "charged":
        assert out[3].shape == (3, 5, 1)
