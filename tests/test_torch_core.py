"""The port's scene, targets, graph and physics against the JAX package, in float64.

Inputs are made with numpy from a seed and handed to both packages; both
compute in float64 (x64 is on for the test session), so agreement is to
rtol 1e-10 -- only summation order differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu.core import (
    graph as jgraph,
    physics as jphys,
    targets as jtargets,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.core import (
    graph as tgraph,
    physics as tphys,
    targets as ttargets,
)

RTOL = 1e-10


def _close(t, j, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


@pytest.fixture
def pos():
    return np.random.default_rng(0).normal(size=(3, 7, 3))


def test_rel_positions_and_sq_dists(pos):
    _close(tgraph.rel_positions(torch.from_numpy(pos)), jgraph.rel_positions(jnp.asarray(pos)))
    _close(tgraph.pairwise_sq_dists(torch.from_numpy(pos)),
           jgraph.pairwise_sq_dists(jnp.asarray(pos)))


@pytest.mark.parametrize("k", [1, 3, 6])
def test_knn_mask_matches(pos, k):
    got = tgraph.knn_mask(torch.from_numpy(pos), k).numpy()
    want = np.asarray(jgraph.knn_mask(jnp.asarray(pos), k))
    np.testing.assert_array_equal(got, want)
    assert got.sum(-1).min() == k and not got[:, np.arange(7), np.arange(7)].any()


def test_knn_mask_rejects_bad_k(pos):
    for k in (0, 7):
        with pytest.raises(ValueError):
            tgraph.knn_mask(torch.from_numpy(pos), k)


def test_fully_connected_mask():
    got = tgraph.fully_connected_mask(2, 5, device="cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(jgraph.fully_connected_mask(2, 5)))


def test_masked_segment_mean_and_safe_sqrt(pos):
    rng = np.random.default_rng(1)
    vals = rng.normal(size=(3, 7, 7, 4))
    mask = rng.random((3, 7, 7)) < 0.4
    mask[0, 2] = False  # a receiver with no senders divides by max(deg, 1)
    _close(tgraph.masked_segment_mean(torch.from_numpy(vals), torch.from_numpy(mask)),
           jgraph.masked_segment_mean(jnp.asarray(vals), jnp.asarray(mask)))
    x = np.array([0.0, 1e-30, 2.0, 9.0])
    _close(tgraph.safe_sqrt(torch.from_numpy(x)), jgraph.safe_sqrt(jnp.asarray(x)))


@pytest.mark.parametrize("target", [t for t in ttargets.TARGETS if t != "force"])
def test_decode_next_state(target):
    rng = np.random.default_rng(2)
    width = 3 if target == "pos" else 6
    arr, p, v = rng.normal(size=(2, 5, width)), rng.normal(size=(2, 5, 3)), rng.normal(size=(2, 5, 3))
    tp, tv = ttargets.decode_next_state(*(torch.from_numpy(a) for a in (arr, p, v)), target)
    jp, jv = jtargets.decode_next_state(*(jnp.asarray(a) for a in (arr, p, v)), target)
    _close(tp, jp)
    assert (tv is None) == (jv is None)
    if tv is not None:
        _close(tv, jv)


def test_targets_lists_and_force_refused():
    assert ttargets.TARGETS == jtargets.TARGETS
    assert ttargets.SELF_FEEDABLE == jtargets.SELF_FEEDABLE
    z = torch.zeros(1, 2, 6)
    with pytest.raises(ValueError):
        ttargets.decode_next_state(z, z[..., :3], z[..., :3], "force")


@pytest.mark.parametrize("softening", [0.2, 0.0])
def test_compute_acceleration_f64(pos, softening):
    mass = np.abs(np.random.default_rng(3).normal(size=(3, 7, 1))) + 0.5
    got = tphys.compute_acceleration(torch.from_numpy(pos), torch.from_numpy(mass), 2.0, softening)
    want = jphys.compute_acceleration(jnp.asarray(pos), jnp.asarray(mass), 2.0, softening)
    assert torch.isfinite(got).all()
    _close(got, want)


def test_leapfrog_step_and_energies(pos):
    rng = np.random.default_rng(4)
    vel, mass = rng.normal(size=pos.shape), np.ones(pos.shape[:-1] + (1,))
    params = tphys.GravityParams()
    tacc = tphys.compute_acceleration(torch.from_numpy(pos), torch.from_numpy(mass), 2.0, 0.2)
    jacc = jphys.compute_acceleration(jnp.asarray(pos), jnp.asarray(mass), 2.0, 0.2)
    got = tphys.leapfrog_step(torch.from_numpy(pos), torch.from_numpy(vel), tacc,
                              torch.from_numpy(mass), params)
    want = jphys.leapfrog_step(jnp.asarray(pos), jnp.asarray(vel), jacc, jnp.asarray(mass),
                               jphys.GravityParams())
    for g, w in zip(got, want):
        _close(g, w)
    for g, w in zip(tphys.energies(torch.from_numpy(pos), torch.from_numpy(vel),
                                   torch.from_numpy(mass), 2.0, 0.2),
                    jphys.energies(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass), 2.0, 0.2)):
        _close(g, w)


def test_leapfrog_trajectory_matches_from_identical_states():
    """50 substeps, a frame every 5, from the JAX package's own initial states."""
    B, N, T, freq = 2, 6, 50, 5
    params = jphys.GravityParams()
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    inits, want = [], []
    for k in keys:
        want.append(jphys.sample_trajectory(k, N, T, freq, params, 3, jnp.float64))
        _, init_key, _ = jax.random.split(k, 3)
        inits.append(jphys.sample_initial_conditions(init_key, N, 3, jnp.float64))
    pos, vel, mass = (torch.from_numpy(np.stack([np.asarray(i[c]) for i in inits])) for c in range(3))
    loc, v, force = tphys.simulate(pos, vel, mass, T, freq, tphys.GravityParams())
    assert loc.shape == (B, T // freq, N, 3)
    for got, c in ((loc, 0), (v, 1), (force, 2)):
        _close(got, np.stack([np.asarray(w[c]) for w in want]))


def test_sample_trajectory_batch_shapes_momentum_and_noise():
    gen = torch.Generator().manual_seed(0)
    loc, vel, force, mass = tphys.sample_trajectory_batch(
        3, 5, T=20, sample_freq=4, dtype=torch.float64, device="cpu", generator=gen)
    assert loc.shape == vel.shape == force.shape == (3, 5, 5, 3) and mass.shape == (3, 5, 1)
    # CoM frame: zero total momentum at frame 0 and after (leapfrog conserves it)
    assert torch.allclose((mass[:, None] * vel).sum(2), torch.zeros(3, 5, 3, dtype=torch.float64),
                          atol=1e-12)
    with pytest.raises(ValueError):
        tphys.simulate(loc[:, 0], vel[:, 0], mass, T=10, sample_freq=3)
    noisy = tphys.GravityParams(noise_var=0.1)
    gen = torch.Generator().manual_seed(0)
    nloc, _, _, _ = tphys.sample_trajectory_batch(
        3, 5, T=20, sample_freq=4, params=noisy, dtype=torch.float64, device="cpu", generator=gen)
    assert not torch.equal(nloc, loc) and (nloc - loc).abs().max() < 1.0

