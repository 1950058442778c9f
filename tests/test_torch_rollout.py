"""EGNN-MC forward and self-feed rollout of the port against the JAX package.

Random flax params of a small EGNN-MC (2 layers, width 16) are carried across
with ``weights.params_from_jax``; both packages then run in float64 on the
same scene (x64 is on for the test session).  Forward outputs agree to 1e-10
and 20-step closed-loop trajectories to 1e-8 (the rollout amplifies the
last-bit differences of another summation order), with equal ``survived``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu.core import (
    graph as jgraph,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu.core.scene import (
    Scene as JScene,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu.models import (
    create_model as jcreate,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu.rollout import (
    make_rollout_fn as jmake_rollout,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.core import (
    graph as tgraph,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.core.scene import (
    Scene,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.data.gravity_otf import (
    GravityDatasetOtf,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.models import (
    create_model,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.rollout.self_feed import (
    make_rollout_fn,
    run_self_feed,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.weights import (
    params_from_jax,
)

SMALL = dict(num_layers=2, hidden_node_dim=16, hidden_edge_dim=16, hidden_coord_dim=16)
B, N = 3, 8


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(B, N, 3)) * (N / 5.0) ** (1 / 3)
    vel = rng.normal(size=(B, N, 3))
    mass = np.ones((B, N, 1))
    return pos, vel, np.zeros_like(pos), mass


def _pair():
    """A JAX EGNN-MC with random params and the port's model carrying them."""
    pos, vel, force, mass = _arrays()
    jmodel = jcreate("egnn_mc", **SMALL)
    js = JScene(*(jnp.asarray(a) for a in (pos, vel, force, mass)))
    params = jmodel.init(jax.random.PRNGKey(3), js, jgraph.knn_mask(js.pos, N - 1))
    params = jax.tree_util.tree_map(np.asarray, params)
    tmodel = create_model("egnn_mc", device="cpu", dtype=torch.float64, **SMALL)
    tmodel.load_state_dict(params_from_jax(params))
    return jmodel, params, tmodel


@pytest.mark.parametrize("k", [N - 1, 3])
def test_egnn_forward_matches_f64(k):
    jmodel, params, tmodel = _pair()
    arrs = _arrays(seed=1)
    js = JScene(*(jnp.asarray(a) for a in arrs))
    ts = Scene(*(torch.from_numpy(a) for a in arrs))
    want = np.asarray(jmodel.apply(params, js, jgraph.knn_mask(js.pos, k)))
    with torch.no_grad():
        got = tmodel(ts, tgraph.knn_mask(ts.pos, k)).numpy()
    assert got.shape == (B, N, 6)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("num_neighbors", [None, 3])
def test_self_feed_rollout_matches_f64(num_neighbors):
    jmodel, params, tmodel = _pair()
    arrs = _arrays(seed=2)
    jloc, jvel, jsurv = jmake_rollout(jmodel, 21, num_neighbors=num_neighbors)(
        params, JScene(*(jnp.asarray(a) for a in arrs)))
    loc, vel, surv = make_rollout_fn(tmodel, 21, num_neighbors=num_neighbors)(
        Scene(*(torch.from_numpy(a) for a in arrs)))
    assert loc.shape == (B, 21, N, 3)
    np.testing.assert_allclose(loc.numpy(), np.asarray(jloc), rtol=0, atol=1e-8)
    np.testing.assert_allclose(vel.numpy(), np.asarray(jvel), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(surv.numpy(), np.asarray(jsurv))


class Exploder(torch.nn.Module):
    """Multiplies positions by 100 each step -> explodes quickly."""

    def forward(self, scene, mask):
        return torch.cat([scene.pos * 99.0, scene.vel], dim=-1)


class JExploder(fnn.Module):
    @fnn.compact
    def __call__(self, scene, mask, train=False):
        return jnp.concatenate([scene.pos * 99.0, scene.vel], axis=-1)


def test_explosion_freeze_and_steps_survived():
    arrs = [a.astype(np.float32) for a in _arrays(seed=4)]
    loc, _, surv = make_rollout_fn(Exploder(), 50)(Scene(*(torch.from_numpy(a) for a in arrs)))
    sv = surv.numpy()
    assert np.all(sv < 49)
    loc = loc.numpy()
    for b in range(B):
        np.testing.assert_array_equal(loc[b, sv[b] + 1], loc[b, -1])
    assert np.isfinite(loc).all()
    js = JScene(*(jnp.asarray(a) for a in arrs))
    _, _, jsurv = jmake_rollout(JExploder(), 50)({}, js)
    np.testing.assert_array_equal(sv, np.asarray(jsurv))


class Drift(torch.nn.Module):
    def forward(self, scene, mask):
        self.forces.append(scene.force.clone())
        return torch.cat([torch.full_like(scene.pos, 0.1), scene.vel], dim=-1)


def test_rollout_integration_and_frame0_force_only():
    model = Drift()
    model.forces = []
    pos, vel, _, mass = _arrays(seed=5)
    force = np.ones_like(pos)
    loc, _, surv = make_rollout_fn(model, 10)(Scene(*(torch.from_numpy(a) for a in (pos, vel, force, mass))))
    np.testing.assert_allclose(loc[:, 5].numpy(), pos + 0.5, rtol=1e-12)
    assert len(model.forces) == 9 and torch.all(model.forces[0] == 1)
    assert all(torch.all(f == 0) for f in model.forces[1:])
    assert torch.all(surv == 9)
    for target in ("pos", "force"):
        with pytest.raises(ValueError):
            make_rollout_fn(model, 10, target=target)


def test_run_self_feed_on_fresh_ground_truth():
    _, _, tmodel = _pair()
    ds = GravityDatasetOtf(batch_size=2, sim_length=60, sample_freq=10, num_nodes=N,
                           double_precision=True, seed=0, device="cpu")
    loc_gt, vel_gt, loc_pred, vel_pred, survived = run_self_feed(tmodel, ds, num_steps=4)
    assert loc_gt.shape == loc_pred.shape == vel_pred.shape == (2, 4, N, 3)
    assert torch.equal(loc_pred[:, 0], loc_gt[:, 0]) and 0 <= survived <= 3
    with pytest.raises(ValueError):
        GravityDatasetOtf(target="nope", device="cpu")


@pytest.mark.parametrize("option", [dict(fc_fast=True)])
def test_options_not_in_this_slice_raise(option):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_model("egnn_mc", device="cpu", **SMALL, **option)


def test_create_model_defaults_and_unknown():
    model = create_model("egnn_mc", device="cpu")
    assert len(model.layers) == 6 and model.get_model_size() == 128
    assert model.layers[0].edge_w1.shape == (261, 128)
    with pytest.raises(ValueError):
        create_model("schnet", device="cpu")
