"""The port's PaiNN against the JAX package's, float64 on the CPU.

A small model (2 layers, width 8, 6 RBF) gets the port's seeded float64
initialisation, carried to the JAX model with ``weights.params_to_jax``;
both packages then run on the same scene, made with numpy from a seed, with
masses other than one.

* Forwards agree within 1e-9 of the largest output, on N=8 with a k=3
  nearest-neighbour mask that is not symmetric (the edge vector
  ``pos_j - pos_i`` and the mean over senders would show reversed), and
  fully connected at N=5, for each stability toggle alone (at values small
  enough that every clip and tanh bites), all of them together, without
  the velocity input or its norm, with ``remat``, and at a cutoff shorter
  than the bodies' distances.
* ``remat`` gives the plain path's outputs and gradients, bit for bit, with
  the same parameter tree.
* The model is O(3)-equivariant and translation-invariant (a rotation with
  a reflection turns both output vectors within 1e-12 of the largest
  output; a shift changes nothing), and permutation-equivariant.
* PaiNN has no dropout: training mode equals eval mode and needs no
  generator.
* Gradients are finite; ``layer_stats.capture`` gives the JAX trainer's
  keys and values within 1e-9.
"""

import importlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

TPU = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu"
PORT = TPU + "_torch"
jgraph = importlib.import_module(TPU + ".core.graph")
JScene = importlib.import_module(TPU + ".core.scene").Scene
jmodels = importlib.import_module(TPU + ".models")
JT = importlib.import_module(TPU + ".train.trainer")
tgraph = importlib.import_module(PORT + ".core.graph")
Scene = importlib.import_module(PORT + ".core.scene").Scene
tmodels = importlib.import_module(PORT + ".models")
weights = importlib.import_module(PORT + ".weights")
TLS = importlib.import_module(PORT + ".evaluation.layer_stats")

SMALL = dict(hidden_features=8, num_layers=2, num_rbf=6)
OUT_RTOL, EQUIV_RTOL, STATS_RTOL = 1e-9, 1e-12, 1e-9
B = 3
GRAPHS = {"fc5": (5, 4), "knn8": (8, 3)}  # N, k
TOGGLES = dict(residual_scale_interaction=0.5, residual_scale_mixing=0.7,
               tanh_message_scale=0.3, tanh_mixing_scale=0.2, clip_scalar_msg_value=0.05,
               clip_vector_msg_norm=0.05, clip_q_value=0.4, clip_mu_norm=0.1, filter_gain=0.5)
CASES = {
    "default": {},
    **{k: {k: v} for k, v in TOGGLES.items()},
    "all_toggles": TOGGLES,
    "no_velocity_input": dict(use_velocity_input=False),
    "no_velocity_norm": dict(include_velocity_norm=False),
    "remat": dict(remat=True, **TOGGLES),
    "short_cutoff": dict(cutoff=1.5),
}


def _arrays(n, seed=0, b=B):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(b, n, 3)) * (n / 5.0) ** (1 / 3)
    return [pos, rng.normal(size=(b, n, 3)), np.zeros((b, n, 3)),
            rng.uniform(0.5, 2.0, size=(b, n, 1))]


def _model(kw, seed=0):
    torch.manual_seed(seed)
    return tmodels.create_model("painn", device="cpu", dtype=torch.float64,
                                **{**SMALL, **kw}).eval()


def _scenes(arrs):
    return (JScene(*(jnp.asarray(a) for a in arrs)), Scene(*(torch.from_numpy(a) for a in arrs)))


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max()


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case, graph):
    n, k = GRAPHS[graph]
    model = _model(CASES[case])
    tree = weights.params_to_jax(model.state_dict())
    jm = jmodels.create_model("painn", **{**SMALL, **CASES[case]})
    js, ts = _scenes(_arrays(n, seed=n))
    want = np.asarray(jm.apply(tree, js, jgraph.knn_mask(js.pos, k)))
    with torch.no_grad():
        got = model(ts, tgraph.knn_mask(ts.pos, k)).numpy()
    assert got.shape == (B, n, 6) and np.isfinite(got).all()
    assert _rel(got, want) <= OUT_RTOL


def test_the_toggles_act():
    """Each toggle moves the output (at these values every clip bites)."""
    _, ts = _scenes(_arrays(8, seed=1))
    mask = tgraph.knn_mask(ts.pos, 3)
    with torch.no_grad():
        base = _model({})(ts, mask)
        for k, v in TOGGLES.items():
            assert not torch.allclose(_model({k: v})(ts, mask), base, rtol=0, atol=1e-9), k


def test_remat_gives_the_plain_outputs_and_gradients():
    _, ts = _scenes(_arrays(8, seed=2))
    mask = tgraph.knn_mask(ts.pos, 3)
    plain, remat = _model(TOGGLES), _model(dict(remat=True, **TOGGLES))
    assert list(plain.state_dict()) == list(remat.state_dict())
    outs, grads = [], []
    for m in (plain, remat):
        m.train()
        out = m(ts, mask)
        out.square().sum().backward()
        outs.append(out.detach())
        grads.append([p.grad for p in m.parameters()])
    assert torch.equal(outs[0], outs[1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    assert all(torch.isfinite(g).all() for g in grads[0])


def _orthogonal(seed, reflect):
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if (np.linalg.det(q) > 0) == reflect:
        q = -q
    return q


@pytest.mark.parametrize("reflect", [False, True])
def test_rotation_reflection_and_translation(reflect):
    model = _model(TOGGLES)
    arrs = _arrays(6, seed=3)
    R = _orthogonal(4, reflect)
    moved = [arrs[0] @ R.T + np.array([2.0, -1.0, 0.5]), arrs[1] @ R.T, arrs[2], arrs[3]]
    _, ts = _scenes(arrs)
    _, tm = _scenes(moved)
    with torch.no_grad():
        out = model(ts, tgraph.knn_mask(ts.pos, 3)).numpy()
        got = model(tm, tgraph.knn_mask(tm.pos, 3)).numpy()
    want = np.concatenate([out[..., :3] @ R.T, out[..., 3:] @ R.T], axis=-1)
    assert _rel(got, want) <= EQUIV_RTOL


def test_permutation():
    model = _model(TOGGLES)
    _, ts = _scenes(_arrays(6, seed=5))
    perm = torch.tensor([4, 2, 0, 5, 1, 3])
    moved = Scene(ts.pos[:, perm], ts.vel[:, perm], ts.force[:, perm], ts.mass[:, perm])
    with torch.no_grad():
        out = model(ts, tgraph.knn_mask(ts.pos, 3))
        got = model(moved, tgraph.knn_mask(moved.pos, 3))
    assert _rel(got.numpy(), out[:, perm].numpy()) <= EQUIV_RTOL


def test_no_dropout_so_training_mode_is_eval_mode():
    model = _model(TOGGLES)
    _, ts = _scenes(_arrays(5, seed=6))
    mask = tgraph.knn_mask(ts.pos, 4)
    with torch.no_grad():
        out = model(ts, mask)
        model.train()
        assert not tmodels.needs_generator(model)
        assert tmodels.generator_kwargs(model, 3, "cpu") == {}
        assert torch.equal(model(ts, mask, train=True), out)


def test_layer_stats_match_the_jax_trainers():
    model = _model(TOGGLES)
    tree = weights.params_to_jax(model.state_dict())
    js, ts = _scenes(_arrays(5, seed=7))
    holder = SimpleNamespace(model=jmodels.create_model("painn", **{**SMALL, **TOGGLES}),
                             num_neighbors=4, _data_masks=False)
    want = {k: float(v) for k, v in JT.Trainer._build_layer_stats_fn(holder)(tree, js).items()}
    got = {k: float(v) for k, v in TLS.capture(model, ts, tgraph.knn_mask(ts.pos, 4)).items()}
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= STATS_RTOL * max(abs(v), 1.0), k
