"""The port's GMN against the JAX package's, float64 on the CPU.

A small model (2 layers, width 8) gets the port's seeded float64
initialisation, carried to the JAX model with ``weights.params_to_jax``; both
packages then run on the same scene, made with numpy from a seed, with
charges of both signs (the edge attribute is ``q_i q_j``).

* Forwards agree within 1e-10 of the largest output in every composition of
  ``tests/test_gmn.py`` (5 isolated; 1 isolated and 2 sticks; 2 hinges) and
  a mixed one, on a fully connected and on a kNN mask that is not symmetric
  (the force ``w (x_i - x_j)`` and the means and sums over senders would
  show reversed), with the options ``tanh`` (``coords_range`` declared, not
  applied), ``norm_diff``, ``recurrent`` and ``coords_weight``, with the mass
  standing in for a missing charge, and with ``remat``.
* ``remat`` gives the plain path's outputs and gradients, bit for bit.
* GMN is E(3)-equivariant: a rotation turns both output vectors within 1e-12
  of the largest output in every composition; a shift changes nothing; a
  stick keeps its length and a hinge its two beams' (1e-9: the axis is
  normalised with 1e-12 under the square root).
* Only the modules a composition calls have parameters, under the flax
  names of the order in which the JAX layer makes them.
* ``layer_stats.capture`` gives the JAX trainer's keys and values within 1e-9.
"""

import importlib
from types import SimpleNamespace

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

SMALL = dict(hidden_features=8, num_layers=2)
OUT_RTOL, EQUIV_RTOL, RIGID_RTOL, STATS_RTOL = 1e-10, 1e-12, 1e-9, 1e-9
B = 2
COMPOSITIONS = {"iso5": (5, 0, 0), "iso1_stick2": (1, 2, 0), "hinge2": (0, 0, 2),
                "mixed": (2, 1, 1)}
OPTIONS = {"default": {}, "tanh": dict(tanh=True), "norm_diff": dict(norm_diff=True),
           "recurrent_cw": dict(recurrent=True, coords_weight=0.5), "remat": dict(remat=True)}


def _kw(comp, **extra):
    iso, st, hi = COMPOSITIONS[comp]
    return dict(SMALL, n_isolated=iso, n_stick=st, n_hinge=hi, **extra)


def _n(comp):
    iso, st, hi = COMPOSITIONS[comp]
    return iso + 2 * st + 3 * hi


def _arrays(n, seed=0, charge=True):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(B, n, 3)) * 1.5, rng.normal(size=(B, n, 3)) * 0.5,
            np.zeros((B, n, 3)), rng.uniform(0.5, 2.0, size=(B, n, 1))]
    if charge:
        arrs.append(rng.choice([-1.0, 1.0], size=(B, n, 1)))
    return arrs


def _model(kw, seed=0):
    torch.manual_seed(seed)
    return tmodels.create_model("gmn", device="cpu", dtype=torch.float64, **kw).eval()


def _scenes(arrs):
    return (JScene(*(jnp.asarray(a) for a in arrs)), Scene(*(torch.from_numpy(a) for a in arrs)))


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max()


def _both(model, kw, arrs, k):
    jm = jmodels.create_model("gmn", **kw)
    js, ts = _scenes(arrs)
    want = np.asarray(jm.apply(weights.params_to_jax(model.state_dict()), js,
                               jgraph.knn_mask(js.pos, k)))
    with torch.no_grad():
        got = model(ts, tgraph.knn_mask(ts.pos, k)).numpy()
    return got, want


@pytest.mark.parametrize("knn", [False, True])
@pytest.mark.parametrize("comp", sorted(COMPOSITIONS))
def test_forward_matches_jax(comp, knn):
    n = _n(comp)
    k = 2 if knn else n - 1
    kw = _kw(comp)
    arrs = _arrays(n, seed=n + knn)
    if knn:
        mask = tgraph.knn_mask(torch.from_numpy(arrs[0]), k)
        assert not bool((mask == mask.transpose(1, 2)).all())
    got, want = _both(_model(kw), kw, arrs, k)
    assert got.shape == (B, n, 6) and np.isfinite(got).all()
    assert _rel(got, want) <= OUT_RTOL


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_options_match_jax(option):
    kw = _kw("mixed", **OPTIONS[option])
    got, want = _both(_model(kw), kw, _arrays(_n("mixed"), seed=21), 4)
    assert _rel(got, want) <= OUT_RTOL


def test_the_mass_stands_in_for_a_missing_charge():
    kw = _kw("iso5")
    arrs = _arrays(5, seed=22, charge=False)
    got, want = _both(_model(kw), kw, arrs, 3)
    assert _rel(got, want) <= OUT_RTOL


def test_remat_gives_the_plain_outputs_and_gradients():
    _, ts = _scenes(_arrays(_n("mixed"), seed=23))
    mask = tgraph.knn_mask(ts.pos, 3)
    plain, remat = _model(_kw("mixed")), _model(_kw("mixed", remat=True))
    assert list(plain.state_dict()) == list(remat.state_dict())
    outs, grads = [], []
    for m in (plain, remat):
        m.train()
        out = m(ts, mask)
        out.square().sum().backward()
        outs.append(out.detach())
        grads.append([p.grad for p in m.parameters()])
    assert torch.equal(outs[0], outs[1])
    # the last layer's node model feeds no output: no gradient in either
    assert [a is None for a in grads[0]] == [b is None for b in grads[1]]
    assert all(a is None or torch.equal(a, b) for a, b in zip(*grads))
    assert all(torch.isfinite(g).all() for g in grads[0] if g is not None)


def _rotation(seed):
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    return q if np.linalg.det(q) > 0 else -q


@pytest.mark.parametrize("comp", sorted(COMPOSITIONS))
def test_rotation_and_translation(comp):
    model = _model(_kw(comp))
    n = _n(comp)
    arrs = _arrays(n, seed=24)
    R = _rotation(25)
    rotated = [arrs[0] @ R.T, arrs[1] @ R.T, *arrs[2:]]
    shifted = [arrs[0] + np.array([2.0, -1.0, 0.5]), *arrs[1:]]
    with torch.no_grad():
        out, got_r, got_s = (model(s, tgraph.knn_mask(s.pos, n - 1)).numpy()
                             for s in (_scenes(a)[1] for a in (arrs, rotated, shifted)))
    want = np.concatenate([out[..., :3] @ R.T, out[..., 3:] @ R.T], axis=-1)
    assert _rel(got_r, want) <= EQUIV_RTOL
    assert _rel(got_s, out) <= EQUIV_RTOL


def test_sticks_and_hinges_stay_rigid():
    """A stick keeps its length and a hinge its two beams' lengths, over two
    layers (``tests/test_gmn.py``'s stick check), up to the 1e-12 under the
    square root that normalises the rotation's axis (it shortens the axis,
    and so the turned arm, by ~1e-12 / |w|^2 a layer)."""
    for comp, pairs in (("iso1_stick2", [(1, 2), (3, 4)]),
                        ("hinge2", [(0, 1), (0, 2), (3, 4), (3, 5)])):
        n = _n(comp)
        arrs = _arrays(n, seed=26)
        _, ts = _scenes(arrs)
        with torch.no_grad():
            out = _model(_kw(comp))(ts, tgraph.knn_mask(ts.pos, n - 1))
        new = ts.pos + out[..., :3]
        for a, b in pairs:
            d0 = torch.linalg.vector_norm(ts.pos[:, a] - ts.pos[:, b], dim=-1)
            d1 = torch.linalg.vector_norm(new[:, a] - new[:, b], dim=-1)
            assert torch.allclose(d1, d0, rtol=RIGID_RTOL, atol=0), (comp, a, b)


@pytest.mark.parametrize("comp,mlps", [("iso5", {0, 1, 6}), ("iso1_stick2", {0, 1, 2, 3, 4, 6}),
                                       ("hinge2", {0, 1, 2, 3, 5, 6}),
                                       ("mixed", {0, 1, 2, 3, 4, 5, 6})])
def test_only_the_called_modules_have_parameters(comp, mlps):
    sd = _model(_kw(comp)).state_dict()
    got = {int(k.split(".")[2][len("MLP_"):]) for k in sd if k.startswith("blocks.0.MLP_")}
    assert got == mlps
    assert "blocks.0.Dense_0.weight" in sd and "blocks.0.TorchLinear_0.bias" in sd
    assert ("blocks.0.coords_range" in sd) is False
    assert "blocks.0.coords_range" in _model(_kw(comp, tanh=True)).state_dict()


def test_layer_stats_match_the_jax_trainers():
    kw = _kw("iso5")
    model = _model(kw)
    tree = weights.params_to_jax(model.state_dict())
    js, ts = _scenes(_arrays(5, seed=27, charge=False))
    holder = SimpleNamespace(model=jmodels.create_model("gmn", **kw), num_neighbors=4,
                             _data_masks=False)
    want = {k: float(v) for k, v in JT.Trainer._build_layer_stats_fn(holder)(tree, js).items()}
    got = {k: float(v) for k, v in TLS.capture(model, ts, tgraph.knn_mask(ts.pos, 4)).items()}
    assert set(got) == set(want) and "TorchLinear_0.absmax" in got
    for k, v in want.items():
        assert abs(got[k] - v) <= STATS_RTOL * max(abs(v), 1.0), k
