"""GMN's weights across the two packages, and its counts.

* A JAX-initialised tree of every composition of ``tests/test_gmn.py`` (and
  with ``tanh``'s ``coords_range``, and with ``remat``) maps onto the port's
  ``state_dict`` (every key, strictly) and back bitwise, by the converter's
  one named rule: ``Scan_GMNLayer_0``'s leaves are split into the port's
  ``blocks`` and stacked back, an ``MLP_k``'s ``TorchLinear_j`` kernels and
  the bias-free ``Dense_0`` kernel transposed.  The port's own trees have the
  JAX model's shapes; ``remat`` changes neither tree.
* The JAX model on a JAX-initialised tree (in float64) and the port's model
  on its mapping agree within 1e-10 at the defaults' width.
* ``opt_state_from_jax`` maps an optax AdamW state onto the port's names.
* Counts: ``count_params`` and ``hpo._count_params`` (meta device) give the
  defaults' 150,212 (h64, L4, 5 isolated) and equal the JAX package's for
  other compositions.
* The family is named or found by its marker, in both directions.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

TPU = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu"
PORT = TPU + "_torch"
JH = importlib.import_module(TPU + ".hpo.hpo")
jgraph = importlib.import_module(TPU + ".core.graph")
JScene = importlib.import_module(TPU + ".core.scene").Scene
jmodels = importlib.import_module(TPU + ".models")
TH = importlib.import_module(PORT + ".hpo.hpo")
tgraph = importlib.import_module(PORT + ".core.graph")
Scene = importlib.import_module(PORT + ".core.scene").Scene
tmodels = importlib.import_module(PORT + ".models")
weights = importlib.import_module(PORT + ".weights")

SMALL = dict(hidden_features=8, num_layers=3)
N_DEFAULT = 150_212
OPTIONS = {"iso5": dict(n_isolated=5), "iso1_stick2": dict(n_isolated=1, n_stick=2),
           "hinge2": dict(n_isolated=0, n_hinge=2),
           "mixed_tanh": dict(n_isolated=2, n_stick=1, n_hinge=1, tanh=True),
           "remat": dict(n_isolated=5, remat=True)}


def _n(kw):
    return kw.get("n_isolated", 5) + 2 * kw.get("n_stick", 0) + 3 * kw.get("n_hinge", 0)


def _jax_tree(kw, seed=0):
    """The JAX model and its initialised tree, every leaf float32 as the JAX
    package trains it."""
    scene = JScene.stationary(2, _n(kw))
    jm = jmodels.create_model("gmn", **kw)
    tree = jm.init(jax.random.PRNGKey(seed), scene, jgraph.knn_mask(scene.pos, _n(kw) - 1))
    return jm, jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _same_tree(a, b):
    fa = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(a)}
    fb = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(b)}
    assert set(fa) == set(fb)
    for k, v in fa.items():
        assert np.asarray(v).dtype == np.asarray(fb[k]).dtype, k
        assert np.array_equal(np.asarray(v), np.asarray(fb[k])), k


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_jax_trees_round_trip_bitwise(option):
    kw = {**SMALL, **OPTIONS[option]}
    _, tree = _jax_tree(kw)
    assert weights.jax_family(tree) == "gmn"
    sd = weights.params_from_jax(tree, "gmn")
    model = tmodels.create_model("gmn", device="cpu", **kw)
    model.load_state_dict(sd)  # strict: every key, every shape
    assert weights.port_family(model.state_dict()) == "gmn"
    _same_tree(tree, weights.params_to_jax(model.state_dict(), "gmn"))
    scan = tree["params"]["Scan_GMNLayer_0"]
    np.testing.assert_array_equal(sd["blocks.2.Dense_0.weight"].numpy(),
                                  scan["Dense_0"]["kernel"][2].T)
    np.testing.assert_array_equal(sd["blocks.1.MLP_6.layers.1.weight"].numpy(),
                                  scan["MLP_6"]["TorchLinear_1"]["Dense_0"]["kernel"][1].T)
    np.testing.assert_array_equal(sd["TorchLinear_0.weight"].numpy(),
                                  tree["params"]["TorchLinear_0"]["Dense_0"]["kernel"].T)
    assert ("blocks.0.coords_range" in sd) == kw.get("tanh", False)


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_port_trees_have_the_jax_shapes(option):
    kw = {**SMALL, **OPTIONS[option]}
    torch.manual_seed(1)
    model = tmodels.create_model("gmn", device="cpu", **kw)
    tree = weights.params_to_jax(model.state_dict(), "gmn")
    scene = JScene.stationary(2, _n(kw))
    init = jax.eval_shape(jmodels.create_model("gmn", **kw).init, jax.random.PRNGKey(0), scene,
                          jgraph.knn_mask(scene.pos, _n(kw) - 1))
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), init["params"])
    assert jax.tree_util.tree_map(np.shape, tree["params"]) == shapes
    back = weights.params_from_jax(tree, "gmn")
    assert set(back) == set(model.state_dict())
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())


def test_remat_keeps_the_tree():
    plain, remat = _jax_tree(SMALL)[1], _jax_tree({**SMALL, "remat": True})[1]
    assert (jax.tree_util.tree_map(np.shape, plain)
            == jax.tree_util.tree_map(np.shape, remat))
    a = tmodels.create_model("gmn", device="cpu", **SMALL)
    b = tmodels.create_model("gmn", device="cpu", remat=True, **SMALL)
    assert ({k: v.shape for k, v in a.state_dict().items()}
            == {k: v.shape for k, v in b.state_dict().items()})


def test_a_jax_initialised_model_runs_the_same():
    kw = dict(n_isolated=5)
    jm, tree = _jax_tree(kw, seed=3)
    tree = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), tree)
    model = tmodels.create_model("gmn", device="cpu", dtype=torch.float64).eval()
    model.load_state_dict(weights.params_from_jax(tree, "gmn"))
    rng = np.random.default_rng(4)
    arrs = [rng.normal(size=(2, 5, 3)) * 2.0, rng.normal(size=(2, 5, 3)), np.zeros((2, 5, 3)),
            rng.uniform(0.5, 2.0, size=(2, 5, 1))]
    js = JScene(*(jnp.asarray(a) for a in arrs))
    want = np.asarray(jm.apply(tree, js, jgraph.knn_mask(js.pos, 4)))
    ts = Scene(*(torch.from_numpy(a) for a in arrs))
    with torch.no_grad():
        got = model(ts, tgraph.knn_mask(ts.pos, 4)).numpy()
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def test_adamw_state_maps_onto_the_port_names():
    kw = {**SMALL, **OPTIONS["mixed_tanh"]}
    _, tree = _jax_tree(kw)
    state = jax.tree_util.tree_map(np.asarray, optax.adamw(1e-3).init(tree))
    count, mu, nu = weights.opt_state_from_jax(state, "gmn")
    model = tmodels.create_model("gmn", device="cpu", **kw)
    names = {n for n, _ in model.named_parameters()}
    assert count == 0 and set(mu) == set(nu) == names
    for k in mu:
        assert mu[k].shape == nu[k].shape == model.state_dict()[k].shape, k


def test_the_defaults_count():
    model = tmodels.create_model("gmn", device="meta")
    assert tmodels.count_params(model) == N_DEFAULT
    assert TH._count_params("gmn", {}, 5) == JH._count_params("gmn", {}, 5) == N_DEFAULT
    assert model.get_model_size() == 64


@pytest.mark.parametrize("kw", [dict(n_isolated=1, n_stick=2), dict(n_isolated=0, n_hinge=2),
                                dict(hidden_features=96, num_layers=6, tanh=True)])
def test_counts_equal_the_jax_packages(kw):
    assert TH._count_params("gmn", kw, _n(kw)) == JH._count_params("gmn", kw, _n(kw))


def test_family_is_named_or_found_both_ways():
    _, tree = _jax_tree(SMALL)
    with pytest.raises(ValueError, match="gmn tree, not cgenn"):
        weights.params_from_jax(tree, "cgenn")
    model = tmodels.create_model("gmn", device="cpu", **SMALL)
    with pytest.raises(ValueError, match="gmn tree, not egnn_mc"):
        weights.params_to_jax(model.state_dict(), "egnn_mc")
    assert weights.port_family(model.state_dict()) == "gmn"
    assert weights.jax_family(weights.params_to_jax(model.state_dict())) == "gmn"
