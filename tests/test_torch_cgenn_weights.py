"""CGENN's weights across the two packages, and its counts.

* A JAX-initialised tree (the default options, with ``remat``, at another
  metric seed) maps onto the port's ``state_dict`` (every
  key, strictly) and back bitwise, by the converter's one named rule:
  ``Scan_EGCL_0``'s leaves are split into the port's ``blocks`` on the way in
  and stacked on the way out, and every CGENN leaf (``weight``, ``bias``,
  ``a``, ``b`` of ``MVLinear_k``, ``MVSiLU_k``, ``_Normalization_0``,
  ``MVLayerNorm_k`` and the geometric products) keeps its name and layout,
  untransposed.  The JAX package trains without x64, where every leaf is
  float32; under the tests' x64 flax's ones and zeros initialisers (the
  gates' ``a`` and ``b``, the biases) give float64 leaves, so the JAX tree is
  cast to float32 first.  The port's own trees have the JAX model's shapes;
  ``remat`` changes neither tree.
* The JAX model on a JAX-initialised tree (in float64) and the port's model
  on its mapping agree within 1e-10 at width 32, depth 2.
* ``opt_state_from_jax`` maps an optax AdamW state of the tree onto the
  port's parameter names.
* Counts: ``count_params`` and ``hpo._count_params`` (meta device) give the
  10M run's 9,814,466 (L6 h176, remat) and equal the JAX package's at shapes
  of the HPO space.
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

SMALL = dict(hidden_features=6, num_layers=3)
RUN_10M = dict(hidden_features=176, num_layers=6, remat=True)
N_10M = 9_814_466
OPTIONS = {"default": {}, "remat": dict(remat=True), "metric_seed": dict(metric_seed=3)}


def _jax_tree(kw, seed=0):
    """The JAX model and its initialised tree, every leaf float32 as the JAX
    package trains it."""
    scene = JScene.stationary(2, 5)
    jm = jmodels.create_model("cgenn", **kw)
    tree = jm.init(jax.random.PRNGKey(seed), scene, jgraph.knn_mask(scene.pos, 4))
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
    assert weights.jax_family(tree) == "cgenn"
    sd = weights.params_from_jax(tree, "cgenn")
    model = tmodels.create_model("cgenn", device="cpu", **kw)
    model.load_state_dict(sd)  # strict: every key, every shape
    assert weights.port_family(model.state_dict()) == "cgenn"
    _same_tree(tree, weights.params_to_jax(model.state_dict(), "cgenn"))
    scan = tree["params"]["Scan_EGCL_0"]
    np.testing.assert_array_equal(
        sd["blocks.2.CEMLP_1.SteerableGeometricProduct_1.weight"].numpy(),
        scan["CEMLP_1"]["SteerableGeometricProduct_1"]["weight"][2])
    np.testing.assert_array_equal(sd["blocks.1.CEMLP_0.MVSiLU_0.b"].numpy(),
                                  scan["CEMLP_0"]["MVSiLU_0"]["b"][1])
    np.testing.assert_array_equal(sd["MVLinear_0.weight"].numpy(),
                                  tree["params"]["MVLinear_0"]["weight"])
    assert sd["MVLinear_0.weight"].shape == (6, 3)  # the embedding: no subspaces
    assert sd["MVLinear_1.weight"].shape == (2, 6, 4)
    assert sd["blocks.0.CEMLP_0.SteerableGeometricProduct_0._Normalization_0.a"].shape == (6, 4)


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_port_trees_have_the_jax_shapes(option):
    kw = {**SMALL, **OPTIONS[option]}
    torch.manual_seed(1)
    model = tmodels.create_model("cgenn", device="cpu", **kw)
    tree = weights.params_to_jax(model.state_dict(), "cgenn")
    scene = JScene.stationary(2, 5)
    init = jax.eval_shape(jmodels.create_model("cgenn", **kw).init, jax.random.PRNGKey(0),
                          scene, jgraph.knn_mask(scene.pos, 4))
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), init["params"])
    assert jax.tree_util.tree_map(np.shape, tree["params"]) == shapes
    back = weights.params_from_jax(tree, "cgenn")
    assert set(back) == set(model.state_dict())
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())


def test_remat_keeps_the_tree():
    plain, remat = _jax_tree(SMALL)[1], _jax_tree({**SMALL, "remat": True})[1]
    assert (jax.tree_util.tree_map(np.shape, plain)
            == jax.tree_util.tree_map(np.shape, remat))
    a = tmodels.create_model("cgenn", device="cpu", **SMALL)
    b = tmodels.create_model("cgenn", device="cpu", remat=True, **SMALL)
    assert ({k: v.shape for k, v in a.state_dict().items()}
            == {k: v.shape for k, v in b.state_dict().items()})


def test_a_jax_initialised_model_runs_the_same():
    kw = dict(hidden_features=32, num_layers=2)
    jm, tree = _jax_tree(kw, seed=3)
    tree = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), tree)
    model = tmodels.create_model("cgenn", device="cpu", dtype=torch.float64, **kw).eval()
    model.load_state_dict(weights.params_from_jax(tree, "cgenn"))
    rng = np.random.default_rng(4)
    arrs = [rng.normal(size=(2, 5, 3)) * 2.0, rng.normal(size=(2, 5, 3)), np.zeros((2, 5, 3)),
            np.ones((2, 5, 1))]
    js = JScene(*(jnp.asarray(a) for a in arrs))
    want = np.asarray(jm.apply(tree, js, jgraph.knn_mask(js.pos, 4)))
    ts = Scene(*(torch.from_numpy(a) for a in arrs))
    with torch.no_grad():
        got = model(ts, tgraph.knn_mask(ts.pos, 4)).numpy()
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def test_adamw_state_maps_onto_the_port_names():
    _, tree = _jax_tree(SMALL)
    state = jax.tree_util.tree_map(np.asarray, optax.adamw(1e-3).init(tree))
    count, mu, nu = weights.opt_state_from_jax(state, "cgenn")
    model = tmodels.create_model("cgenn", device="cpu", **SMALL)
    names = {n for n, _ in model.named_parameters()}
    assert count == 0 and set(mu) == set(nu) == names
    for k in mu:
        assert mu[k].shape == nu[k].shape == model.state_dict()[k].shape, k


def test_the_10m_runs_count():
    model = tmodels.create_model("cgenn", device="meta", **RUN_10M)
    assert tmodels.count_params(model) == N_10M
    assert TH._count_params("cgenn", RUN_10M, 5) == JH._count_params("cgenn", RUN_10M, 5) == N_10M
    assert model.get_model_size() == 176


@pytest.mark.parametrize("kw", [dict(hidden_features=160, num_layers=5),
                                dict(hidden_features=64, num_layers=10),
                                dict(hidden_features=96, num_layers=4)])
def test_counts_equal_the_jax_packages(kw):
    assert TH._count_params("cgenn", kw, 5) == JH._count_params("cgenn", kw, 5)


def test_family_is_named_or_found_both_ways():
    _, tree = _jax_tree(SMALL)
    with pytest.raises(ValueError, match="cgenn tree, not gmn"):
        weights.params_from_jax(tree, "gmn")
    model = tmodels.create_model("cgenn", device="cpu", **SMALL)
    with pytest.raises(ValueError, match="cgenn tree, not painn"):
        weights.params_to_jax(model.state_dict(), "painn")
    assert weights.port_family(model.state_dict()) == "cgenn"
    assert weights.jax_family(weights.params_to_jax(model.state_dict())) == "cgenn"
