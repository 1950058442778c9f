"""PaiNN's weights across the two packages, and its counts.

* A JAX-initialised tree of each option set (the default, no velocity input,
  no velocity norm, ``remat``) maps onto the port's ``state_dict`` (every
  key, strictly) and back bitwise: ``Scan_PaiNNBlock_0``'s leaves are split
  into the port's ``blocks`` on the way in and stacked on the way out,
  ``TorchLinear`` kernels transposed, ``EquivariantLinear``'s ``[in, out]``
  ``weight`` kept, ``MLP_0`` / ``MLP_1`` the ``q`` embedding and the velocity
  scale, ``_Readout_0`` / ``_Readout_1`` the position and velocity heads.
  The port's own trees have the JAX model's shapes, and ``remat`` does not
  change the tree in either package.
* The JAX model on a JAX-initialised tree and the port's model on its
  mapping agree within 1e-9 (float64) at the stability run's width (H192, L6,
  64 RBF, the toggles of ``docs/results/painn_stab_v5e/run_config.yaml``).
* ``opt_state_from_jax`` maps an optax AdamW state of the tree onto the
  port's parameter names.
* Counts: the port's ``count_params`` and ``hpo._count_params`` (meta device)
  equal the JAX package's at the stability run's size (7,467,648) and at
  shapes of the HPO space.
* The family is named or found by its marker.
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

SMALL = dict(hidden_features=8, num_layers=3, num_rbf=6)
STAB = dict(hidden_features=192, num_layers=6, num_rbf=64, cutoff=10.0,
            residual_scale_interaction=0.5, tanh_message_scale=5.0, filter_gain=0.5,
            clip_vector_msg_norm=10.0, clip_scalar_msg_value=10.0, residual_scale_mixing=0.5,
            tanh_mixing_scale=5.0, clip_mu_norm=20.0, clip_q_value=100.0)
N_STAB = 7_467_648
OPTIONS = {"default": {}, "no_velocity_input": dict(use_velocity_input=False),
           "no_velocity_norm": dict(include_velocity_norm=False), "remat": dict(remat=True)}


def _jax_tree(kw, seed=0):
    scene = JScene.stationary(2, 5)
    jm = jmodels.create_model("painn", **kw)
    return jm, jm.init(jax.random.PRNGKey(seed), scene, jgraph.knn_mask(scene.pos, 4))


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
    tree = jax.tree_util.tree_map(np.asarray, tree)
    assert weights.jax_family(tree) == "painn"
    sd = weights.params_from_jax(tree, "painn")
    model = tmodels.create_model("painn", device="cpu", **kw)
    model.load_state_dict(sd)  # strict: every key, every shape
    assert weights.port_family(model.state_dict()) == "painn"
    _same_tree(tree, weights.params_to_jax(model.state_dict(), "painn"))
    scan = tree["params"]["Scan_PaiNNBlock_0"]
    np.testing.assert_array_equal(
        sd["blocks.2._Mixing_0.EquivariantLinear_0.weight"].numpy(),
        scan["_Mixing_0"]["EquivariantLinear_0"]["weight"][2])
    np.testing.assert_array_equal(
        sd["blocks.1._Interaction_0.MLP_0.layers.1.weight"].numpy(),
        scan["_Interaction_0"]["MLP_0"]["TorchLinear_1"]["Dense_0"]["kernel"][1].T)
    np.testing.assert_array_equal(
        sd["_Readout_1.EquivariantLinear_1.weight"].numpy(),
        tree["params"]["_Readout_1"]["EquivariantLinear_1"]["weight"])
    assert ("MLP_1.layers.0.weight" in sd) == kw.get("use_velocity_input", True)


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_port_trees_have_the_jax_shapes(option):
    kw = {**SMALL, **OPTIONS[option]}
    torch.manual_seed(1)
    model = tmodels.create_model("painn", device="cpu", **kw)
    tree = weights.params_to_jax(model.state_dict(), "painn")
    scene = JScene.stationary(2, 5)
    init = jax.eval_shape(jmodels.create_model("painn", **kw).init, jax.random.PRNGKey(0), scene,
                          jgraph.knn_mask(scene.pos, 4))
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), init["params"])
    assert jax.tree_util.tree_map(np.shape, tree["params"]) == shapes
    back = weights.params_from_jax(tree, "painn")
    assert set(back) == set(model.state_dict())
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())


def test_remat_keeps_the_tree():
    plain, remat = _jax_tree(SMALL)[1], _jax_tree({**SMALL, "remat": True})[1]
    assert (jax.tree_util.tree_map(np.shape, plain)
            == jax.tree_util.tree_map(np.shape, remat))
    a = tmodels.create_model("painn", device="cpu", **SMALL)
    b = tmodels.create_model("painn", device="cpu", remat=True, **SMALL)
    assert ({k: v.shape for k, v in a.state_dict().items()}
            == {k: v.shape for k, v in b.state_dict().items()})


def test_a_jax_initialised_stability_model_runs_the_same():
    jm, tree = _jax_tree(STAB, seed=3)
    tree = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), tree)
    model = tmodels.create_model("painn", device="cpu", dtype=torch.float64, **STAB).eval()
    model.load_state_dict(weights.params_from_jax(tree, "painn"))
    rng = np.random.default_rng(4)
    arrs = [rng.normal(size=(2, 5, 3)) * 2.0, rng.normal(size=(2, 5, 3)), np.zeros((2, 5, 3)),
            np.ones((2, 5, 1))]
    js = JScene(*(jnp.asarray(a) for a in arrs))
    want = np.asarray(jm.apply(tree, js, jgraph.knn_mask(js.pos, 4)))
    ts = Scene(*(torch.from_numpy(a) for a in arrs))
    with torch.no_grad():
        got = model(ts, tgraph.knn_mask(ts.pos, 4)).numpy()
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()


def test_adamw_state_maps_onto_the_port_names():
    _, tree = _jax_tree(SMALL)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    state = optax.adamw(1e-3).init(tree)
    state = jax.tree_util.tree_map(np.asarray, state)
    count, mu, nu = weights.opt_state_from_jax(state, "painn")
    model = tmodels.create_model("painn", device="cpu", **SMALL)
    names = {n for n, _ in model.named_parameters()}
    assert count == 0 and set(mu) == set(nu) == names
    for k in mu:
        assert mu[k].shape == nu[k].shape == model.state_dict()[k].shape, k


def test_the_stability_runs_count():
    model = tmodels.create_model("painn", device="meta", **STAB)
    assert tmodels.count_params(model) == N_STAB
    assert TH._count_params("painn", STAB, 5) == JH._count_params("painn", STAB, 5) == N_STAB
    assert model.get_model_size() == 192


@pytest.mark.parametrize("kw", [dict(hidden_features=128, num_layers=4),
                                dict(hidden_features=224, num_layers=8),
                                dict(hidden_features=96, num_layers=6, use_velocity_input=False),
                                dict(hidden_features=112, num_layers=5,
                                     include_velocity_norm=False)])
def test_counts_equal_the_jax_packages(kw):
    assert TH._count_params("painn", kw, 5) == JH._count_params("painn", kw, 5)


def test_family_is_named_or_found_and_others_raise():
    _, tree = _jax_tree(SMALL)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    with pytest.raises(ValueError, match="painn tree, not graph_transformer"):
        weights.params_from_jax(tree, "graph_transformer")
    with pytest.raises(NotImplementedError, match="'schnet' is not ported"):
        weights.params_from_jax(tree, "schnet")
    model = tmodels.create_model("painn", device="cpu", **SMALL)
    with pytest.raises(ValueError, match="painn tree, not segnn"):
        weights.params_to_jax(model.state_dict(), "segnn")
