"""SEGNN's and SEConv's weights across the two packages, and their counts.

* The committed 10M checkpoint (``docs/results/segnn10m_r5/ckpt_110_model.ckpt``,
  L6 w448) goes through ``params_from_jax`` into the port's model and back
  through ``params_to_jax`` bitwise; its ``mp_scan`` leaves are split into
  the six layers on the way in and stacked on the way out.
* ``opt_state_from_jax`` maps its AdamW ``mu`` and ``nu`` (count 110000) onto
  the port's parameter names exactly.
* The port's count is the checkpoint's 10,557,344 (``count_params`` and
  ``hpo._count_params``, the latter on the meta device), and equals the JAX
  package's count at the shapes of the HPO space, lmax 2 included; the
  Clebsch-Gordan constants are not in any ``state_dict``.
* The committed checkpoint's forward on one small scene (B=2, N=5, float64)
  agrees with the JAX model's within 1e-9 of the largest output.
* Small SEGNN (with the instance norm) and SEConv (``nonlinear``) trees
  round-trip bitwise, their optional modules included.
* The converter's family: named or found in the tree; a family the port does
  not build, and a tree of another family than the one named, raise.
* ``flax_layer_paths`` names the JAX model's captured layers.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "docs", "results", "segnn10m_r5", "ckpt_110_model.ckpt")
L6W448 = dict(num_layers=6, hidden_features=448)
N_PARAMS = 10_557_344
OUT_RTOL = 1e-9


@pytest.fixture(scope="module")
def payload():
    return weights.read_checkpoint(CKPT)


@pytest.fixture(scope="module")
def committed_model(payload):
    model = tmodels.create_model("segnn", device="cpu", **L6W448)
    model.load_state_dict(weights.params_from_jax(payload["params"], "segnn"))
    return model


def _assert_same_tree(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), path


def test_committed_tree_round_trips_bitwise(payload, committed_model):
    params = payload["params"]
    assert weights.jax_family(params) == "segnn" and set(params) == {"params"}
    sd = committed_model.state_dict()
    assert weights.port_family(sd) == "segnn"
    scan = params["params"]["mp_scan"]["SteerableTPSwishGate_0"]["SteerableTensorProduct_0"]
    np.testing.assert_array_equal(sd["layers.4.message1.tp.w_4_1_1"].numpy(), scan["w_4_1_1"][4])
    assert tuple(sd["layers.5.update2.w_1_1_0"].shape) == (224, 1, 224)
    _assert_same_tree(params, weights.params_to_jax(sd))
    _assert_same_tree(params, weights.params_to_jax(weights.params_from_jax(params)))


def test_opt_state_maps_mu_and_nu_to_the_ports_names(payload, committed_model):
    count, mu, nu = weights.opt_state_from_jax(payload["opt_state"], "segnn")
    adam = payload["opt_state"][0][0]
    assert count == int(np.asarray(adam[0])) == 110_000
    names = {n for n, _ in committed_model.named_parameters()}
    assert set(mu) == set(nu) == names
    jmu, jnu = adam[1]["params"], adam[2]["params"]
    np.testing.assert_array_equal(mu["layers.2.update1.tp.b_0"].numpy(),
                                  jmu["mp_scan"]["SteerableTPSwishGate_2"]
                                  ["SteerableTensorProduct_0"]["b_0"][2])
    np.testing.assert_array_equal(nu["pre_pool2.w_1_0_1"].numpy(), jnu["pre_pool2"]["w_1_0_1"])
    for k in mu:
        assert mu[k].shape == nu[k].shape == committed_model.state_dict()[k].shape, k


def test_count_params_of_the_committed_shape(committed_model):
    assert tmodels.count_params(committed_model) == N_PARAMS
    assert sum(p.numel() for p in committed_model.parameters()) == N_PARAMS
    assert TH._count_params("segnn", L6W448, 5) == N_PARAMS
    assert repr(committed_model.hidden_irreps) == "224x0e+224x1o"
    assert not list(committed_model.buffers())


@pytest.mark.parametrize("family,kw", [
    ("segnn", dict(num_layers=5, hidden_features=48, lmax_h=2)),
    ("segnn", dict(num_layers=10, hidden_features=128, lmax_h=1)),
    ("segnn", dict(num_layers=2, hidden_features=16, normalization_type="instance")),
    ("seconv", dict(num_layers=3, hidden_features=64, conv_type="nonlinear")),
])
def test_count_params_matches_jax(family, kw):
    assert TH._count_params(family, kw, 5) == JH._count_params(family, kw, 5)


def test_committed_checkpoint_forward_matches_jax(payload, committed_model):
    rng = np.random.default_rng(11)
    arrs = [rng.normal(size=(2, 5, 3)), rng.normal(size=(2, 5, 3)), np.zeros((2, 5, 3)),
            np.ones((2, 5, 1))]
    js = JScene(*(jnp.asarray(a) for a in arrs))
    ts = Scene(*(torch.from_numpy(a) for a in arrs))
    jm = jmodels.create_model("segnn", **L6W448)
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), payload["params"])
    want = np.asarray(jax.jit(jm.apply)(params, js, jgraph.knn_mask(js.pos, 4)))
    model = tmodels.create_model("segnn", device="cpu", dtype=torch.float64, **L6W448)
    model.load_state_dict(committed_model.state_dict())
    with torch.no_grad():
        got = model(ts, tgraph.knn_mask(ts.pos, 4)).numpy()
    assert np.isfinite(got).all() and got.shape == (2, 5, 6)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= OUT_RTOL * scale, (err, scale)


@pytest.mark.parametrize("family,kw", [
    ("segnn", dict(num_layers=3, hidden_features=16, normalization_type="instance")),
    ("seconv", dict(num_layers=2, hidden_features=16, conv_type="nonlinear")),
    ("seconv", dict(num_layers=2, hidden_features=16)),
])
def test_small_trees_round_trip_bitwise(family, kw):
    rng = np.random.default_rng(0)
    arrs = [rng.normal(size=(1, 5, 3)) for _ in range(3)] + [np.ones((1, 5, 1))]
    js = JScene(*(jnp.asarray(a, jnp.float32) for a in arrs))
    params = jax.jit(jmodels.create_model(family, **kw).init)(
        jax.random.PRNGKey(1), js, jgraph.knn_mask(js.pos, 4))
    # float32, as a run keeps them (with 64-bit mode on, as in these tests,
    # flax makes the instance norm's ones and zeros float64)
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), params)
    assert weights.jax_family(params) == family
    model = tmodels.create_model(family, device="cpu", **kw)
    model.load_state_dict(weights.params_from_jax(params, family))
    back = weights.params_to_jax(model.state_dict())
    assert weights.jax_family(back) == family
    _assert_same_tree(params, back)


def test_family_is_named_or_found_and_others_raise(payload):
    params = payload["params"]
    with pytest.raises(NotImplementedError, match="'schnet' is not ported"):
        weights.params_from_jax(params, "schnet")
    with pytest.raises(ValueError, match="segnn tree, not seconv"):
        weights.params_from_jax(params, "seconv")
    with pytest.raises(ValueError, match="segnn tree, not ponita"):
        weights.opt_state_from_jax(payload["opt_state"], "ponita")
    seconv = tmodels.create_model("seconv", device="cpu", num_layers=1,
                                  hidden_features=16).state_dict()
    assert weights.port_family(seconv) == "seconv"
    with pytest.raises(ValueError, match="seconv tree, not segnn"):
        weights.params_to_jax(seconv, "segnn")
    assert set(weights.params_to_jax(seconv)["params"]) == {
        "SteerableTensorProduct_0", "Scan_SEConvLayer_0", "SteerableTPSwishGate_0",
        "SteerableTensorProduct_1"}


@pytest.mark.parametrize("family", ["segnn", "seconv"])
def test_flax_layer_paths_name_the_captured_layers(family):
    model = tmodels.create_model(family, device="cpu", num_layers=1, hidden_features=16)
    names = [n for _, ns in weights.flax_layer_paths(model) for n in ns]
    first, pool1, pool2 = (("embedding", "pre_pool1", "pre_pool2") if family == "segnn" else
                           ("SteerableTensorProduct_0", "SteerableTPSwishGate_0",
                            "SteerableTensorProduct_1"))
    assert names == [first, f"{pool1}/SteerableTensorProduct_0", f"{pool1}/GateActivation_0",
                     pool1, pool2, ""]
