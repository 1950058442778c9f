"""PONITA's weights across the two packages, and its parameter counts.

* The committed 10M checkpoint's params tree goes through
  ``params_from_jax`` into the port's model and back through
  ``params_to_jax`` bitwise, its ``calib`` collection included (each
  statistic a 1-tuple of a 0-d float32 array, as flax sows it).
* ``opt_state_from_jax`` maps its AdamW ``mu`` and ``nu`` onto the port's
  parameter names, exactly (transposes aside), the ``calib`` entries left out.
* The converter's family: named or found in the tree; a family the port does
  not build, a tree of none, and a tree of another family than the one named
  all raise.
* ``hpo._count_params("ponita", ...)`` equals the JAX package's count (every
  leaf of ``model.init``, the 3 calib statistics a layer included) at three
  shapes, and is 9,990,041 at L5 h480.
"""

import importlib
import os

import numpy as np
import pytest
import torch

TPU = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu"
PORT = TPU + "_torch"
JH = importlib.import_module(TPU + ".hpo.hpo")
TH = importlib.import_module(PORT + ".hpo.hpo")
tmodels = importlib.import_module(PORT + ".models")
weights = importlib.import_module(PORT + ".weights")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "docs", "results", "ponita10m_r5_partial", "model.ckpt")
L5H480 = dict(num_layers=5, hidden_features=480)


@pytest.fixture(scope="module")
def payload():
    return weights.read_checkpoint(CKPT)


def _assert_same_tree(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), path
        for x, y in zip(a, b):
            _assert_same_tree(x, y, path)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), path


def test_committed_tree_round_trips_bitwise(payload):
    params = payload["params"]
    assert weights.jax_family(params) == "ponita" and set(params) == {"params", "calib"}
    model = tmodels.create_model("ponita", device="cpu", **L5H480)
    model.load_state_dict(weights.params_from_jax(params, "ponita"))
    back = weights.params_to_jax(model.state_dict())
    _assert_same_tree(params, back)
    # straight from the mapped state_dict, no model in between
    _assert_same_tree(params, weights.params_to_jax(weights.params_from_jax(params)))


def test_uncalibrated_model_writes_ones():
    sd = tmodels.create_model("ponita", device="cpu", num_layers=2, hidden_features=16).state_dict()
    tree = weights.params_to_jax(sd)
    stats = tree["calib"]["_ConvNextBlock_1"]["_FiberBundleConv_0"]
    assert set(stats) == {"std_in", "std_1", "std_2"}
    assert all(v[0].dtype == np.float32 and v[0].shape == () and v[0] == 1.0
               for v in stats.values())
    # a dict of the parameters alone (no buffers) gets ones too
    names = [n for n, _ in tmodels.create_model("ponita", device="cpu", num_layers=2,
                                                hidden_features=16).named_parameters()]
    only = weights.params_to_jax({n: sd[n] for n in names})
    _assert_same_tree(only["calib"], tree["calib"])


def test_opt_state_maps_mu_and_nu_to_the_ports_names(payload):
    count, mu, nu = weights.opt_state_from_jax(payload["opt_state"], "ponita")
    adam = payload["opt_state"][0][0]
    assert count == int(np.asarray(adam[0])) == 90000
    model = tmodels.create_model("ponita", device="cpu", **L5H480)
    names = {n for n, _ in model.named_parameters()}
    assert set(mu) == set(nu) == names  # no calib entry
    jmu = adam[1]["params"]
    np.testing.assert_array_equal(mu["blocks.3.mlp_in.weight"].numpy(),
                                  jmu["_ConvNextBlock_3"]["TorchLinear_0"]["Dense_0"]["kernel"].T)
    np.testing.assert_array_equal(nu["embedding.kernel"].numpy(),
                                  adam[2]["params"]["Dense_0"]["kernel"])
    np.testing.assert_array_equal(mu["blocks.0.layer_scale"].numpy(),
                                  jmu["_ConvNextBlock_0"]["layer_scale"])
    for k in mu:
        assert mu[k].shape == nu[k].shape == model.state_dict()[k].shape, k


def test_family_is_named_or_found_and_others_raise(payload):
    params = payload["params"]
    with pytest.raises(NotImplementedError, match="'schnet' is not ported"):
        weights.params_from_jax(params, "schnet")
    with pytest.raises(ValueError, match="ponita tree, not egnn_mc"):
        weights.params_from_jax(params, "egnn_mc")
    with pytest.raises(ValueError, match="no ported family"):
        weights.params_from_jax({"params": {"Dense_0": {"kernel": np.zeros((2, 2))}}})
    with pytest.raises(ValueError, match="no ported family"):
        weights.params_to_jax({"w": torch.zeros(2)})
    egnn = tmodels.create_model("egnn_mc", device="cpu", num_layers=1).state_dict()
    assert weights.port_family(egnn) == "egnn_mc"
    assert weights.jax_family(weights.params_to_jax(egnn)) == "egnn_mc"
    with pytest.raises(ValueError, match="egnn_mc tree, not ponita"):
        weights.params_to_jax(egnn, "ponita")


@pytest.mark.parametrize("kw", [dict(num_layers=2, hidden_features=16, num_ori=6, basis_dim=16),
                                dict(num_layers=3, hidden_features=32, multiple_readouts=False),
                                dict(num_layers=4, hidden_features=48, layer_scale=0.0)])
def test_count_params_matches_jax(kw):
    want = JH._count_params("ponita", kw, 5)
    assert TH._count_params("ponita", kw, 5) == want
    params = sum(p.numel() for p in tmodels.create_model("ponita", device="cpu", **kw).parameters())
    assert want - params == 3 * kw["num_layers"]


def test_count_params_of_the_committed_shape():
    assert TH._count_params("ponita", L5H480, 5) == 9_990_041
    with torch.device("meta"):
        model = tmodels.create_model("ponita", device="meta", **L5H480)
    assert sum(p.numel() for p in model.parameters()) == 9_990_026
    assert tmodels.count_params(model) == 9_990_041


def test_flax_layer_paths_name_every_top_level_layer_once():
    model = tmodels.create_model("ponita", device="cpu", num_layers=2, hidden_features=16,
                                 multiple_readouts=False)
    names = [n for _, ns in weights.flax_layer_paths(model) for n in ns]
    assert len(names) == len(set(names))
    assert {"Dense_0", "_BasisNet_0", "_BasisNet_0/TorchLinear_1", "_ConvNextBlock_1",
            "_ConvNextBlock_1/_FiberBundleConv_0", "_ConvNextBlock_1/TorchLinear_1",
            "TorchLinear_0", "TorchLinear_0/Dense_0", ""} <= set(names)
    assert "TorchLinear_1" not in names  # one readout
