"""EquiformerV2's weights across the two packages, and its counts.

* The committed 10M checkpoint
  (``docs/results/eqv2_10m_L8c128_cont/ckpt_130_model.ckpt``, L8 c128,
  epoch 130) goes through ``params_from_jax`` into the port's model (every
  key, strictly) and back through ``params_to_jax`` bitwise; its
  ``Scan_TransBlock_0`` leaves are split into the eight blocks on the way in
  and stacked on the way out, its ``Dense`` and ``TorchLinear`` kernels
  transposed.
* ``opt_state_from_jax`` maps its AdamW ``mu`` and ``nu`` (count 130000) onto
  the port's parameter names exactly.
* The count is the checkpoint's 9,689,010: the tree's leaves,
  ``count_params`` of the port's model, and ``hpo._count_params`` on the meta
  device; the Wigner tensor, the grid matrices and the index tables are in no
  ``state_dict``.  The JAX package's count equals the port's at shapes of the
  HPO space.
* The committed checkpoint's eval-mode forward on one small scene (B=2, N=5)
  agrees with the JAX model's within 1e-9 of the largest output in float64,
  and within 1e-4 in float32 (eight blocks of f32 sums taken in other orders).
* Small trees of every option (shared atom-edge embeddings, the gaussian and
  exponential-decay distances, the equivariant velocity gate, the gate and
  grid-MLP activations, ``use_m_share_rad``, no attention renorm) round-trip
  bitwise and have the JAX model's shapes.
* The family is named or found by its marker; a tree of another family than
  the one named raises and names both.
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
CKPT = os.path.join(REPO, "docs", "results", "eqv2_10m_L8c128_cont", "ckpt_130_model.ckpt")
L8C128 = dict(num_layers=8, sphere_channels=128, attn_hidden_channels=128,
              ffn_hidden_channels=128, num_heads=8, remat=True)
N_PARAMS = 9_689_010
SMALL = dict(num_layers=2, sphere_channels=8, attn_hidden_channels=8, ffn_hidden_channels=8,
             num_heads=2, edge_channels=8)
F64_RTOL, F32_RTOL = 1e-9, 1e-4


@pytest.fixture(scope="module")
def payload():
    return weights.read_checkpoint(CKPT)


@pytest.fixture(scope="module")
def committed_model(payload):
    model = tmodels.create_model("equiformer_v2", device="cpu", **L8C128)
    model.load_state_dict(weights.params_from_jax(payload["params"], "equiformer_v2"))
    return model.eval()


def _same_tree(a, b):
    fa = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(a)}
    fb = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(b)}
    assert set(fa) == set(fb)
    for k, v in fa.items():
        assert np.asarray(v).dtype == np.asarray(fb[k]).dtype, k
        assert np.array_equal(np.asarray(v), np.asarray(fb[k])), k


def test_committed_checkpoint_round_trips_bitwise(payload, committed_model):
    assert weights.jax_family(payload["params"]) == "equiformer_v2"
    back = weights.params_to_jax(committed_model.state_dict())
    assert weights.port_family(committed_model.state_dict()) == "equiformer_v2"
    _same_tree(payload["params"], back)
    params = payload["params"]["params"]
    sd = committed_model.state_dict()
    scan = params["Scan_TransBlock_0"]
    np.testing.assert_array_equal(
        sd["blocks.5.SO2Attention_0.SO2Conv_0.Dense_0.weight"].numpy(),
        scan["SO2Attention_0"]["SO2Conv_0"]["Dense_0"]["kernel"][5].T)
    np.testing.assert_array_equal(
        sd["blocks.7.FeedForward_0.TorchLinear_0.weight"].numpy(),
        scan["FeedForward_0"]["TorchLinear_0"]["Dense_0"]["kernel"][7].T)
    np.testing.assert_array_equal(sd["TorchLinear_1.weight"].numpy(),
                                  params["TorchLinear_1"]["Dense_0"]["kernel"].T)
    np.testing.assert_array_equal(sd["blocks.2.RMSNormSH_1.affine_weight"].numpy(),
                                  scan["RMSNormSH_1"]["affine_weight"][2])


def test_adamw_state_maps_onto_the_port_names(payload, committed_model):
    count, mu, nu = weights.opt_state_from_jax(payload["opt_state"], "equiformer_v2")
    assert count == 130_000
    names = {n for n, _ in committed_model.named_parameters()}
    assert set(mu) == set(nu) == names
    adam = weights._find_adam(payload["opt_state"])
    np.testing.assert_array_equal(
        mu["blocks.3.SO2Attention_0.alpha_dot"].numpy(),
        adam[1]["params"]["Scan_TransBlock_0"]["SO2Attention_0"]["alpha_dot"][3])
    np.testing.assert_array_equal(
        nu["SO2Attention_0.SO2Conv_1.Dense_0.weight"].numpy(),
        adam[2]["params"]["SO2Attention_0"]["SO2Conv_1"]["Dense_0"]["kernel"].T)
    for k in mu:
        assert mu[k].shape == nu[k].shape == committed_model.state_dict()[k].shape, k


def test_the_count_is_the_checkpoints(payload, committed_model):
    tree = sum(int(np.prod(np.shape(v))) for v in jax.tree_util.tree_leaves(payload["params"]))
    assert tree == N_PARAMS
    assert tmodels.count_params(committed_model) == N_PARAMS
    assert TH._count_params("equiformer_v2", L8C128, 5) == N_PARAMS
    assert sum(p.numel() for p in committed_model.parameters()) == N_PARAMS
    assert not list(committed_model.buffers())
    assert committed_model.get_model_size() == 128


@pytest.mark.parametrize("kw", [dict(num_layers=6, sphere_channels=112, num_heads=4),
                                dict(num_layers=10, sphere_channels=192, num_heads=8),
                                dict(num_layers=3, sphere_channels=48, num_heads=4,
                                     use_gate_act=True)])
def test_counts_equal_the_jax_packages(kw):
    kw = {**kw, "attn_hidden_channels": kw["sphere_channels"],
          "ffn_hidden_channels": kw["sphere_channels"]}
    assert TH._count_params("equiformer_v2", kw, 5) == JH._count_params("equiformer_v2", kw, 5)


def _small_scene(seed=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, 5, 3)) * 2.0, rng.normal(size=(2, 5, 3)) * 0.3,
            np.zeros((2, 5, 3)), np.ones((2, 5, 1))]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_committed_forward_matches_jax(payload, committed_model, dtype):
    arrs = [a.astype(dtype) for a in _small_scene()]
    js = JScene(*(jnp.asarray(a) for a in arrs))
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, dtype), payload["params"])
    jm = jmodels.create_model("equiformer_v2", **L8C128)
    want = np.asarray(jm.apply(params, js, jgraph.knn_mask(js.pos, 4)))
    model = committed_model.to(getattr(torch, dtype))
    ts = Scene(*(torch.from_numpy(a) for a in arrs))
    try:
        with torch.no_grad():
            got = model(ts, tgraph.knn_mask(ts.pos, 4)).numpy()
    finally:
        committed_model.float()
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert np.isfinite(got).all() and scale > 0
    assert err <= (F64_RTOL if dtype == "float64" else F32_RTOL) * scale, (err, scale)


SMALL_CASES = [dict(share_atom_edge_embedding=True), dict(distance_function="gaussian"),
               dict(distance_function="exponential_decay", equivariant_embedding=True),
               dict(use_gate_act=True), dict(use_grid_mlp=True), dict(use_m_share_rad=True),
               dict(use_attn_renorm=False, use_atom_edge_embedding=False)]


@pytest.mark.parametrize("kw", SMALL_CASES, ids=lambda k: "+".join(sorted(k)))
def test_small_trees_round_trip_with_the_jax_shapes(kw):
    torch.manual_seed(1)
    model = tmodels.create_model("equiformer_v2", device="cpu", **SMALL, **kw)
    tree = weights.params_to_jax(model.state_dict(), "equiformer_v2")
    back = weights.params_from_jax(tree, "equiformer_v2")
    assert set(back) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k
    scene = JScene.stationary(2, 5)
    jm = jmodels.create_model("equiformer_v2", **SMALL, **kw)
    init = jax.eval_shape(jm.init, jax.random.PRNGKey(0), scene, jgraph.knn_mask(scene.pos, 4))
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), init["params"])
    assert jax.tree_util.tree_map(np.shape, tree["params"]) == shapes


def test_family_is_named_or_found_and_others_raise(payload):
    params = payload["params"]
    with pytest.raises(NotImplementedError, match="'schnet' is not ported"):
        weights.params_from_jax(params, "schnet")
    with pytest.raises(ValueError, match="equiformer_v2 tree, not segnn"):
        weights.params_from_jax(params, "segnn")
    with pytest.raises(ValueError, match="equiformer_v2 tree, not ponita"):
        weights.opt_state_from_jax(payload["opt_state"], "ponita")
    segnn = tmodels.create_model("segnn", device="cpu", num_layers=1, hidden_features=16)
    with pytest.raises(ValueError, match="segnn tree, not equiformer_v2"):
        weights.params_from_jax(weights.params_to_jax(segnn.state_dict()), "equiformer_v2")
    small = tmodels.create_model("equiformer_v2", device="cpu", **SMALL)
    with pytest.raises(ValueError, match="equiformer_v2 tree, not egnn_mc"):
        weights.params_to_jax(small.state_dict(), "egnn_mc")
