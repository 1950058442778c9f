"""GraphTransformer's weights across the two packages, and its counts.

* The committed 10M checkpoint (``docs/results/gt10m_r5/ckpt_130_model.ckpt``,
  L8 h248, 8 heads of 31, epoch 130) goes through ``params_from_jax`` into
  the port's model (every key, strictly) and back through ``params_to_jax``
  bitwise: ``_EncoderLayer_k`` is the port's ``blocks.k``, the attention's
  ``query`` / ``key`` / ``value`` / ``out`` kernels keep flax's shapes
  (``[248, 8, 31]``, ``[8, 31, 248]``, head-major), ``TorchLinear`` kernels
  are transposed, LayerNorm ``scale`` is ``weight``.
* ``opt_state_from_jax`` maps its AdamW ``mu`` and ``nu`` (count 130000) onto
  the port's parameter names exactly.
* The count is the checkpoint's 10,255,566: the tree's leaves,
  ``count_params`` of the port's model and ``hpo._count_params`` on the meta
  device; the JAX package's count equals the port's at shapes of the HPO
  space.
* The committed checkpoint's eval-mode forward on one small scene (B=2,
  N=5) agrees with the JAX model's within 1e-9 of the largest output in
  float64, and within 1e-4 in float32; a head projection of the port's model
  is the JAX kernel read head-major (feature ``h * 31 + d``).
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
CKPT = os.path.join(REPO, "docs", "results", "gt10m_r5", "ckpt_130_model.ckpt")
L8H248 = dict(num_layers=8, hidden_features=248, num_heads=8)
N_PARAMS = 10_255_566
F64_RTOL, F32_RTOL = 1e-9, 1e-4


@pytest.fixture(scope="module")
def payload():
    return weights.read_checkpoint(CKPT)


@pytest.fixture(scope="module")
def committed_model(payload):
    model = tmodels.create_model("graph_transformer", device="cpu", **L8H248)
    model.load_state_dict(weights.params_from_jax(payload["params"], "graph_transformer"))
    return model.eval()


def _same_tree(a, b):
    fa = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(a)}
    fb = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(b)}
    assert set(fa) == set(fb)
    for k, v in fa.items():
        assert np.asarray(v).dtype == np.asarray(fb[k]).dtype, k
        assert np.array_equal(np.asarray(v), np.asarray(fb[k])), k


def test_committed_checkpoint_round_trips_bitwise(payload, committed_model):
    assert weights.jax_family(payload["params"]) == "graph_transformer"
    sd = committed_model.state_dict()
    assert weights.port_family(sd) == "graph_transformer"
    _same_tree(payload["params"], weights.params_to_jax(sd))
    params = payload["params"]["params"]
    layer = params["_EncoderLayer_6"]
    attn = layer["MultiHeadDotProductAttention_0"]
    np.testing.assert_array_equal(
        sd["blocks.6.MultiHeadDotProductAttention_0.query.kernel"].numpy(),
        attn["query"]["kernel"])
    assert sd["blocks.6.MultiHeadDotProductAttention_0.out.kernel"].shape == (8, 31, 248)
    np.testing.assert_array_equal(sd["blocks.6.TorchLinear_0.weight"].numpy(),
                                  layer["TorchLinear_0"]["Dense_0"]["kernel"].T)
    np.testing.assert_array_equal(sd["blocks.6.LayerNorm_1.weight"].numpy(),
                                  layer["LayerNorm_1"]["scale"])
    np.testing.assert_array_equal(sd["MLP_0.layers.2.weight"].numpy(),
                                  params["MLP_0"]["TorchLinear_2"]["Dense_0"]["kernel"].T)
    np.testing.assert_array_equal(sd["TorchLinear_0.bias"].numpy(),
                                  params["TorchLinear_0"]["Dense_0"]["bias"])


def test_head_projections_are_read_head_major(committed_model):
    """The projection's feature ``h * 31 + d`` is head ``h``'s ``d``: the
    per-head query equals the input times that head's kernel slice."""
    mha = committed_model.blocks[3].MultiHeadDotProductAttention_0
    x = torch.randn(2, 5, 248, generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    with torch.no_grad():
        q = mha.query(x)  # the float32 parameters applied in the input's float64
    k, b = mha.query.kernel.detach().double(), mha.query.bias.detach().double()
    for h in (0, 5, 7):
        want = x @ k[:, h, :] + b[h]
        torch.testing.assert_close(q[:, :, h, :], want, rtol=1e-12, atol=1e-12)


def test_adamw_state_maps_onto_the_port_names(payload, committed_model):
    count, mu, nu = weights.opt_state_from_jax(payload["opt_state"], "graph_transformer")
    assert count == 130_000
    names = {n for n, _ in committed_model.named_parameters()}
    assert set(mu) == set(nu) == names
    adam = weights._find_adam(payload["opt_state"])
    np.testing.assert_array_equal(
        mu["blocks.2.MultiHeadDotProductAttention_0.value.bias"].numpy(),
        adam[1]["params"]["_EncoderLayer_2"]["MultiHeadDotProductAttention_0"]["value"]["bias"])
    np.testing.assert_array_equal(
        nu["MLP_0.layers.1.weight"].numpy(),
        adam[2]["params"]["MLP_0"]["TorchLinear_1"]["Dense_0"]["kernel"].T)
    for k in mu:
        assert mu[k].shape == nu[k].shape == committed_model.state_dict()[k].shape, k


def test_the_count_is_the_checkpoints(payload, committed_model):
    tree = sum(int(np.prod(np.shape(v))) for v in jax.tree_util.tree_leaves(payload["params"]))
    assert tree == N_PARAMS
    assert tmodels.count_params(committed_model) == N_PARAMS
    assert TH._count_params("graph_transformer", L8H248, 5) == N_PARAMS
    assert sum(p.numel() for p in committed_model.parameters()) == N_PARAMS
    assert not list(committed_model.buffers())
    assert committed_model.get_model_size() == 248


@pytest.mark.parametrize("kw", [dict(hidden_features=176, num_layers=6, num_heads=4),
                                dict(hidden_features=256, num_layers=10, num_heads=8),
                                dict(hidden_features=64, num_layers=8, num_heads=4)])
def test_counts_equal_the_jax_packages(kw):
    assert (TH._count_params("graph_transformer", kw, 5)
            == JH._count_params("graph_transformer", kw, 5))


def _small_scene(seed=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, 5, 3)) * 2.0, rng.normal(size=(2, 5, 3)) * 0.3,
            np.zeros((2, 5, 3)), np.ones((2, 5, 1))]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_committed_forward_matches_jax(payload, committed_model, dtype):
    arrs = [a.astype(dtype) for a in _small_scene()]
    js = JScene(*(jnp.asarray(a) for a in arrs))
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, dtype), payload["params"])
    jm = jmodels.create_model("graph_transformer", **L8H248)
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


@pytest.mark.parametrize("kw", [dict(hidden_features=12, num_layers=2, num_heads=3),
                                dict(hidden_features=8, num_layers=1, num_heads=1,
                                     dim_feedforward=4, num_targets=1)])
def test_small_trees_round_trip_with_the_jax_shapes(kw):
    torch.manual_seed(1)
    model = tmodels.create_model("graph_transformer", device="cpu", **kw)
    tree = weights.params_to_jax(model.state_dict(), "graph_transformer")
    back = weights.params_from_jax(tree, "graph_transformer")
    assert list(back) == list(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k
    scene = JScene.stationary(2, 5)
    jm = jmodels.create_model("graph_transformer", **kw)
    init = jax.eval_shape(jm.init, jax.random.PRNGKey(0), scene, jgraph.knn_mask(scene.pos, 4))
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), init["params"])
    assert jax.tree_util.tree_map(np.shape, tree["params"]) == shapes


def test_family_is_named_or_found_and_others_raise(payload):
    params = payload["params"]
    with pytest.raises(NotImplementedError, match="'schnet' is not ported"):
        weights.params_from_jax(params, "schnet")
    with pytest.raises(ValueError, match="graph_transformer tree, not painn"):
        weights.params_from_jax(params, "painn")
    with pytest.raises(ValueError, match="graph_transformer tree, not equiformer_v2"):
        weights.opt_state_from_jax(payload["opt_state"], "equiformer_v2")
    small = tmodels.create_model("graph_transformer", device="cpu", hidden_features=8,
                                 num_layers=1, num_heads=2)
    with pytest.raises(ValueError, match="graph_transformer tree, not egnn_mc"):
        weights.params_to_jax(small.state_dict(), "egnn_mc")
