"""The port's PONITA against the JAX package's, float64 on the CPU.

A small PONITA (2 layers, width 16, 6 orientations, basis 16) gets random flax
params cast to float64, carried across with ``weights.params_from_jax``; both
packages then run on the same scene, made with numpy from a seed.

* The forward agrees within 1e-10 of the largest output (relative), on N=5
  fully connected and on N=8 with a k=3 nearest-neighbour mask that is not
  symmetric (the only graph that tells PONITA's receiver/sender transpose
  from EGNN-MC's), with ``radius`` None and 2.0, ``layer_scale`` 1e-6 and 0.0,
  and ``multiple_readouts`` on and off.  LayerNorm's variance is taken in
  another order than flax's E[x^2] - E[x]^2: that is rounding, far inside
  1e-10.
* The gradient of a scalar loss for every parameter (``torch.autograd``
  against ``jax.grad``) agrees within 1e-9 of each tensor's largest value.
* ``calibrate_params`` gives the JAX package's kernels within 1e-12 of each
  tensor's largest value, and the JAX model's sown statistics within 1e-12
  relative.  The JAX params come from ``model.init`` on the same scene, as
  in its trainer: its ``calibrate_params`` reads the statistics ``init``
  sowed.
* Rotating the inputs rotates both output vectors, within
  ``tests/test_models.py``'s 5e-2 for PONITA (the grid is only approximately
  uniform).
* The committed 10M checkpoint (``docs/results/ponita10m_r5_partial``, L5
  h480, 20 orientations) at B=2, N=5 agrees within 1e-10 relative.
* ``layer_stats.capture`` gives the keys of the JAX trainer's
  ``_build_layer_stats_fn`` and its values within 1e-9 relative.
"""

import functools
import importlib
import os
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
jponita = importlib.import_module(TPU + ".models.ponita")
JT = importlib.import_module(TPU + ".train.trainer")
tgraph = importlib.import_module(PORT + ".core.graph")
Scene = importlib.import_module(PORT + ".core.scene").Scene
tmodels = importlib.import_module(PORT + ".models")
tponita = importlib.import_module(PORT + ".models.ponita")
weights = importlib.import_module(PORT + ".weights")
TLS = importlib.import_module(PORT + ".evaluation.layer_stats")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "docs", "results", "ponita10m_r5_partial", "model.ckpt")
SMALL = dict(num_layers=2, hidden_features=16, num_ori=6, basis_dim=16)
OUT_RTOL, GRAD_RTOL, CALIB_RTOL, STATS_RTOL = 1e-10, 1e-9, 1e-12, 1e-9
EQUIV_ATOL = 5e-2
B = 3
GRAPHS = {"fc5": (5, 4), "knn8": (8, 3)}  # N, k


def _arrays(n, seed=0, b=B):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(b, n, 3)) * (n / 5.0) ** (1 / 3)
    vel = rng.normal(size=(b, n, 3))
    mass = rng.random((b, n, 1)) + 0.5
    return pos, vel, np.zeros_like(pos), mass


def _scenes(arrs):
    return JScene(*(jnp.asarray(a) for a in arrs)), Scene(*(torch.from_numpy(a) for a in arrs))


def _f64(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), tree)


@functools.lru_cache(maxsize=None)
def _pair(graph="fc5", seed=0, **kw):
    """The JAX model, its float64 params (from init on the graph's scene),
    the port's model carrying them, and that scene's arrays and masks."""
    n, k = GRAPHS[graph]
    cfg = {**SMALL, **kw}
    arrs = _arrays(n, seed)
    js, ts = _scenes(arrs)
    jmask = jgraph.knn_mask(js.pos, k)
    jm = jmodels.create_model("ponita", **cfg)
    params = _f64(jm.init(jax.random.PRNGKey(seed), js, jmask))
    tm = tmodels.create_model("ponita", device="cpu", dtype=torch.float64, **cfg)
    tm.load_state_dict(weights.params_from_jax(params, "ponita"))
    return jm, params, tm, arrs, jmask, tgraph.knn_mask(ts.pos, k)


def _assert_rel(got, want, rtol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale, f"{what}: max abs err {err}, max |want| {scale}"


def test_knn8_mask_is_not_symmetric():
    *_, tmask = _pair("knn8")
    assert not torch.equal(tmask, tmask.transpose(1, 2))


@pytest.mark.parametrize("multiple_readouts", [True, False])
@pytest.mark.parametrize("layer_scale", [1e-6, 0.0])
@pytest.mark.parametrize("radius", [None, 2.0])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_forward_matches_jax(graph, radius, layer_scale, multiple_readouts):
    jm, params, tm, arrs, jmask, tmask = _pair(graph, radius=radius, layer_scale=layer_scale,
                                              multiple_readouts=multiple_readouts)
    js, ts = _scenes(arrs)
    want = np.asarray(jm.apply(params, js, jmask))
    with torch.no_grad():
        got = tm(ts, tmask).numpy()
    assert got.shape == (B, GRAPHS[graph][0], 6)
    _assert_rel(got, want, OUT_RTOL, "forward")
    assert (tm.blocks[0].layer_scale is None) == (layer_scale == 0.0)
    assert len(tm.readouts) == (SMALL["num_layers"] if multiple_readouts else 1)


def test_a_transposed_graph_would_be_caught():
    """On the asymmetric mask the sender/receiver transpose moves the output far
    outside the tolerance."""
    jm, params, tm, arrs, jmask, tmask = _pair("knn8", layer_scale=0.0)
    js, ts = _scenes(arrs)
    want = np.asarray(jm.apply(params, js, jmask))
    with torch.no_grad():
        wrong = tm(ts, tmask.transpose(1, 2)).numpy()
    assert np.abs(wrong - want).max() > 1e3 * OUT_RTOL * np.abs(want).max()


@pytest.mark.parametrize("graph,kw", [("fc5", {}), ("knn8", dict(radius=2.0, layer_scale=0.0))])
def test_gradients_match_jax(graph, kw):
    jm, params, tm, arrs, jmask, tmask = _pair(graph, **kw)
    js, ts = _scenes(arrs)
    w = np.random.default_rng(9).normal(size=(B, GRAPHS[graph][0], 6))

    def loss(p):
        return jnp.sum(jm.apply(p, js, jmask) * w) + jnp.sum(jm.apply(p, js, jmask) ** 2)

    jgrads = weights.params_from_jax(jax.grad(loss)(params), "ponita", calib=False)
    tm.zero_grad(set_to_none=True)
    out = tm(ts, tmask)
    (torch.sum(out * torch.from_numpy(w)) + torch.sum(out**2)).backward()
    names = [n for n, _ in tm.named_parameters()]
    assert set(names) == set(jgrads)
    for name, p in tm.named_parameters():
        _assert_rel(p.grad.numpy(), jgrads[name].numpy(), GRAD_RTOL, name)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_calibration_matches_jax(graph):
    jm, params, _, arrs, jmask, tmask = _pair(graph)
    js, ts = _scenes(arrs)
    want = weights.params_from_jax(jponita.calibrate_params(jm, params, js, jmask), "ponita",
                                   calib=False)
    tm = tmodels.create_model("ponita", device="cpu", dtype=torch.float64, **SMALL)
    tm.load_state_dict(weights.params_from_jax(params, "ponita"))
    tm.train()
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    assert tponita.calibrate_params(tm, ts, tmask) is tm
    assert tm.training  # the mode it had
    got = tm.state_dict()
    for name, w in want.items():
        _assert_rel(got[name].numpy(), w.numpy(), CALIB_RTOL, name)
    assert not torch.equal(got["blocks.0.conv.spatial.kernel"],
                           before["blocks.0.conv.spatial.kernel"])
    assert torch.equal(got["blocks.0.mlp_in.weight"], before["blocks.0.mlp_in.weight"])
    # the statistics: the ones the JAX model sowed on this scene
    for k in range(SMALL["num_layers"]):
        sown = params["calib"][f"_ConvNextBlock_{k}"]["_FiberBundleConv_0"]
        for stat in tponita.CALIB_STATS:
            s = float(getattr(tm.blocks[k].conv, stat))
            assert s > 0 and abs(s - float(sown[stat][0])) <= CALIB_RTOL * s, (k, stat)


def _rotation(seed):
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    return q if np.linalg.det(q) > 0 else -q


def test_rotation_equivariance():
    _, _, tm, arrs, _, _ = _pair("fc5")
    pos, vel, force, mass = (torch.from_numpy(a) for a in arrs)
    R = torch.from_numpy(_rotation(8))
    with torch.no_grad():
        out = tm(Scene(pos, vel, force, mass), tgraph.knn_mask(pos, 4))
        rot = Scene(pos @ R.T, vel @ R.T, force @ R.T, mass)
        out_r = tm(rot, tgraph.knn_mask(rot.pos, 4))
    want = torch.cat([out[..., :3] @ R.T, out[..., 3:] @ R.T], dim=-1)
    np.testing.assert_allclose(out_r.numpy(), want.numpy(), atol=EQUIV_ATOL)


def test_polynomial_features_match_jax():
    x = np.random.default_rng(5).normal(size=(4, 3, 2))
    for degree in (1, 2, 3):
        got = tponita.polynomial_features(torch.from_numpy(x), degree)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jponita.polynomial_features(jnp.asarray(x), degree)),
                                   rtol=1e-15, atol=0)
    assert got.shape == (4, 3, 2 + 4 + 8)


def test_orientation_grid_is_made_once_per_device_and_dtype():
    _, _, tm, arrs, _, tmask = _pair("fc5")
    ts = Scene(*(torch.from_numpy(a) for a in arrs))
    with torch.no_grad():
        tm(ts, tmask)
        grid = tm.orientations(ts.pos)
        tm(ts, tmask)
    assert tm.orientations(ts.pos) is grid and grid.dtype == torch.float64
    assert tm.orientations(ts.pos.float()).dtype == torch.float32
    assert not any("grid" in k or "ori" in k for k in tm.state_dict())


def test_committed_checkpoint_forward_matches_jax():
    payload = weights.read_checkpoint(CKPT)
    jm = jmodels.create_model("ponita", num_layers=5, hidden_features=480)
    params = _f64(payload["params"])
    tm = tmodels.create_model("ponita", device="cpu", dtype=torch.float64, num_layers=5,
                              hidden_features=480)
    tm.load_state_dict(weights.params_from_jax(payload["params"], "ponita"))
    arrs = _arrays(5, seed=11, b=2)
    js, ts = _scenes(arrs)
    want = np.asarray(jm.apply(params, js, jgraph.knn_mask(js.pos, 4)))
    with torch.no_grad():
        got = tm(ts, tgraph.knn_mask(ts.pos, 4)).numpy()
    assert np.isfinite(got).all() and tm.num_ori == 20
    _assert_rel(got, want, OUT_RTOL, "committed checkpoint")


def test_layer_stats_match_the_jax_trainers():
    jm, params, tm, arrs, jmask, tmask = _pair("knn8")
    js, ts = _scenes(arrs)
    stand_in = SimpleNamespace(model=jm, num_neighbors=GRAPHS["knn8"][1], _data_masks=False)
    want = {k: float(v) for k, v in JT.Trainer._build_layer_stats_fn(stand_in)(params, js).items()}
    got = {k: float(v) for k, v in TLS.capture(tm, ts, tmask).items()}
    assert set(got) == set(want)
    for name in ("Dense_0", "_BasisNet_1/TorchLinear_0", "_ConvNextBlock_1/_FiberBundleConv_0",
                 "_ConvNextBlock_0/LayerNorm_0", "TorchLinear_1/Dense_0", ""):
        assert f"{name}.std" in got
    for k, w in want.items():
        assert got[k] == pytest.approx(w, rel=STATS_RTOL, abs=1e-300), k
