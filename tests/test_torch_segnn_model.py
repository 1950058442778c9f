"""The port's SEGNN and SEConv against the JAX package's, float64 on the CPU.

A small model (2 layers, width 16, so hidden irreps 8x0e+8x1o at lmax 1)
gets the port's seeded float64 initialisation, carried to the JAX model with
``weights.params_to_jax`` (a flax ``init`` costs seconds of compilation a
configuration); both packages then run on the same scene, made with numpy
from a seed.

* SEGNN's forward agrees within 1e-10 of the largest output (relative), on
  N=5 fully connected and on N=8 with a k=3 nearest-neighbour mask that is
  not symmetric (the only graph that tells SEGNN's receiver/sender direction
  from EGNN-MC's; a transposed mask is caught), for both ``center_mode``s,
  ``use_force_input``, ``normalization_type="instance"``, lmax 2 and
  ``remat``.
* SEConv, ``linear`` and ``nonlinear``, on both graphs, the same.
* The gradient of a scalar loss for every parameter (``torch.autograd``
  against ``jax.grad``) agrees within 1e-9 of each tensor's largest value
  (or of 1e-6 of the largest gradient, for a gradient that is zero in exact
  arithmetic), with and without ``remat``; the gradients with respect to the positions
  and velocities are finite through the zero diagonal of ``rel``.
* With ``center_mode="nodes"`` a rotation with a reflection of the inputs
  moves both output vectors the same way within 1e-12 (exact O(3)
  equivariance); the default ``"coords"`` does not (the reference's quirk).
* ``layer_stats.capture`` gives the keys of the JAX trainer's
  ``_build_layer_stats_fn`` and its values within 1e-9 relative.
"""

import functools
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
tsegnn = importlib.import_module(PORT + ".models.segnn")
weights = importlib.import_module(PORT + ".weights")
TLS = importlib.import_module(PORT + ".evaluation.layer_stats")

SMALL = dict(num_layers=2, hidden_features=16)
OUT_RTOL, GRAD_RTOL, STATS_RTOL, EQUIV_RTOL = 1e-10, 1e-9, 1e-9, 1e-12
B = 3
GRAPHS = {"fc5": (5, 4), "knn8": (8, 3)}  # N, k
SEGNN_CASES = {
    "default": {},
    "nodes": dict(center_mode="nodes"),
    "force": dict(use_force_input=True),
    "instance": dict(normalization_type="instance"),
    "lmax2": dict(lmax_attr=2, lmax_h=2),
    "remat": dict(remat=True),
}


def _arrays(n, seed=0, b=B):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(b, n, 3)) * (n / 5.0) ** (1 / 3)
    vel = rng.normal(size=(b, n, 3))
    force = rng.normal(size=(b, n, 3))
    mass = rng.random((b, n, 1)) + 0.5
    return pos, vel, force, mass


def _scenes(arrs):
    return JScene(*(jnp.asarray(a) for a in arrs)), Scene(*(torch.from_numpy(a) for a in arrs))


@functools.lru_cache(maxsize=None)
def _pair(family="segnn", graph="fc5", seed=0, **kw):
    """The JAX model, its float64 params, the port's model carrying them, and
    the graph's scene arrays and masks."""
    n, k = GRAPHS[graph]
    cfg = {**SMALL, **kw}
    arrs = _arrays(n, seed)
    js, ts = _scenes(arrs)
    jmask = jgraph.knn_mask(js.pos, k)
    jm = jmodels.create_model(family, **cfg)
    torch.manual_seed(seed)
    tm = tmodels.create_model(family, device="cpu", dtype=torch.float64, **cfg)
    params = weights.params_to_jax(tm.state_dict(), family)
    return jm, params, tm, arrs, jmask, tgraph.knn_mask(ts.pos, k)


def _assert_rel(got, want, rtol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale, f"{what}: max abs err {err}, max |want| {scale}"


def _forward(family, graph, **kw):
    jm, params, tm, arrs, jmask, tmask = _pair(family, graph, **kw)
    js, ts = _scenes(arrs)
    want = np.asarray(jax.jit(jm.apply)(params, js, jmask))
    with torch.no_grad():
        got = tm(ts, tmask).numpy()
    assert got.shape == (B, GRAPHS[graph][0], 6)
    return got, want


def test_knn8_mask_is_not_symmetric():
    *_, tmask = _pair("segnn", "knn8")
    assert not torch.equal(tmask, tmask.transpose(1, 2))


@pytest.mark.parametrize("case", sorted(SEGNN_CASES))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_segnn_forward_matches_jax(graph, case):
    got, want = _forward("segnn", graph, **SEGNN_CASES[case])
    _assert_rel(got, want, OUT_RTOL, f"segnn {case}")


@pytest.mark.parametrize("conv_type", ["linear", "nonlinear"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_seconv_forward_matches_jax(graph, conv_type):
    got, want = _forward("seconv", graph, conv_type=conv_type)
    _assert_rel(got, want, OUT_RTOL, f"seconv {conv_type}")
    _, _, tm, *_ = _pair("seconv", graph, conv_type=conv_type)
    assert (tm.layers[0].message is None) == (conv_type == "linear")


def test_the_models_modules_and_sizes():
    _, _, tm, *_ = _pair("segnn", "fc5", normalization_type="instance")
    assert repr(tm.hidden_irreps) == "8x0e+8x1o" and tm.get_model_size() == 16
    assert len(tm.layers) == 2 and tm.layers[1].norm is not None
    _, _, plain, *_ = _pair("segnn", "fc5")
    assert plain.layers[0].norm is None
    with pytest.raises(NotImplementedError, match="norm 'batch'"):
        tmodels.create_model("segnn", device="cpu", normalization_type="batch", **SMALL)
    with pytest.raises(ValueError, match="Invalid conv_type"):
        tmodels.create_model("seconv", device="cpu", conv_type="other", **SMALL)
    assert tmodels.MODEL_DEFAULTS["segnn"]["num_layers"] == 20
    assert tmodels.MODEL_DEFAULTS["seconv"]["num_layers"] == 8
    assert not tmodels.has_edge_stage(plain)


def test_a_transposed_graph_would_be_caught():
    """On the asymmetric mask the sender/receiver transpose moves the output
    far outside the tolerance."""
    jm, params, tm, arrs, jmask, tmask = _pair("segnn", "knn8")
    js, ts = _scenes(arrs)
    want = np.asarray(jax.jit(jm.apply)(params, js, jmask))
    with torch.no_grad():
        wrong = tm(ts, tmask.transpose(1, 2)).numpy()
    assert np.abs(wrong - want).max() > 1e3 * OUT_RTOL * np.abs(want).max()


@pytest.mark.parametrize("family,graph,kw", [
    ("segnn", "fc5", {}), ("segnn", "knn8", dict(normalization_type="instance")),
    ("segnn", "knn8", dict(remat=True)), ("seconv", "knn8", dict(conv_type="nonlinear"))])
def test_gradients_match_jax(family, graph, kw):
    jm, params, tm, arrs, jmask, tmask = _pair(family, graph, **kw)
    js, ts = _scenes(arrs)
    w = np.random.default_rng(9).normal(size=(B, GRAPHS[graph][0], 6))

    def loss(p):
        out = jm.apply(p, js, jmask)
        return jnp.sum(out * w) + jnp.sum(out**2)

    jgrads = weights.params_from_jax(jax.jit(jax.grad(loss))(params), family)
    tm.zero_grad(set_to_none=True)
    out = tm(ts, tmask)
    (torch.sum(out * torch.from_numpy(w)) + torch.sum(out**2)).backward()
    names = [n for n, _ in tm.named_parameters()]
    assert set(names) == set(jgrads)
    # a gradient that is zero in exact arithmetic (the bias of a scalar the
    # instance norm centres away) is rounding noise in both packages: held to
    # the largest gradient's scale
    floor = 1e-6 * max(g.abs().max().item() for g in jgrads.values())
    for name, p in tm.named_parameters():
        got, want = p.grad.numpy(), jgrads[name].numpy()
        err, scale = np.abs(got - want).max(), max(np.abs(want).max(), floor)
        assert err <= GRAD_RTOL * scale, f"{name}: max abs err {err}, scale {scale}"
    tm.zero_grad(set_to_none=True)


def test_remat_recomputes_the_same_gradients():
    *_, tm, arrs, _, tmask = _pair("segnn", "knn8", remat=True)
    plain = tmodels.create_model("segnn", device="cpu", dtype=torch.float64, **SMALL)
    plain.load_state_dict(tm.state_dict())
    grads = []
    for model in (tm, plain):
        model.zero_grad(set_to_none=True)
        ts = Scene(*(torch.from_numpy(a) for a in arrs))
        (model(ts, tmask) ** 2).sum().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        _assert_rel(g.numpy(), grads[1][name].numpy(), 1e-13, name)


@pytest.mark.parametrize("family", ["segnn", "seconv"])
def test_gradients_are_finite_through_the_zero_diagonal(family):
    """``rel`` is zero on the dense diagonal; the double ``where`` of the SH
    and ``safe_sqrt`` keep the input gradients finite there."""
    *_, tm, arrs, _, tmask = _pair(family, "fc5")
    pos, vel, force, mass = (torch.from_numpy(a).clone().requires_grad_(True) for a in arrs)
    out = tm(Scene(pos, vel, force, mass), tmask)
    (out**2).sum().backward()
    for t in (pos, vel, mass):
        assert torch.isfinite(t.grad).all() and t.grad.abs().max() > 0
    assert all(torch.isfinite(p.grad).all() for p in tm.parameters())
    tm.zero_grad(set_to_none=True)


def _orthogonal(seed):
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    return -q if np.linalg.det(q) > 0 else q  # with a reflection


@pytest.mark.parametrize("family,kw", [("segnn", dict(center_mode="nodes")),
                                       ("segnn", dict(center_mode="nodes", lmax_attr=2,
                                                      lmax_h=2, use_force_input=True)),
                                       ("seconv", dict(center_mode="nodes"))])
def test_o3_equivariance_with_nodes_centring(family, kw):
    *_, tm, arrs, _, _ = _pair(family, "knn8", **kw)
    pos, vel, force, mass = (torch.from_numpy(a) for a in arrs)
    R = torch.from_numpy(_orthogonal(8))
    assert torch.det(R) < 0
    shift = torch.tensor([0.3, -2.0, 1.1], dtype=torch.float64)
    with torch.no_grad():
        out = tm(Scene(pos, vel, force, mass), tgraph.knn_mask(pos, 3))
        rot = Scene(pos @ R.T + shift, vel @ R.T, force @ R.T, mass)
        out_r = tm(rot, tgraph.knn_mask(rot.pos, 3))
    want = torch.cat([out[..., :3] @ R.T, out[..., 3:] @ R.T], dim=-1)
    _assert_rel(out_r.numpy(), want.numpy(), EQUIV_RTOL, "O(3)")


def test_coords_centring_is_not_equivariant():
    *_, tm, arrs, _, _ = _pair("segnn", "fc5")
    pos, vel, force, mass = (torch.from_numpy(a) for a in arrs)
    R = torch.from_numpy(_orthogonal(8))
    with torch.no_grad():
        out = tm(Scene(pos, vel, force, mass), tgraph.knn_mask(pos, 4))
        rot = Scene(pos @ R.T, vel @ R.T, force @ R.T, mass)
        out_r = tm(rot, tgraph.knn_mask(rot.pos, 4))
    want = torch.cat([out[..., :3] @ R.T, out[..., 3:] @ R.T], dim=-1)
    assert (out_r - want).abs().max() > 1e-6 * want.abs().max()


def test_vector_packing_round_trips():
    v = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(tsegnn.irrep1o_to_vec(tsegnn.vec_to_1o(v)), v)
    assert tsegnn.vec_to_1o(v)[0].tolist() == [1.0, 2.0, 0.0]


@pytest.mark.parametrize("family", ["segnn", "seconv"])
def test_layer_stats_match_the_jax_trainers(family):
    jm, params, tm, arrs, jmask, tmask = _pair(family, "knn8")
    js, ts = _scenes(arrs)
    stand_in = SimpleNamespace(model=jm, num_neighbors=GRAPHS["knn8"][1], _data_masks=False)
    want = {k: float(v) for k, v in JT.Trainer._build_layer_stats_fn(stand_in)(params, js).items()}
    got = {k: float(v) for k, v in TLS.capture(tm, ts, tmask).items()}
    assert set(got) == set(want) and len(got) == 3 * 6
    for k, w in want.items():
        assert got[k] == pytest.approx(w, rel=STATS_RTOL, abs=1e-300), k
