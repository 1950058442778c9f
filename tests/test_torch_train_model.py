"""The dense edge stage that training differentiates, against the JAX package.

``EGNNMC(edge_impl="dense")`` is the JAX model's XLA edge stage
(``use_pallas=False``) written in torch ops.  At the same parameters (flax
params cast to float64 and carried across with ``weights.params_from_jax``),
in float64 on a small model (2 layers, width 16, N=5, B=4): outputs agree
within 1e-10 relative, and the gradients of a scalar loss for every parameter
(``torch.autograd`` against ``jax.grad``, mapped through ``params_from_jax``)
within 1e-9 of each tensor's largest value.  ``remat=True`` gives bitwise the
same loss and gradients, and on the CPU the dense and the kernel forms give
the same output.
"""

import importlib

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
tgraph = importlib.import_module(PORT + ".core.graph")
Scene = importlib.import_module(PORT + ".core.scene").Scene
tmodels = importlib.import_module(PORT + ".models")
weights = importlib.import_module(PORT + ".weights")

SMALL = dict(num_layers=2, hidden_node_dim=16, hidden_edge_dim=16, hidden_coord_dim=16)
B, N = 4, 5
OUT_RTOL = 1e-10
GRAD_RTOL = 1e-9


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(B, N, 3)) * (N / 5.0) ** (1 / 3)
    vel = rng.normal(size=(B, N, 3))
    return pos, vel, np.zeros_like(pos), np.ones((B, N, 1))


def _pair(k=N - 1, seed=0, **kw):
    """The JAX model with float64 params, the port's dense model with the same
    params, and one scene for both."""
    arrs = _arrays(seed)
    js = JScene(*(jnp.asarray(a) for a in arrs))
    jmask = jgraph.knn_mask(js.pos, k)
    jm = jmodels.create_model("egnn_mc", **SMALL)
    params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64),
                                    jm.init(jax.random.PRNGKey(seed), js, jmask))
    tm = tmodels.create_model("egnn_mc", device="cpu", dtype=torch.float64,
                              edge_impl="dense", **SMALL, **kw)
    tm.load_state_dict(weights.params_from_jax(params))
    scene = Scene(*(torch.from_numpy(a) for a in arrs))
    return jm, params, js, jmask, tm, scene, tgraph.knn_mask(scene.pos, k)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("k", [N - 1, 2])
def test_dense_forward_matches_jax(k):
    jm, params, js, jmask, tm, scene, mask = _pair(k)
    want = np.asarray(jm.apply(params, js, jmask))
    with torch.no_grad():
        got = tm(scene, mask).numpy()
    assert _rel(got, want) < OUT_RTOL


@pytest.mark.parametrize("k", [N - 1, 2])
def test_dense_gradients_match_jax_grad(k):
    jm, params, js, jmask, tm, scene, mask = _pair(k, seed=1)
    w = np.random.default_rng(7).normal(size=(B, N, 6))

    def jloss(p):
        return jnp.sum(jm.apply(p, js, jmask) * w) + jnp.sum(jm.apply(p, js, jmask) ** 2)

    jgrads = weights.params_from_jax(jax.grad(jloss)(params))
    out = tm(scene, mask)
    loss = torch.sum(out * torch.from_numpy(w)) + torch.sum(out ** 2)
    loss.backward()
    for name, p in tm.named_parameters():
        want = jgrads[name].numpy()
        assert np.abs(p.grad.numpy() - want).max() <= GRAD_RTOL * np.abs(want).max(), name


def test_remat_is_bitwise_the_same():
    _, _, _, _, tm, scene, mask = _pair(seed=2)
    tr = tmodels.create_model("egnn_mc", device="cpu", dtype=torch.float64,
                              edge_impl="dense", remat=True, **SMALL)
    tr.load_state_dict(tm.state_dict())
    grads = []
    for model in (tm, tr):
        loss = torch.sum(model(scene, mask) ** 2)
        loss.backward()
        grads.append((loss.detach(), [p.grad for p in model.parameters()]))
    assert torch.equal(grads[0][0], grads[1][0])
    assert all(torch.equal(a, b) for a, b in zip(grads[0][1], grads[1][1]))


def test_dense_and_kernel_forms_agree_on_the_cpu():
    _, _, _, _, tm, scene, mask = _pair(seed=3)
    with torch.no_grad():
        dense = tm(scene, mask)
        kernel = tm(scene, mask, edge_impl="kernel")
    assert torch.equal(dense, kernel)


def test_dense_stage_calls_no_plain_twin(monkeypatch):
    """The dense form is the model's own code: it never reaches the kernels'
    plain versions (those stay for tests and the smoke)."""
    EM = importlib.import_module(PORT + ".ops.egnn_messages")

    def boom(*a, **k):
        raise AssertionError("the dense edge stage called a kernel's plain version")

    for name in ("egnn_messages_plain", "edge_stage_plain", "fused_egnn_messages"):
        monkeypatch.setattr(EM, name, boom)
    _, _, _, _, tm, scene, mask = _pair(seed=4)
    torch.sum(tm(scene, mask)).backward()


def test_streaming_has_no_dense_form():
    with pytest.raises(ValueError, match="streaming"):
        tmodels.create_model("egnn_mc", device="cpu", streaming=True, edge_impl="dense", **SMALL)
    model = tmodels.create_model("egnn_mc", device="cpu", streaming=True, **SMALL)
    arrs = _arrays()
    scene = Scene(*(torch.from_numpy(a).float() for a in arrs))
    with pytest.raises(ValueError, match="streaming"):
        model(scene, tgraph.knn_mask(scene.pos, N - 1), edge_impl="dense")
    with pytest.raises(ValueError, match="edge_impl"):
        tmodels.create_model("egnn_mc", device="cpu", edge_impl="plain", **SMALL)


def test_node_width_other_than_the_edge_width_matches_jax():
    """The node model takes ``[h, agg]``, H + He wide: a node width other than
    the edge width (as the JAX package's HPO sets it) builds and agrees."""
    arrs = _arrays(5)
    js = JScene(*(jnp.asarray(a) for a in arrs))
    jmask = jgraph.knn_mask(js.pos, N - 1)
    widths = dict(num_layers=2, hidden_node_dim=8, hidden_edge_dim=16, hidden_coord_dim=12)
    jm = jmodels.create_model("egnn_mc", **widths)
    params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64),
                                    jm.init(jax.random.PRNGKey(5), js, jmask))
    tm = tmodels.create_model("egnn_mc", device="cpu", dtype=torch.float64, edge_impl="dense",
                              **widths)
    tm.load_state_dict(weights.params_from_jax(params))
    scene = Scene(*(torch.from_numpy(a) for a in arrs))
    with torch.no_grad():
        got = tm(scene, tgraph.knn_mask(scene.pos, N - 1)).numpy()
    assert _rel(got, np.asarray(jm.apply(params, js, jmask))) < OUT_RTOL
