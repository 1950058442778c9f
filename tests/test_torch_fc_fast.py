"""``EGNNMC(fc_fast=True)`` against the JAX model's fully connected fast path.

The JAX model (``use_pallas=False``, ``fc_fast=True``) and the port's dense
edge stage with ``fc_fast=True`` at the same float64 parameters on a small
model (2 layers, width 16, N=5, B=3) and a fully connected mask: the output
and the gradients of a scalar loss for every parameter (``torch.autograd``
against ``jax.grad``, mapped through ``params_from_jax``) agree within 1e-12
of each tensor's largest value.  The fast path is also held against the
port's own masked dense stage on that mask, forward and gradient; the
kernel form (its plain version on the CPU) ignores the flag, as the JAX
model's Pallas branch does.
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
B, N = 3, 5
RTOL = 1e-12


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    arrs = (rng.normal(size=(B, N, 3)), rng.normal(size=(B, N, 3)), np.zeros((B, N, 3)),
            rng.uniform(0.5, 1.5, (B, N, 1)))
    js = JScene(*(jnp.asarray(a) for a in arrs))
    jmask = jgraph.knn_mask(js.pos, N - 1)
    jm = jmodels.create_model("egnn_mc", fc_fast=True, **SMALL)
    params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64),
                                    jm.init(jax.random.PRNGKey(seed), js, jmask))
    scene = Scene(*(torch.from_numpy(a) for a in arrs))

    def port(**kw):
        m = tmodels.create_model("egnn_mc", device="cpu", dtype=torch.float64, **SMALL, **kw)
        m.load_state_dict(weights.params_from_jax(params))
        return m

    mask = tgraph.knn_mask(scene.pos, N - 1)
    return jm, params, js, jmask, port, scene, mask, rng.normal(size=(B, N, 6))


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def _grads(model, scene, mask, w):
    out = model(scene, mask)
    loss = (out * torch.from_numpy(w)).sum() + (out ** 2).sum()
    return dict(zip([n for n, _ in model.named_parameters()],
                    torch.autograd.grad(loss, list(model.parameters())))), out.detach().numpy()


def test_fc_fast_builds_and_keeps_the_dense_parameters():
    m = tmodels.create_model("egnn_mc", device="cpu", fc_fast=True, **SMALL)
    assert all(layer.fc_fast for layer in m.layers)
    assert m.init_kwargs["fc_fast"] is True
    assert set(m.state_dict()) == set(tmodels.create_model("egnn_mc", device="cpu",
                                                           **SMALL).state_dict())


def test_forward_and_gradients_match_the_jax_fc_fast_model():
    jm, params, js, jmask, port, scene, mask, w = _setup(1)
    want = np.asarray(jm.apply(params, js, jmask))

    def jloss(p):
        out = jm.apply(p, js, jmask)
        return jnp.sum(out * w) + jnp.sum(out ** 2)

    want_g = weights.params_from_jax(jax.grad(jloss)(params))
    model = port(fc_fast=True, edge_impl="dense")
    grads, got = _grads(model, scene, mask, w)
    assert _rel(got, want) <= RTOL
    for name, g in grads.items():
        assert _rel(g.numpy(), want_g[name].numpy()) <= RTOL, name


@pytest.mark.parametrize("edge_impl", ["dense", "kernel"])
def test_fc_fast_equals_the_masked_stage_on_a_fully_connected_mask(edge_impl):
    _, _, _, _, port, scene, mask, w = _setup(2)
    fast, masked = port(fc_fast=True, edge_impl=edge_impl), port(edge_impl=edge_impl)
    gf, of = _grads(fast, scene, mask, w)
    gm, om = _grads(masked, scene, mask, w)
    assert _rel(of, om) <= RTOL
    for name in gm:
        assert _rel(gf[name].numpy(), gm[name].numpy()) <= RTOL, name
    if edge_impl == "kernel":  # the flag changes nothing on the kernel path
        assert np.array_equal(of, om)
