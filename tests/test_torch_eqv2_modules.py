"""EquiformerV2's modules in the port against the JAX package's flax modules,
float64 on the CPU.

Each port module gets its seeded float64 initialisation; its ``state_dict``
becomes the flax module's params through the converter's EquiformerV2 rule
(``weights._named_to_jax``: the port's modules carry the flax names), and
both run on the same numpy inputs.  Every output agrees within 1e-12 of its
largest value:

* ``SO3Linear`` (full and restricted layouts), ``RMSNormSH``,
  ``RadialFunction``;
* ``SO2Conv`` with and without the radial modulation, with extra m=0
  channels (returned beside the output) and without;
* ``SeparableS2Act``, ``GateActivationSH`` and ``S2Act`` at mmax 1 and 2;
* ``SO2Attention`` (every activation, ``use_m_share_rad``, without the
  attention renorm, without the atom-edge embeddings) and ``FeedForward``
  (every activation), on an 8-body graph whose k=3 nearest-neighbour mask is
  not symmetric, so that a transposed graph or a receiver-first message
  would show.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

TPU = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu"
PORT = TPU + "_torch"
JE = importlib.import_module(TPU + ".models.equiformer_v2")
TE = importlib.import_module(PORT + ".models.equiformer_v2")
TSE = importlib.import_module(PORT + ".ops.so3_edge")
tgraph = importlib.import_module(PORT + ".core.graph")
weights = importlib.import_module(PORT + ".weights")

RTOL = 1e-12
B, N, K, C, CE = 2, 8, 3, 8, 6


def _rng(seed):
    return np.random.default_rng(seed)


def _flax(module):
    return {"params": weights._named_to_jax(module.state_dict(), "equiformer_v2")["params"]}


def _assert_rel(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert scale > 0 and err <= RTOL * scale, f"{what}: {err} vs {scale}"


def _port(cls, *args, seed=0, **kw):
    torch.manual_seed(seed)
    return cls(*args, **kw).double()


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("mmax", [None, 1])
def test_so3_linear(mmax):
    tm = _port(TE.SO3Linear, C, 5, mmax=mmax)
    x = _rng(1).normal(size=(B, N, 9 if mmax is None else 7, C))
    with torch.no_grad():
        tm.bias.normal_()  # a bias that is not zero
        want = JE.SO3Linear(5, mmax=mmax).apply(_flax(tm), jnp.asarray(x))
        _assert_rel(tm(_t(x)).numpy(), want)


def test_rms_norm_sh():
    tm = _port(TE.RMSNormSH, C)
    with torch.no_grad():
        tm.affine_weight.normal_()
        tm.affine_bias.normal_()
    x = _rng(2).normal(size=(B, N, 9, C)) * 3.0 + 0.5
    want = JE.RMSNormSH(C).apply(_flax(tm), jnp.asarray(x))
    with torch.no_grad():
        _assert_rel(tm(_t(x)).numpy(), want)


def test_radial_function():
    tm = _port(TE.RadialFunction, [10, CE, CE, 12])
    with torch.no_grad():
        tm.LayerNorm_0.weight.normal_()
        tm.LayerNorm_1.bias.normal_()
    x = _rng(3).normal(size=(B, N, N, 10))
    want = JE.RadialFunction([10, CE, CE, 12]).apply(_flax(tm), jnp.asarray(x))
    with torch.no_grad():
        _assert_rel(tm(_t(x)).numpy(), want)


@pytest.mark.parametrize("radial", [True, False])
@pytest.mark.parametrize("extra", [0, 5])
def test_so2_conv(radial, extra):
    rad = (10, CE, CE) if radial else None
    tm = _port(TE.SO2Conv, C, 4, 1, extra, rad)
    x = _rng(4).normal(size=(B, N, N, 7, C))
    x_edge = _rng(5).normal(size=(B, N, N, 10))
    jm = JE.SO2Conv(m_output_channels=4, extra_m0_channels=extra, radial_channels=rad)
    want = jm.apply(_flax(tm), jnp.asarray(x), jnp.asarray(x_edge))
    with torch.no_grad():
        got = tm(_t(x), _t(x_edge))
    if extra:
        _assert_rel(got[0].numpy(), want[0], "out")
        _assert_rel(got[1].numpy(), want[1], "extra")
    else:
        _assert_rel(got.numpy(), want)


@pytest.mark.parametrize("mmax", [1, 2])
@pytest.mark.parametrize("act", ["sep", "gate", "s2"])
def test_activations(act, mmax):
    k = 7 if mmax == 1 else 9
    x = _rng(6).normal(size=(B, N, k, C))
    if act == "sep":
        g = _rng(7).normal(size=(B, N, C))
        want = JE.SeparableS2Act(mmax=mmax).apply({}, jnp.asarray(g), jnp.asarray(x))
        got = TE.SeparableS2Act(mmax)(_t(g), _t(x))
    elif act == "gate":
        g = _rng(7).normal(size=(B, N, 2 * C))
        want = JE.GateActivationSH(mmax=mmax).apply({}, jnp.asarray(g), jnp.asarray(x))
        got = TE.GateActivationSH(mmax=mmax)(_t(g), _t(x))
    else:
        want = JE.S2Act(mmax=mmax).apply({}, jnp.asarray(x))
        got = TE.S2Act(mmax)(_t(x))
    _assert_rel(got.numpy(), want)


def _graph(seed=8):
    pos = _rng(seed).normal(size=(B, N, 3)) * 1.3
    mask = tgraph.knn_mask(_t(pos), K)
    adj = mask.transpose(1, 2)
    assert not torch.equal(mask, adj)
    D = TSE.wigner_full(TSE.edge_align_rotation(-tgraph.rel_positions(_t(pos))))
    ridx = torch.from_numpy(TSE.restricted_indices(2, 1))
    scale = torch.tensor([1.0, 1, 1, 1] + [(5 / 3) ** 0.5] * 5, dtype=torch.float64)
    return (D.index_select(-2, ridx), D.transpose(-1, -2).index_select(-1, ridx) * scale[:, None],
            adj)


ATTN_CASES = {
    "sep": {},
    "gate": dict(use_gate_act=True),
    "s2": dict(use_sep_s2_act=False),
    "m_share_rad": dict(use_m_share_rad=True),
    "no_renorm": dict(use_attn_renorm=False),
    "no_atom_edge": dict(use_atom_edge_embedding=False),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_so2_attention(case):
    kw = ATTN_CASES[case]
    tm = _port(TE.SO2Attention, C, 8, 2, 4, 3, 5, CE, edge_in=10, alpha_drop=0.1, **kw)
    with torch.no_grad():
        if hasattr(tm, "LayerNorm_0"):
            tm.LayerNorm_0.weight.normal_()
        tm.SO3Linear_0.bias.normal_()
    D, D_inv, adj = _graph()
    x = _rng(9).normal(size=(B, N, 9, C))
    x_edge = _rng(10).normal(size=(B, N, N, 10))
    charges = _rng(11).integers(0, 5, size=(B, N))
    jm = JE.SO2Attention(sphere_channels=C, hidden_channels=8, num_heads=2, alpha_channels=4,
                         value_channels=3, output_channels=5, edge_channels=CE, alpha_drop=0.1,
                         **kw)
    want = jm.apply(_flax(tm), jnp.asarray(x), jnp.asarray(x_edge), jnp.asarray(D.numpy()),
                    jnp.asarray(D_inv.numpy()), jnp.asarray(adj.numpy()), jnp.asarray(charges))
    with torch.no_grad():
        got = tm(_t(x), _t(x_edge), D, D_inv, adj, _t(charges))
    assert got.shape == (B, N, 9, 5)
    _assert_rel(got.numpy(), want, case)


@pytest.mark.parametrize("case", ["sep", "gate", "s2", "grid_mlp", "grid_mlp_no_sep"])
def test_feed_forward(case):
    kw = {"sep": {}, "gate": dict(use_gate_act=True), "s2": dict(use_sep_s2_act=False),
          "grid_mlp": dict(use_grid_mlp=True),
          "grid_mlp_no_sep": dict(use_grid_mlp=True, use_sep_s2_act=False)}[case]
    tm = _port(TE.FeedForward, C, 12, C, **kw)
    x = _rng(12).normal(size=(B, N, 9, C))
    want = JE.FeedForward(C, 12, C, **kw).apply(_flax(tm), jnp.asarray(x))
    with torch.no_grad():
        _assert_rel(tm(_t(x)).numpy(), want, case)


def test_smooth_leaky_relu():
    x = np.linspace(-6, 6, 101)
    _assert_rel(TE.smooth_leaky_relu(_t(x)).numpy(), JE.smooth_leaky_relu(jnp.asarray(x)))
