"""The port's Cl(3) tables and CGENN's modules against the JAX package's.

* The Clifford constants are the JAX package's bit for bit: the Cayley table
  at the reference metric's signature and at (1, 1, 1), the 20 grade paths,
  the reference metric's eigen-decomposition at two seeds, the grade tables;
  the port's path index gathers the path weights onto the blades exactly as
  the JAX scatter and repeats do.
* Each module, in float64 on the same numpy arrays and the same parameters
  (the port's seeded initialisation carried to flax by the converter's named
  rule), agrees with its flax counterpart within 1e-12 of the largest
  output: ``MVLinear`` with and without subspaces and bias, ``grade_mag2``,
  ``MVSiLU``, ``_Normalization``, the geometric product with and without its
  normalisation and first-order term, ``MVLayerNorm``, ``CEMLP`` and
  ``_EGCL`` on an asymmetric kNN mask (the message ``h_i - h_j`` and the mean
  over senders would show reversed).
* The product's table is float32-rounded whatever the input's dtype, as the
  JAX model builds it: the port's buffer holds those values, and the float64
  table moves a float64 product by far more than the tolerance.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

TPU = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu"
PORT = TPU + "_torch"
jcl = importlib.import_module(TPU + ".ops.clifford")
JC = importlib.import_module(TPU + ".models.cgenn")
jgraph = importlib.import_module(TPU + ".core.graph")
tcl = importlib.import_module(PORT + ".ops.clifford")
TC = importlib.import_module(PORT + ".models.cgenn")
tgraph = importlib.import_module(PORT + ".core.graph")
weights = importlib.import_module(PORT + ".weights")

RTOL = 1e-12
SIG = tuple(float(v) for v in jcl.reference_metric(0)[0])
C = 5


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape)


def _tree(module):
    """The flax params of a port module, by the converter's named rule."""
    sd = {k: v for k, v in module.state_dict().items()}
    return weights._named_to_jax(sd, "cgenn")


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _port(cls, *args, seed=0, **kw):
    torch.manual_seed(seed)
    m = cls(*args, **kw).double()
    with torch.no_grad():  # move every parameter off its init (ones, zeros)
        for p in m.parameters():
            p.add_(0.3 * torch.randn_like(p))
    return m


def _run(port, flax_mod, *arrays):
    want = flax_mod.apply(_tree(port), *(jnp.asarray(a) for a in arrays))
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in arrays))
    return got.numpy(), np.asarray(want)


# ------------------------------------------------------------------- tables
@pytest.mark.parametrize("sig", [SIG, (1.0, 1.0, 1.0), (0.5, 2.0, -1.0)])
def test_cayley_table_is_bitwise(sig):
    got, want = tcl.cayley_table(sig), jcl.cayley_table(sig)
    assert got.dtype == want.dtype == np.float64 and np.array_equal(got, want)


def test_grade_tables_and_paths_are_bitwise():
    assert np.array_equal(tcl.geometric_product_paths(), jcl.geometric_product_paths())
    assert int(tcl.geometric_product_paths().sum()) == 20
    for name in ("GRADES", "SUBSPACES", "BETA_SIGNS"):
        assert np.array_equal(getattr(tcl, name), getattr(jcl, name)), name
    assert tcl.GRADE_SLICES == jcl.GRADE_SLICES
    assert tcl._BITMAPS == jcl._BITMAPS
    for a in range(8):
        for b in range(8):
            assert tcl._reorder_sign(a, b) == jcl._reorder_sign(a, b)


@pytest.mark.parametrize("seed", [0, 3])
def test_reference_metric_is_bitwise(seed):
    for got, want in zip(tcl.reference_metric(seed), jcl.reference_metric(seed)):
        assert np.array_equal(got, want)


def test_path_index_gathers_the_jax_scatter_and_repeats():
    """The path index, and the 0/1 matrix the product builds from it, give
    the JAX model's scatter and three repeats bit for bit."""
    w = _x((C, 20), 1)
    paths = jcl.geometric_product_paths()
    pidx = np.argwhere(paths)
    grid = np.zeros((C, 4, 4, 4))
    grid[:, pidx[:, 0], pidx[:, 1], pidx[:, 2]] = w
    want = grid
    for axis in (-3, -2, -1):
        want = np.repeat(want, jcl.SUBSPACES, axis=axis)
    got = np.concatenate([w, np.zeros((C, 1))], axis=1)[:, tcl.path_index()]
    assert np.array_equal(got, want)
    gp = TC.SteerableGeometricProduct(SIG, C).double()
    with torch.no_grad():
        gp.weight.copy_(torch.from_numpy(w))
        built = gp.product_weight().numpy()
    assert np.array_equal(built, jcl.cayley_table(SIG).astype(np.float32) * want)


def test_the_product_table_is_float32_rounded():
    gp = _port(TC.SteerableGeometricProduct, SIG, C)
    f32 = jcl.cayley_table(SIG).astype(np.float32).astype(np.float64)
    assert np.array_equal(gp.cayley.numpy(), f32)
    assert not np.array_equal(f32, jcl.cayley_table(SIG))
    x = _x((7, C, 8), 2)
    got, want = _run(gp, JC.SteerableGeometricProduct(SIG, C), x)
    assert _rel(got, want) <= RTOL
    gp.cayley.copy_(torch.from_numpy(jcl.cayley_table(SIG)))  # the float64 table instead
    with torch.no_grad():
        moved = gp(torch.from_numpy(x)).numpy()
    assert _rel(moved, want) > 1e3 * RTOL


def test_tables_stay_out_of_the_state_dict():
    gp = TC.SteerableGeometricProduct(SIG, C)
    assert set(gp.state_dict()) == {"weight", "MVLinear_0.weight", "_Normalization_0.a",
                                    "MVLinear_1.weight", "MVLinear_1.bias"}
    assert {"cayley", "path_scatter"} <= {n for n, _ in gp.named_buffers()}


# ------------------------------------------------------------------ modules
@pytest.mark.parametrize("subspaces,bias", [(True, True), (True, False), (False, True)])
def test_mvlinear(subspaces, bias):
    port = _port(TC.MVLinear, 4, C, subspaces=subspaces, use_bias=bias)
    flax_mod = JC.MVLinear(SIG, C, subspaces=subspaces, use_bias=bias)
    got, want = _run(port, flax_mod, _x((3, 2, 4, 8), 3))
    assert _rel(got, want) <= RTOL


def test_grade_mag2():
    x = _x((3, 6, C, 8), 4)
    tables = TC._Tables(SIG).double()
    got = tables.mag2(torch.from_numpy(x)).numpy()
    want = np.asarray(JC.grade_mag2(jnp.asarray(x), jnp.asarray(jcl.cayley_table(SIG))))
    assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("name", ["MVSiLU", "_Normalization", "MVLayerNorm"])
def test_gates_and_norms(name):
    port = _port(getattr(TC, name), SIG, C)
    got, want = _run(port, getattr(JC, name)(SIG, C), _x((2, 6, C, 8), 5))
    assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("norm_init,first_order", [(0.0, True), (None, True), (0.7, False),
                                                  (None, False)])
def test_geometric_product(norm_init, first_order):
    port = _port(TC.SteerableGeometricProduct, SIG, C, norm_init, first_order)
    flax_mod = JC.SteerableGeometricProduct(SIG, C, norm_init, first_order)
    got, want = _run(port, flax_mod, _x((2, 3, 4, C, 8), 6))
    assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("norm_init", [0.0, None])
def test_cemlp(norm_init):
    port = _port(TC.CEMLP, SIG, 2 * C, C, C, normalization_init=norm_init)
    flax_mod = JC.CEMLP(SIG, C, C, normalization_init=norm_init)
    got, want = _run(port, flax_mod, _x((3, 4, 2 * C, 8), 7))
    assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("residual", [True, False])
def test_egcl_on_an_asymmetric_knn_mask(residual):
    port = _port(TC._EGCL, SIG, C, residual)
    flax_mod = JC._EGCL(SIG, C, residual)
    h = _x((2, 7, C, 8), 8)
    pos = _x((2, 7, 3), 9)
    jmask = jgraph.knn_mask(jnp.asarray(pos), 2)
    tmask = tgraph.knn_mask(torch.from_numpy(pos), 2)
    assert not bool((tmask == tmask.transpose(1, 2)).all())  # not symmetric
    assert np.array_equal(tmask.numpy(), np.asarray(jmask))
    want, _ = flax_mod.apply(_tree(port), jnp.asarray(h), jmask)
    with torch.no_grad():
        got = port(torch.from_numpy(h), tmask)
        # the mask read transposed (senders for receivers) moves the output
        flipped = port(torch.from_numpy(h), tmask.transpose(1, 2))
    assert _rel(got.numpy(), want) <= RTOL
    assert _rel(flipped.numpy(), want) > 1e-3
