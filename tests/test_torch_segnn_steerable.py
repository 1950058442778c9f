"""The port's steerable stack against the JAX package's, float64 on the CPU.

* ``Irreps``: parsing, ``dim``, ``slices``, ``sort``, ``simplify``, ``+``,
  ``*`` and the printed form equal the JAX package's for the specs SEGNN
  builds; a malformed spec raises.
* Spherical harmonics for l <= 2 equal the JAX package's within 1e-15 of
  their largest value, zero vectors (whose unit vector is 0) included, with
  finite gradients at a zero vector.
* The Clebsch-Gordan tensors of every valid (l1, l2, l3) with each l <= 2,
  and the Wigner-D matrices for l <= 2, equal the JAX package's bit for bit
  (the same numpy code); a tensor product's matrix of them is made once per
  device and dtype and stays out of every ``state_dict``.
* ``weight_balanced_irreps`` equals the JAX package's for the widths of the
  HPO space and the committed checkpoint's 448, at lmax 1 and 2.
* ``SteerableTensorProduct``, ``GateActivation``, ``SteerableTPSwishGate``
  and ``SteerableInstanceNorm`` agree with the JAX modules (random flax
  params cast to float64, and the float32 params applied to float64 inputs)
  within 1e-10 of the largest output, at lmax 1 and 2 and with
  ``irreps_in2=None``.
"""

import importlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

TPU = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu"
PORT = TPU + "_torch"
JS = importlib.import_module(TPU + ".ops.steerable")
TS = importlib.import_module(PORT + ".ops.steerable")

RTOL = 1e-10
SPECS = ["1x1o+1x1o+1x0e", "224x0e+224x1o", "8x0e+8x1o+8x0e+8x1o+2x0e", "3x0e+2x1o+1x2e",
         "2x1o+1x0e+3x2e+1x0e", "1x0e+1x1o+1x2e", "5x1e+0x0e+4x2o"]
TRIPLES = [(l1, l2, l3) for l1, l2, l3 in itertools.product(range(3), repeat=3)
           if abs(l1 - l2) <= l3 <= l1 + l2]
# (in1, out, in2) of the products SEGNN builds, at lmax 1 and 2
PRODUCTS = {
    "embedding": ("1x1o+1x1o+1x0e", "4x0e+4x1o", "1x0e+1x1o"),
    "message_lmax1": ("4x0e+4x1o+4x0e+4x1o+2x0e", "8x0e+4x1o", "1x0e+1x1o"),
    "update_lmax2": ("3x0e+3x1o+3x2e+3x0e+3x1o+3x2e", "9x0e+3x1o+3x2e", "1x0e+1x1o+1x2e"),
    "readout_lmax2": ("3x0e+3x1o+3x2e", "1x1o+1x1o", "1x0e+1x1o+1x2e"),
    "linear": ("4x0e+4x1o", "4x0e+4x1o", None),
    "linear_lmax2": ("3x0e+3x1o+3x2e", "5x0e+2x1o+1x2e", None),
}


def _f64(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), tree)


def _assert_rel(got, want, rtol=RTOL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale, f"{what}: max abs err {err}, max |want| {scale}"


def _load(module, params, prefix=""):
    """The flax ``params`` of a steerable module into the port's ``module``
    (the leaf names are flax's; a gate's product sits under ``tp``)."""
    p = params["params"]
    if "SteerableTensorProduct_0" in p:
        p, prefix = p["SteerableTensorProduct_0"], "tp."
    module.load_state_dict({prefix + k: torch.from_numpy(np.array(v)) for k, v in p.items()})
    return module


@pytest.mark.parametrize("spec", SPECS)
def test_irreps_match_jax(spec):
    j, t = JS.Irreps(spec), TS.Irreps(spec)
    assert t.items == j.items and repr(t) == repr(j)
    assert (t.dim, t.num_irreps, t.lmax) == (j.dim, j.num_irreps, j.lmax)
    assert t.slices() == j.slices()
    assert t.sort().items == j.sort().items and t.simplify().items == j.simplify().items
    assert t.sort().simplify().items == j.sort().simplify().items
    assert (t + "1x0e").items == (j + "1x0e").items and (t * 3).items == (j * 3).items
    assert (2 * t).items == (2 * j).items and TS.Irreps(t) == t and hash(TS.Irreps(spec)) == hash(t)


def test_irreps_parse_and_simplify():
    ir = TS.Irreps("2x0e + 3x0e+1o+0x2e")
    assert ir.items == [(2, (0, 1)), (3, (0, 1)), (1, (1, -1))]
    assert ir.simplify().items == [(5, (0, 1)), (1, (1, -1))]
    assert TS.Irreps("1x2e+1x0e+1x1o").sort().items == [(1, (0, 1)), (1, (1, -1)), (1, (2, 1))]
    assert TS.Irreps.spherical_harmonics(2) == TS.Irreps("1x0e+1x1o+1x2e")
    for bad in ("3y0e", "x1o", "1x1"):
        with pytest.raises(ValueError, match="Bad irrep spec"):
            TS.Irreps(bad)


@pytest.mark.parametrize("lmax", [0, 1, 2])
def test_spherical_harmonics_match_jax(lmax):
    vec = np.random.default_rng(lmax).normal(size=(4, 6, 3)) * 3.0
    vec[:, 0] = 0.0  # zero vectors, as on the masked diagonal
    vec[0, 1] = 1e-9
    want = np.asarray(JS.spherical_harmonics(lmax, jnp.asarray(vec)))
    got = TS.spherical_harmonics(lmax, torch.from_numpy(vec)).numpy()
    assert got.shape == (4, 6, (lmax + 1) ** 2)
    _assert_rel(got, want, 1e-15, "SH")
    assert (got[:, 0, 1:4] == 0).all() and (got[..., 0] == 0.5 / np.sqrt(np.pi)).all()
    unnorm = np.asarray(JS.spherical_harmonics(lmax, jnp.asarray(vec), normalize=False))
    _assert_rel(TS.spherical_harmonics(lmax, torch.from_numpy(vec), normalize=False).numpy(),
                unnorm, 1e-15, "SH unnormalised")


def test_spherical_harmonics_gradient_is_finite_at_zero():
    vec = torch.zeros(3, 3, dtype=torch.float64)
    vec[1] = torch.tensor([0.3, -1.0, 2.0])
    vec.requires_grad_(True)
    TS.spherical_harmonics(2, vec).pow(2).sum().backward()
    assert torch.isfinite(vec.grad).all() and (vec.grad[0] == 0).all()
    with pytest.raises(NotImplementedError):
        TS.spherical_harmonics(3, vec)


@pytest.mark.parametrize("l1,l2,l3", TRIPLES)
def test_clebsch_gordan_is_bitwise_jax(l1, l2, l3):
    want, got = JS.clebsch_gordan(l1, l2, l3), TS.clebsch_gordan(l1, l2, l3)
    assert got.dtype == want.dtype == np.float64
    assert got.shape == want.shape == (2 * l3 + 1, 2 * l1 + 1, 2 * l2 + 1)
    assert got.tobytes() == want.tobytes()
    assert abs(np.linalg.norm(got) - 1.0) < 1e-12


def test_clebsch_gordan_refuses_an_invalid_path():
    with pytest.raises(ValueError, match="No CG path"):
        TS.clebsch_gordan(0, 1, 2)


@pytest.mark.parametrize("l", [0, 1, 2])
def test_wigner_d_is_bitwise_jax(l):
    rng = np.random.default_rng(40 + l)
    for _ in range(3):
        q, r = np.linalg.qr(rng.normal(size=(3, 3)))
        R = q * np.sign(np.diag(r))
        for M in (R, -R):  # a rotation and, with -R, a reflection
            got, want = TS.wigner_D_numpy(l, M), JS.wigner_D_numpy(l, M)
            assert got.shape == (2 * l + 1,) * 2 and got.tobytes() == want.tobytes()
    assert TS._sample_points().tobytes() == JS._sample_points().tobytes()


def test_cg_constants_are_made_once_per_device_and_dtype():
    tp = TS.SteerableTensorProduct("2x0e+2x1o", "2x0e+2x1o", "1x0e+1x1o+1x2e")
    x = torch.zeros(1, 8, dtype=torch.float64)
    a = tp._cg_matrix(x)
    assert tp._cg_matrix(x) is a and a.dtype == torch.float64 and a.shape[0] == 9
    b = tp._cg_matrix(x.float())
    assert b.dtype == torch.float32 and torch.equal(b, a.float())
    # the 1o (x) 2e -> 1o block: sqrt(3) C, laid out (k, i) by the rows (j) of
    # the attribute's 2e item
    off = next(o for b_, l1, l3, o in tp._blocks if (b_, l1, l3) == (2, 1, 1))
    C = np.sqrt(3.0) * TS.clebsch_gordan(1, 2, 1)
    np.testing.assert_array_equal(a[4:9, off:off + 9].numpy(),
                                  C.transpose(2, 0, 1).reshape(5, 9))
    assert all(k.startswith(("w_", "b_")) for k in tp.state_dict())
    assert not list(tp.buffers())


@pytest.mark.parametrize("lmax", [1, 2])
@pytest.mark.parametrize("width", [48, 64, 96, 128, 448])
def test_weight_balanced_irreps_match_jax(width, lmax):
    attr_t, attr_j = TS.Irreps.spherical_harmonics(lmax), JS.Irreps.spherical_harmonics(lmax)
    got = TS.weight_balanced_irreps(width, attr_t, lmax)
    assert got.items == JS.weight_balanced_irreps(width, attr_j, lmax).items
    assert TS.tp_weight_numel(got, attr_t, got) == JS.tp_weight_numel(
        JS.Irreps(repr(got)), attr_j, JS.Irreps(repr(got)))
    assert TS.tp_paths(got, attr_t, got) == JS.tp_paths(JS.Irreps(repr(got)), attr_j,
                                                       JS.Irreps(repr(got)))
    if (width, lmax) == (448, 1):
        assert repr(got) == "224x0e+224x1o" and got.dim == 896


def _inputs(in1, in2, seed=0, rows=(3, 4)):
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=rows + (TS.Irreps(in1).dim,))
    x2 = None if in2 is None else rng.normal(size=rows + (TS.Irreps(in2).dim,))
    return x1, x2


def _call_both(jmod, tmod, x1, x2, f64_params=True):
    j2 = () if x2 is None else (jnp.asarray(x2),)
    params = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x1), *j2)
    if f64_params:
        params = _f64(params)
    want = np.asarray(jmod.apply(params, jnp.asarray(x1), *j2))
    _load(tmod, params)
    t2 = () if x2 is None else (torch.from_numpy(x2),)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x1), *t2).numpy()
    return got, want


@pytest.mark.parametrize("name", sorted(PRODUCTS))
def test_tensor_product_matches_jax(name):
    in1, out, in2 = PRODUCTS[name]
    x1, x2 = _inputs(in1, in2)
    jmod = JS.SteerableTensorProduct(JS.Irreps(in1), JS.Irreps(out),
                                     None if in2 is None else JS.Irreps(in2))
    tmod = TS.SteerableTensorProduct(in1, out, in2).double()
    got, want = _call_both(jmod, tmod, x1, x2)
    assert got.shape == x1.shape[:-1] + (TS.Irreps(out).dim,)
    _assert_rel(got, want, RTOL, name)
    assert [n for n, _ in tmod.named_parameters()] == list(
        jmod.init(jax.random.PRNGKey(3), jnp.asarray(x1),
                  *(() if x2 is None else (jnp.asarray(x2),)))["params"])


@pytest.mark.parametrize("name", ["message_lmax1", "update_lmax2"])
def test_float32_params_apply_in_the_input_dtype(name):
    """float32 parameters on float64 inputs: both packages cast the
    parameters to the input's dtype and compute in float64."""
    in1, out, in2 = PRODUCTS[name]
    x1, x2 = _inputs(in1, in2, seed=1)
    jmod = JS.SteerableTensorProduct(JS.Irreps(in1), JS.Irreps(out), JS.Irreps(in2))
    tmod = TS.SteerableTensorProduct(in1, out, in2)
    got, want = _call_both(jmod, tmod, x1, x2, f64_params=False)
    assert got.dtype == np.float64 and all(p.dtype == torch.float32 for p in tmod.parameters())
    _assert_rel(got, want, RTOL, name)


def test_tensor_product_init_bounds():
    torch.manual_seed(0)
    tp = TS.SteerableTensorProduct("6x0e+6x1o", "5x0e+3x1o", "1x0e+1x1o")
    fan = {0: 6 + 6, 1: 6 + 6}  # paths into each output: 0e x 0e, 1o x 1o / 0e x 1o, 1o x 0e
    for name, p in tp.named_parameters():
        c = int(name.rsplit("_", 1)[1])
        assert p.dtype == torch.float32 and p.abs().max() <= fan[c] ** -0.5
    assert {n for n, _ in tp.named_parameters() if n.startswith("b_")} == {"b_0"}
    with pytest.raises(ValueError, match="No TP paths"):
        TS.SteerableTensorProduct("1x0e", "1x1o")


@pytest.mark.parametrize("out", ["8x0e+4x1o", "6x0e+2x1o+3x2e", "5x0e"])
def test_gate_activation_matches_jax(out):
    pre = TS.gate_irreps(TS.Irreps(out))
    assert pre.items == JS.gate_irreps(JS.Irreps(out)).items
    x = np.random.default_rng(2).normal(size=(3, 4, pre.dim)) * 4.0
    want = np.asarray(JS.GateActivation(JS.Irreps(out)).apply({}, jnp.asarray(x)))
    got = TS.GateActivation(out)(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape[:-1] + (TS.Irreps(out).dim,)
    _assert_rel(got, want, 1e-14, out)


@pytest.mark.parametrize("lmax", [1, 2])
@pytest.mark.parametrize("with_attr", [True, False])
def test_tp_swish_gate_matches_jax(lmax, with_attr):
    hidden = "4x0e+4x1o" if lmax == 1 else "3x0e+3x1o+3x2e"
    in2 = repr(TS.Irreps.spherical_harmonics(lmax)) if with_attr else None
    x1, x2 = _inputs(hidden, in2, seed=4)
    jmod = JS.SteerableTPSwishGate(JS.Irreps(hidden), JS.Irreps(hidden),
                                   None if in2 is None else JS.Irreps(in2))
    tmod = TS.SteerableTPSwishGate(hidden, hidden, in2).double()
    got, want = _call_both(jmod, tmod, x1, x2)
    _assert_rel(got, want, RTOL, "swish gate")


@pytest.mark.parametrize("spec", ["4x0e+2x1o", "3x0e+3x1o+3x2e"])
@pytest.mark.parametrize("affine", [True, False])
def test_instance_norm_matches_jax(spec, affine):
    x = np.random.default_rng(5).normal(size=(3, 7, TS.Irreps(spec).dim)) * 5 + 2
    jmod = JS.SteerableInstanceNorm(JS.Irreps(spec), affine=affine)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(6)  # affine parameters away from their ones and zeros
    params = jax.tree_util.tree_map(lambda v: rng.normal(size=v.shape) + 1.0, params)
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    tmod = TS.SteerableInstanceNorm(spec, affine=affine).double()
    if affine:
        tmod.load_state_dict({k: torch.from_numpy(np.asarray(v))
                              for k, v in params["params"].items()})
    else:
        assert not list(tmod.parameters())
    got = tmod(torch.from_numpy(x)).detach().numpy()
    _assert_rel(got, want, RTOL, "instance norm")
    if not affine:  # scalar channels centred per graph, as the JAX test checks
        n0 = TS.Irreps(spec).items[0][0]
        np.testing.assert_allclose(got[..., :n0].mean(axis=1), 0, atol=1e-12)
