"""The port's mixed-bf16 EGNN-MC and the bf16 forms of its edge kernels (K1-bf16,
K3-bf16, K3-elem) against the JAX package, on the CPU.

The JAX side runs its Pallas kernels in interpret mode (K3 with tiles of 8 that
do not divide N = 20), as the JAX package's own tests run them.  The CUDA
kernels run only on the card, where ``chip_smoke.py`` holds each against the
plain version tested here.  Inputs come from numpy with a seed.

Tolerances, each with its reason:
* bf16 operands (K1-bf16, K3-bf16, K3-elem): the plain version rounds where the
  Pallas body rounds, so agg (bf16) may differ only where an f32 sum taken in
  another order moves a value across a bf16 rounding boundary: at most one bf16
  ulp of the largest value, 2**-8 of it; trans (f32) to 1e-5 of its largest
  value (another summation order);
* f32 operands with elem_bf16: 1e-2 of the largest value.  The CPU interpreter
  of the Pallas body folds the bf16 rounding of m2 into the f32 product that
  follows (the plain version and the CUDA kernel round it, as the body is
  written), so trans differs in the bf16 class there (measured 1.7e-3); the JAX
  package's own elem_bf16 class is 2e-2 (tests/test_pallas_kernels.py);
* the whole model against the JAX model, forward and 4 closed-loop steps: 1e-2
  of the largest value (measured up to 1.9e-3).  XLA and torch round the node
  MLPs' bf16 silus at other points, and a one-ulp flip of a bf16 hidden value
  is 2**-8 relative;
* the mixed model against the f32 model on the committed checkpoint: 2e-2 of
  the largest value, the JAX package's own class for mixed bf16 (measured
  8.0e-3).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu.core import (
    graph as jgraph,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu.core.scene import (
    Scene as JScene,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu.models import (
    create_model as jcreate,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu.ops.pallas import (
    egnn_messages as JEM,
    egnn_stream as JES,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu.rollout import (
    make_rollout_fn as jmake_rollout,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.core import (
    graph as tgraph,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.core.scene import (
    Scene,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.models import (
    create_model,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.models.common import (
    TorchLinear,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.ops import (
    _build,
    egnn_messages as EM,
    egnn_stream as ES,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.rollout.self_feed import (
    make_rollout_fn,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.weights import (
    params_from_jax,
    read_jax_checkpoint,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "docs", "results", "fidelity_n100", "egnn_n100_ckpt_30_model.ckpt")
B, N, H = 2, 20, 32
SMALL = dict(num_layers=2, hidden_node_dim=H, hidden_edge_dim=H, hidden_coord_dim=H)
OPERANDS = ("hA", "hB", "w_geom", "W2", "b2", "Wc1", "bc1", "wc2")
K1_ORDER = ("hA", "hB", "geom", "mask", "w_geom", "W2", "b2", "Wc1", "bc1", "wc2")
K3_ORDER = ("hA", "hB", "pos0", "vel", "mass", "coord", "mask",
            "w_geom", "W2", "b2", "Wc1", "bc1", "wc2")
BF16_ULP = 2.0 ** -8
TRANS_RTOL = 1e-5
ELEM_F32_RTOL = 1e-2
MODEL_RTOL = 1e-2
MIXED_VS_F32_RTOL = 2e-2


def _inputs(kernel, mask_kind, seed=0, Bn=B, Nn=N, He=H):
    rng = np.random.default_rng(seed)

    def mk(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    pos0 = mk(Bn, Nn, 3)
    ins = dict(hA=mk(Bn, Nn, He, scale=0.5), hB=mk(Bn, Nn, He, scale=0.5),
               w_geom=mk(5, He, scale=0.3), W2=mk(He, He, scale=0.3), b2=mk(He, scale=0.3),
               Wc1=mk(He, He, scale=0.3), bc1=mk(He, scale=0.3), wc2=mk(He, scale=0.3))
    if kernel == "k1":
        ins["geom"] = mk(Bn, Nn, Nn, 8)
    else:
        ins.update(pos0=pos0, vel=mk(Bn, Nn, 3, scale=0.3),
                   mass=(np.abs(rng.normal(size=(Bn, Nn, 1))) + 0.5).astype(np.float32),
                   coord=pos0 + mk(Bn, Nn, 3, scale=0.05))
    k = Nn - 1 if mask_kind == "fc" else 5
    ins["mask"] = np.array(jgraph.knn_mask(jnp.asarray(pos0), k))
    return ins


def _as_jax(ins, order, op):
    """JAX arrays, the operands in ``op`` (jnp.float32 or jnp.bfloat16)."""
    return [jnp.asarray(ins[n]).astype(op) if n in OPERANDS else jnp.asarray(ins[n])
            for n in order]


def _as_torch(jax_args, order):
    """The same values as torch tensors (bf16 operands stay bf16)."""
    out = []
    for n, a in zip(order, jax_args):
        t = torch.from_numpy(np.array(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a))
        out.append(t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t)
    return out


def _check(got, want, agg_tol, trans_tol, agg_dtype):
    agg, trans = got
    assert agg.dtype == agg_dtype and trans.dtype == torch.float32
    for g, w, tol in ((agg, want[0], agg_tol), (trans, want[1], trans_tol)):
        g = g.float().numpy()
        w = np.asarray(w.astype(jnp.float32))
        assert np.isfinite(g).all()
        scale = np.abs(w).max()
        err = np.abs(g - w).max()
        assert err <= tol * scale + 1e-7, (err, scale)


# (a) K1's plain version in bf16 against the Pallas kernel with bf16 operands
@pytest.mark.parametrize("mask_kind", ["fc", "knn5"])
@pytest.mark.parametrize("tanh", [True, False])
def test_k1_plain_bf16_matches_pallas(mask_kind, tanh):
    ins = _inputs("k1", mask_kind)
    jargs = _as_jax(ins, K1_ORDER, jnp.bfloat16)
    want = JEM.fused_egnn_messages(*jargs, tanh=tanh, interpret=True)
    assert want[0].dtype == jnp.bfloat16 and want[1].dtype == jnp.float32
    got = EM.egnn_messages_plain(*_as_torch(jargs, K1_ORDER), tanh=tanh)
    _check(got, want, BF16_ULP, TRANS_RTOL, torch.bfloat16)


# (b) K3's plain version in bf16 and with elem_bf16, against the Pallas kernel
@pytest.mark.parametrize("mask_kind", ["fc", "knn5"])
@pytest.mark.parametrize("norm_diff", [True, False])
@pytest.mark.parametrize("op,elem", [("bf16", False), ("bf16", True), ("f32", True)])
def test_k3_plain_bf16_matches_pallas(mask_kind, norm_diff, op, elem):
    ins = _inputs("k3", mask_kind, seed=1)
    jargs = _as_jax(ins, K3_ORDER, jnp.bfloat16 if op == "bf16" else jnp.float32)
    want = JES.streaming_egnn_messages(*jargs, tanh=True, norm_diff=norm_diff, interpret=True,
                                       tile_i=8, tile_j=8, elem_bf16=elem)
    got = ES.streaming_egnn_messages_plain(*_as_torch(jargs, K3_ORDER), tanh=True,
                                           norm_diff=norm_diff, elem_bf16=elem)
    if op == "bf16":
        _check(got, want, BF16_ULP, TRANS_RTOL, torch.bfloat16)
    else:
        _check(got, want, ELEM_F32_RTOL, ELEM_F32_RTOL, torch.float32)


def test_k3_bf16_takes_the_geometry_unrounded_and_k1_rounds_it():
    """The one difference between the two bodies' bf16 forms: K1 rounds
    geom[..., :5] to bf16 for its product with Wg, K3 multiplies in f32."""
    ins = _inputs("k1", "fc", seed=2)
    ins["geom"][..., :5] *= 1 + 2.0 ** -10  # off the bf16 grid
    args = _as_torch(_as_jax(ins, K1_ORDER, jnp.bfloat16), K1_ORDER)
    rounded = EM.edge_stage_plain(*args, round_geom=True)
    exact = EM.edge_stage_plain(*args, round_geom=False)
    assert not torch.equal(rounded[1], exact[1])
    ref = EM.egnn_messages_plain(*args)
    assert torch.equal(ref[0], rounded[0]) and torch.equal(ref[1], rounded[1])


def test_f32_operands_are_unchanged_by_the_rounding_points():
    """With f32 operands the rounding steps do nothing: K1's plain version is the
    dense masked-mean formula."""
    ins = _inputs("k1", "knn5", seed=3)
    t = {n: torch.from_numpy(ins[n]) for n in K1_ORDER}
    agg, trans = EM.egnn_messages_plain(*(t[n] for n in K1_ORDER))
    silu = torch.nn.functional.silu
    g = t["geom"]
    m = silu(silu(t["hA"][:, :, None] + t["hB"][:, None] + g[..., :5] @ t["w_geom"]) @ t["W2"]
              + t["b2"])
    w = torch.tanh(silu(m @ t["Wc1"] + t["bc1"]) @ t["wc2"])
    tr = torch.clamp(w[..., None] * g[..., 5:8], -100.0, 100.0)
    np.testing.assert_allclose(agg.numpy(), tgraph.masked_segment_mean(m, t["mask"]).numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(trans.numpy(), tgraph.masked_segment_mean(tr, t["mask"]).numpy(),
                               rtol=1e-6, atol=1e-7)


# (c) TorchLinear computes in its input's dtype with f32 parameters
def test_torch_linear_rounds_where_flax_dense_does():
    torch.manual_seed(0)
    lin = TorchLinear(16, 8)
    x = torch.randn(4, 16)
    assert torch.equal(lin(x), torch.nn.functional.linear(x, lin.weight, lin.bias))
    xb = x.to(torch.bfloat16)
    y = lin(xb)
    assert y.dtype == torch.bfloat16 and lin.weight.dtype == torch.float32
    want = (xb @ lin.weight.to(torch.bfloat16).T) + lin.bias.to(torch.bfloat16)
    assert torch.equal(y, want)


# (d) the mixed-bf16 model against the JAX package's, weights carried across
def _scene(seed):
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(B, N, 3)) * (N / 5.0) ** (1 / 3)).astype(np.float32)
    vel = rng.normal(size=(B, N, 3)).astype(np.float32)
    mass = (np.abs(rng.normal(size=(B, N, 1))) + 0.5).astype(np.float32)
    return pos, vel, np.zeros_like(pos), mass


MIXED = {
    "dense": (dict(use_pallas=True), dict()),
    "stream-ebf16": (dict(streaming=True, stream_elem_bf16=True, pallas_tile=8, stream_tile_j=8),
                     dict(streaming=True, stream_elem_bf16=True)),
}


@pytest.fixture(params=list(MIXED))
def mixed_pair(request, monkeypatch):
    """The JAX EGNN-MC with compute_dtype bfloat16 (Pallas in interpret mode) and
    random params, and the port's model carrying them."""
    monkeypatch.setattr(JEM, "fused_egnn_messages",
                        functools.partial(JEM.fused_egnn_messages, interpret=True))
    monkeypatch.setattr(JES, "streaming_egnn_messages",
                        functools.partial(JES.streaming_egnn_messages, interpret=True))
    jkw, tkw = MIXED[request.param]
    js = JScene(*(jnp.asarray(a) for a in _scene(0)))
    params = jcreate("egnn_mc", **SMALL).init(jax.random.PRNGKey(5), js,
                                              jgraph.knn_mask(js.pos, N - 1))
    params = jax.tree_util.tree_map(np.asarray, params)
    jmodel = jcreate("egnn_mc", compute_dtype="bfloat16", **jkw, **SMALL)
    tmodel = create_model("egnn_mc", device="cpu", compute_dtype="bfloat16", **tkw, **SMALL)
    tmodel.load_state_dict(params_from_jax(params))
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())
    return jmodel, params, tmodel


def _close(got, want, rtol):
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert np.isfinite(got).all() and err <= rtol * scale, (err, scale)


@pytest.mark.parametrize("k", [N - 1, 5])
def test_mixed_model_forward_matches_jax(mixed_pair, k):
    jmodel, params, tmodel = mixed_pair
    arrs = _scene(1)
    js = JScene(*(jnp.asarray(a) for a in arrs))
    want = np.asarray(jmodel.apply(params, js, jgraph.knn_mask(js.pos, k)))
    ts = Scene(*(torch.from_numpy(a) for a in arrs))
    with torch.no_grad():
        got = tmodel(ts, tgraph.knn_mask(ts.pos, k))
    assert got.dtype == torch.float32 and got.shape == (B, N, 6)
    _close(got.numpy(), want, MODEL_RTOL)


def test_mixed_model_rollout_matches_jax(mixed_pair):
    jmodel, params, tmodel = mixed_pair
    arrs = _scene(2)
    jloc, jvel, jsurv = jmake_rollout(jmodel, 5)(params, JScene(*(jnp.asarray(a) for a in arrs)))
    loc, vel, surv = make_rollout_fn(tmodel, 5)(Scene(*(torch.from_numpy(a) for a in arrs)))
    assert loc.dtype == torch.float32 and loc.shape == (B, 5, N, 3)
    # displacements from frame 0, so the scale is what the model moved
    _close((loc - loc[:, :1]).numpy(), np.asarray(jloc - jloc[:, :1]), MODEL_RTOL)
    _close(vel.numpy(), np.asarray(jvel), MODEL_RTOL)
    np.testing.assert_array_equal(surv.numpy(), np.asarray(jsurv))


def test_checkpoint_loads_into_the_mixed_model_unchanged():
    """The committed checkpoint's f32 parameters load as they are; the mixed
    model tracks the f32 model on a small scene."""
    state = params_from_jax(read_jax_checkpoint(CKPT))
    rng = np.random.default_rng(6)
    arrs = (rng.normal(size=(2, 12, 3)) * (12 / 5.0) ** (1 / 3), rng.normal(size=(2, 12, 3)),
            np.zeros((2, 12, 3)), np.ones((2, 12, 1)))
    scene = Scene(*(torch.from_numpy(a.astype(np.float32)) for a in arrs))
    mask = tgraph.knn_mask(scene.pos, 11)
    outs = []
    for kw in (dict(), dict(compute_dtype="bfloat16"),
               dict(compute_dtype="bfloat16", streaming=True, stream_elem_bf16=True)):
        model = create_model("egnn_mc", device="cpu", **kw)
        model.load_state_dict(state)
        assert all(torch.equal(model.state_dict()[k], v.float()) for k, v in state.items())
        with torch.no_grad():
            outs.append(model(scene, mask).numpy())
    for out in outs[1:]:
        _close(out, outs[0], MIXED_VS_F32_RTOL)


# (e) the options this slice lifts now build and run (they raised before)
@pytest.mark.parametrize("option", [dict(compute_dtype="bfloat16"),
                                    dict(streaming=True, stream_elem_bf16=True),
                                    dict(streaming=True, compute_dtype="bfloat16")])
def test_lifted_model_options_run_on_the_cpu(option):
    model = create_model("egnn_mc", device="cpu", **SMALL, **option)
    arrs = _scene(3)
    scene = Scene(*(torch.from_numpy(a) for a in arrs))
    loc, _, surv = make_rollout_fn(model, 3)(scene)
    assert torch.isfinite(loc).all() and loc.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with pytest.raises(ValueError):
        create_model("egnn_mc", device="cpu", compute_dtype="float16", **SMALL)


def test_elem_bf16_runs_on_the_cpu():
    ins = _inputs("k3", "fc", Nn=6)
    for op in (jnp.float32, jnp.bfloat16):
        args = _as_torch(_as_jax(ins, K3_ORDER, op), K3_ORDER)
        agg, trans = ES.streaming_egnn_messages(*args, elem_bf16=True)
        assert agg.dtype == args[0].dtype and trans.dtype == torch.float32
        assert torch.isfinite(agg.float()).all() and torch.isfinite(trans).all()


# (f) the wrappers on a CUDA tensor: which kernel, which counter, and F2
def _counts():
    f, s = EM.fused_egnn_messages, ES.streaming_egnn_messages
    return (f.launches, f.launches_bf16, s.launches, s.launches_bf16, s.launches_elem)


class _FakeKernels:
    """Stands in for the loaded library: records each entry point's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


@pytest.fixture
def fake_card(monkeypatch):
    fake = _FakeKernels()
    monkeypatch.setattr(_build, "wants_kernel", lambda t: True)
    monkeypatch.setattr(_build, "kernels", lambda: fake)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_build, "sm_count", lambda t: FAKE_SMS)
    return fake


FAKE_SMS = 5  # fewer than the B * 4 receivers of the wrapper tests


@pytest.mark.parametrize("kernel,op,elem,entry,counter", [
    ("k1", "f32", False, "nbody_egnn_messages_f32", 0),
    ("k1", "bf16", False, "nbody_egnn_messages_bf16", 1),
    ("k3", "f32", False, "nbody_egnn_stream_f32", 2),
    ("k3", "bf16", False, "nbody_egnn_stream_bf16", 3),
    ("k3", "bf16", True, "nbody_egnn_stream_bf16", 4),
    ("k3", "f32", True, "nbody_egnn_stream_f32", 4),
])
def test_wrapper_launches_the_form_of_its_operands(fake_card, kernel, op, elem, entry, counter):
    ins = _inputs(kernel, "fc", Nn=4, He=128)
    order = K1_ORDER if kernel == "k1" else K3_ORDER
    args = _as_torch(_as_jax(ins, order, jnp.bfloat16 if op == "bf16" else jnp.float32), order)
    before = _counts()
    if kernel == "k1":
        agg, trans = EM.fused_egnn_messages(*args)
    else:
        agg, trans = ES.streaming_egnn_messages(*args, elem_bf16=elem)
    (name, cargs), = fake_card.calls
    assert name == entry
    n_ptr = 12 if kernel == "k1" else 15
    assert cargs[n_ptr:n_ptr + 5] == (B, 4, 128, 128, min(B * 4, FAKE_SMS))  # ..., blocks
    if kernel == "k3":
        assert cargs[-2] == int(elem)
    assert agg.dtype == args[0].dtype and trans.dtype == torch.float32
    after = _counts()
    assert [a - b for a, b in zip(after, before)] == [int(i == counter) for i in range(5)]


@pytest.mark.parametrize("kernel", ["k1", "k3"])
def test_wrappers_refuse_mixed_operand_dtypes(fake_card, kernel):
    ins = _inputs(kernel, "fc", Nn=4, He=128)
    order = K1_ORDER if kernel == "k1" else K3_ORDER
    args = _as_torch(_as_jax(ins, order, jnp.bfloat16), order)
    args[order.index("W2")] = args[order.index("W2")].float()
    fn = EM.fused_egnn_messages if kernel == "k1" else ES.streaming_egnn_messages
    before = _counts()
    with pytest.raises(TypeError, match="all in float32 or all in bfloat16"):
        fn(*args)
    assert _counts() == before and not fake_card.calls


@pytest.mark.parametrize("kernel", ["k1", "k3"])
@pytest.mark.parametrize("op", ["f32", "bf16"])
def test_wrappers_refuse_to_drop_gradients(fake_card, kernel, op):
    """F2: the kernels have no backward, so an input that requires grad raises
    with grad mode on, and nothing is launched; under no_grad the call runs."""
    ins = _inputs(kernel, "fc", Nn=4, He=128)
    order = K1_ORDER if kernel == "k1" else K3_ORDER
    args = _as_torch(_as_jax(ins, order, jnp.bfloat16 if op == "bf16" else jnp.float32), order)
    w2 = order.index("W2")
    args[w2] = args[w2].clone().requires_grad_(True)
    fn = EM.fused_egnn_messages if kernel == "k1" else ES.streaming_egnn_messages
    before = _counts()
    with pytest.raises(RuntimeError, match="no backward") as refused:
        fn(*args)
    # the remedy it names is the dense edge stage that training differentiates
    assert 'edge_impl="dense"' in str(refused.value)
    assert "ROADMAP" not in str(refused.value)
    assert _counts() == before and not fake_card.calls
    with torch.no_grad():
        fn(*args)
    assert len(fake_card.calls) == 1
