"""The port's streaming EGNN-MC edge stage (kernel K3's plain version) and its
big-N model path against the JAX package.

The JAX side runs its Pallas kernel in interpret mode with tiles that do not
divide N (B=2, N=20, tiles 8), as the JAX package's own streaming tests do.
The CUDA kernel itself runs only on the card, where ``chip_smoke.py`` holds it
against its plain version and against K1.

Tolerances, each with its reason:
* plain vs Pallas, f32: atol 1e-5, the JAX package's own streaming test
  (another summation order, outputs of order 1);
* streaming plain vs dense plain, f64: rtol 1e-10 (atol 1e-12 for entries
  that cancel to ~0); the two build the same geometry by other expressions;
* port model vs JAX model, f32, forward and 5 closed-loop steps: atol 1e-5;
* the committed checkpoint, streaming vs dense port model, f64: rtol 1e-12.
"""

import functools
import json
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
    egnn_stream as JES,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu.rollout import (
    make_rollout_fn as jmake_rollout,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch import (
    bign_bench,
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
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.models.egnn_mc import (
    EGNNBlock,
    EGNNMC,
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
B, N, H = 2, 20, 32  # N = 20: no tile of 8 divides it
SMALL = dict(num_layers=2, hidden_node_dim=H, hidden_edge_dim=H, hidden_coord_dim=H)
_ORDER = ("hA", "hB", "pos0", "vel", "mass", "coord", "mask",
          "w_geom", "W2", "b2", "Wc1", "bc1", "wc2")


def _mask(pos, kind, rng):
    if kind == "fc":
        return np.array(jgraph.knn_mask(jnp.asarray(pos), pos.shape[1] - 1))
    if kind == "knn5":
        return np.array(jgraph.knn_mask(jnp.asarray(pos), 5))
    n = pos.shape[1]
    mask = (rng.uniform(size=(pos.shape[0], n, n)) > 0.3) & ~np.eye(n, dtype=bool)
    mask[0, 5] = False  # a receiver with no senders: agg and trans are 0
    return mask


def _stream_inputs(mask_kind="fc", Bn=B, Nn=N, He=H, Hc=H, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)

    def mk(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(dtype)

    pos0 = mk(Bn, Nn, 3)
    ins = dict(
        hA=mk(Bn, Nn, He), hB=mk(Bn, Nn, He), pos0=pos0, vel=mk(Bn, Nn, 3, scale=0.3),
        mass=(np.abs(rng.normal(size=(Bn, Nn, 1))) + 0.5).astype(dtype),
        coord=pos0 + mk(Bn, Nn, 3, scale=0.05),
        w_geom=mk(5, He, scale=0.1), W2=mk(He, He, scale=0.1), b2=mk(He, scale=0.1),
        Wc1=mk(He, Hc, scale=0.1), bc1=mk(Hc, scale=0.1), wc2=mk(Hc, scale=0.1),
    )
    ins["mask"] = _mask(pos0, mask_kind, rng)
    return ins


def _torch(ins):
    return [torch.from_numpy(np.ascontiguousarray(ins[n])) for n in _ORDER]


# (a) the plain version against the Pallas kernel (interpret mode)
@pytest.mark.parametrize("mask_kind", ["fc", "knn5", "random_with_empty_row"])
@pytest.mark.parametrize("tanh,norm_diff", [(True, True), (True, False), (False, True),
                                            (False, False)])
def test_stream_plain_matches_pallas_f32(mask_kind, tanh, norm_diff):
    ins = _stream_inputs(mask_kind)
    want = JES.streaming_egnn_messages(
        *(jnp.asarray(ins[n]) for n in _ORDER), tanh=tanh, norm_diff=norm_diff,
        interpret=True, tile_i=8, tile_j=8)
    got = ES.streaming_egnn_messages_plain(*_torch(ins), tanh=tanh, norm_diff=norm_diff)
    assert got[0].shape == (B, N, H) and got[1].shape == (B, N, 3)
    assert got[1].dtype == torch.float32
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    if mask_kind == "random_with_empty_row":
        assert float(got[0][0, 5].abs().max()) == 0.0 and float(got[1][0, 5].abs().max()) == 0.0


# (b) the streaming plain version against the dense plain version, f64
@pytest.mark.parametrize("mask_kind", ["fc", "knn5"])
@pytest.mark.parametrize("norm_diff", [True, False])
def test_stream_plain_matches_dense_plain_f64(mask_kind, norm_diff):
    ins = _stream_inputs(mask_kind, seed=1, dtype=np.float64)
    t = dict(zip(_ORDER, _torch(ins)))
    block = EGNNBlock(H, H, H, 4, norm_diff=norm_diff, tanh=True).double()
    h = torch.from_numpy(np.random.default_rng(2).normal(size=(B, N, H)))
    scene = Scene(pos=t["pos0"], vel=t["vel"], force=torch.zeros_like(t["pos0"]), mass=t["mass"])
    with torch.no_grad():
        _, edge_attr = EGNNMC.featurize(scene)
        hA, hB, geom = block.edge_inputs(h, t["coord"], edge_attr)
        w = block.edge_weights()
        dense = EM.egnn_messages_plain(hA, hB, geom, t["mask"], *w, tanh=True)
        stream = ES.streaming_egnn_messages_plain(
            hA, hB, t["pos0"], t["vel"], t["mass"], t["coord"], t["mask"], *w,
            tanh=True, norm_diff=norm_diff)
    for s, d in zip(stream, dense):
        np.testing.assert_allclose(s.numpy(), d.numpy(), rtol=1e-10, atol=1e-12)


# (c) the port's streaming model against the JAX package's, weights carried across
def _jax_scene(seed=0):
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(B, N, 3)) * (N / 5.0) ** (1 / 3)).astype(np.float32)
    vel = rng.normal(size=(B, N, 3)).astype(np.float32)
    mass = (np.abs(rng.normal(size=(B, N, 1))) + 0.5).astype(np.float32)
    return pos, vel, np.zeros_like(pos), mass


@pytest.fixture
def stream_pair(monkeypatch):
    """The JAX streaming EGNN-MC (Pallas in interpret mode, tiles of 8) with
    random params, and the port's streaming model carrying them."""
    monkeypatch.setattr(JES, "streaming_egnn_messages",
                        functools.partial(JES.streaming_egnn_messages, interpret=True))
    arrs = _jax_scene()
    js = JScene(*(jnp.asarray(a) for a in arrs))
    jdense = jcreate("egnn_mc", **SMALL)
    params = jdense.init(jax.random.PRNGKey(3), js, jgraph.knn_mask(js.pos, N - 1))
    params = jax.tree_util.tree_map(np.asarray, params)
    jmodel = jcreate("egnn_mc", streaming=True, pallas_tile=8, stream_tile_j=8, **SMALL)
    tmodel = create_model("egnn_mc", device="cpu", streaming=True, pallas_tile=8,
                          stream_tile_j=8, **SMALL)
    tmodel.load_state_dict(params_from_jax(params))
    return jmodel, params, tmodel


@pytest.mark.parametrize("k", [N - 1, 5])
def test_streaming_model_forward_matches_jax_f32(stream_pair, k):
    jmodel, params, tmodel = stream_pair
    arrs = _jax_scene(seed=1)
    js = JScene(*(jnp.asarray(a) for a in arrs))
    want = np.asarray(jmodel.apply(params, js, jgraph.knn_mask(js.pos, k)))
    ts = Scene(*(torch.from_numpy(a) for a in arrs))
    with torch.no_grad():
        got = tmodel(ts, tgraph.knn_mask(ts.pos, k)).numpy()
    assert got.shape == (B, N, 6)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_streaming_model_rollout_matches_jax_f32(stream_pair):
    jmodel, params, tmodel = stream_pair
    arrs = _jax_scene(seed=2)
    jloc, jvel, jsurv = jmake_rollout(jmodel, 6)(params, JScene(*(jnp.asarray(a) for a in arrs)))
    loc, vel, surv = make_rollout_fn(tmodel, 6)(Scene(*(torch.from_numpy(a) for a in arrs)))
    assert loc.shape == (B, 6, N, 3)
    np.testing.assert_allclose(loc.numpy(), np.asarray(jloc), atol=1e-5)
    np.testing.assert_allclose(vel.numpy(), np.asarray(jvel), atol=1e-5)
    np.testing.assert_array_equal(surv.numpy(), np.asarray(jsurv))


# (d) the committed checkpoint: streaming and dense port models agree
@pytest.fixture(scope="module")
def ckpt_state():
    return params_from_jax(read_jax_checkpoint(CKPT))


@pytest.mark.parametrize("k", [11, 3])
def test_checkpoint_streaming_matches_dense_f64(ckpt_state, k):
    rng = np.random.default_rng(4)
    Bn, Nn = 2, 12
    arrs = (rng.normal(size=(Bn, Nn, 3)) * (Nn / 5.0) ** (1 / 3), rng.normal(size=(Bn, Nn, 3)),
            np.zeros((Bn, Nn, 3)), np.ones((Bn, Nn, 1)))
    scene = Scene(*(torch.from_numpy(a) for a in arrs))
    outs = []
    for streaming in (False, True):
        model = create_model("egnn_mc", device="cpu", dtype=torch.float64, streaming=streaming)
        model.load_state_dict(ckpt_state)
        with torch.no_grad():
            outs.append(model(scene, tgraph.knn_mask(scene.pos, k)).numpy())
    assert np.isfinite(outs[0]).all() and outs[0].shape == (Bn, Nn, 6)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-12, atol=1e-12)


# (e) the wrapper: no fallback without a card, and what the kernel does not take
@pytest.fixture
def no_card(monkeypatch):
    """Every tensor asks for the kernel, and CUDA is not available."""
    monkeypatch.setattr(_build, "wants_kernel", lambda t: True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "_lib", None)


def test_stream_wrapper_refuses_to_fall_back(no_card):
    ins = _stream_inputs(Bn=1, Nn=4, He=128, Hc=128)
    before = ES.streaming_egnn_messages.launches
    with pytest.raises(RuntimeError, match="no fallback"):
        ES.streaming_egnn_messages(*_torch(ins))
    assert ES.streaming_egnn_messages.launches == before


@pytest.mark.parametrize("case,error,match", [
    ("he32", ValueError, "He = Hc = 128"),
    ("float64", TypeError, "float32"),
    ("relu", ValueError, "silu"),
    ("elem_bf16", NotImplementedError, "ROADMAP"),
    ("mixed_devices", ValueError, "different devices"),
])
def test_stream_wrapper_rejects_what_the_kernel_does_not_take(monkeypatch, case, error, match):
    monkeypatch.setattr(_build, "wants_kernel", lambda t: True)
    args = _torch(_stream_inputs(Bn=1, Nn=4, He=32 if case == "he32" else 128,
                                 Hc=32 if case == "he32" else 128))
    kwargs = {}
    if case == "float64":
        args = [a.double() for a in args]
    elif case == "relu":
        kwargs["activation"] = "relu"
    elif case == "elem_bf16":
        kwargs["elem_bf16"] = True
    elif case == "mixed_devices":
        args[_ORDER.index("mask")] = args[_ORDER.index("mask")].to("meta")
    before = ES.streaming_egnn_messages.launches
    with pytest.raises(error, match=match):
        ES.streaming_egnn_messages(*args, **kwargs)
    assert ES.streaming_egnn_messages.launches == before


# (f) the big-N bench on the CPU at a tiny size
@pytest.mark.parametrize("path", list(bign_bench.PATHS))
def test_bign_row_runs_on_cpu(path):
    state = bign_bench.seeded_state(2)
    row = bign_bench.measure_row(12, 2, path, 2, state, device="cpu")
    assert row["path"] == path and (row["n_bodies"], row["batch"]) == (12, 2)
    assert row["steps_per_sec"] > 0 and 0 <= row["survived_min"] <= 1
    assert row["max_memory_allocated_bytes"] is None and row["start_allocated_bytes"] is None


def test_bign_payload_keeps_the_jax_keys_and_prints_only(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    bign_bench.main(["--device", "cpu", "--shapes", "12:1", "--steps", "2"])
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(os.path.join(REPO, "docs", "results", "bign", "bign_bench.json")) as fh:
        ref = json.load(fh)
    assert set(ref) <= set(payload) and set(ref["rows"][0]) <= set(payload["rows"][0])
    assert [r["path"] for r in payload["rows"]] == ["dense-k1", "streaming-k3"]
    assert os.listdir(tmp_path) == []
    with pytest.raises(SystemExit):
        bign_bench.main(["--device", "cpu", "--out",
                         os.path.join(REPO, "docs", "results", "bign", "x.json")])


def test_seeded_state_is_the_seed_and_keeps_the_init_scale():
    a, b, c = bign_bench.seeded_state(2), bign_bench.seeded_state(2), bign_bench.seeded_state(3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers.0.edge_w2"], c["layers.0.edge_w2"])
    assert float(a["layers.0.edge_w2"].abs().max()) <= 128 ** -0.5
    assert float(a["layers.0.coord_w2"].abs().max()) <= 1e-3 * (6.0 / 129) ** 0.5
    assert set(a) == set(EGNNMC(**bign_bench.MODEL_DEFAULTS["egnn_mc"]).state_dict())


def test_elem_bf16_is_refused_on_the_cpu_too():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ES.streaming_egnn_messages(*_torch(_stream_inputs(Bn=1, Nn=4)), elem_bf16=True)


def test_csrc_holds_k3_and_its_shared_header():
    names = sorted(os.path.basename(p) for p in _build.sources() + _build.headers())
    assert {"egnn_stream.cu", "egnn_messages.cu", "egnn_edge.cuh"} <= set(names)
