"""A full-bf16 scene (scene and parameters in bf16, the JAX package's
``pallas-bf16-t64`` config of ``bench.py``) through the port's edge kernels
K1 and K3, on the CPU.

The JAX wrappers cast the geometry (K1) and the node inputs (K3) to float32
before their kernels; the port's wrappers do the same now instead of raising.
Held here:
* the port's full-bf16 EGNN-MC (dense K1 path and streaming K3 path) against
  the JAX model with its Pallas kernels in interpret mode, the same bf16
  parameters and scene: 5e-2 of the largest output (measured 1.1e-2 on the
  K1 path, 9.3e-3 on the K3 path).
  A bf16 hidden state rounds at every node MLP, and XLA and torch round the
  bf16 silus and the bf16 matmul accumulations at other points, so one-ulp
  flips (2**-8 relative) compound over the layers;
* each wrapper given bf16 geometry returns, bitwise, what it returns given the
  same values cast to float32 by hand;
* on a stand-in for the card (``_build.wants_kernel`` true, the kernel library
  a recorder), a bf16 geometry reaches the launch as float32: the float32
  buffer behind the pointer the kernel gets holds the bf16 values exactly;
  an integer geometry still raises ``TypeError``.
"""

import ctypes
import functools

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
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.core import (
    graph as tgraph,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.core.scene import (
    Scene,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.models import (
    create_model,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.ops import (
    _build,
    egnn_messages as EM,
    egnn_stream as ES,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.weights import (
    params_from_jax,
)

B, N, H = 2, 12, 32
SMALL = dict(num_layers=2, hidden_node_dim=H, hidden_edge_dim=H, hidden_coord_dim=H)
MODEL_RTOL = 5e-2
PATHS = {
    "dense-k1": (dict(use_pallas=True), dict()),
    "stream-k3": (dict(streaming=True, pallas_tile=8, stream_tile_j=8), dict(streaming=True)),
}


def _scene(seed):
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(B, N, 3)) * (N / 5.0) ** (1 / 3)).astype(np.float32)
    vel = rng.normal(size=(B, N, 3)).astype(np.float32)
    mass = (np.abs(rng.normal(size=(B, N, 1))) + 0.5).astype(np.float32)
    return pos, vel, np.zeros_like(pos), mass


@pytest.mark.parametrize("path", list(PATHS))
def test_full_bf16_forward_matches_jax(path, monkeypatch):
    monkeypatch.setattr(JEM, "fused_egnn_messages",
                        functools.partial(JEM.fused_egnn_messages, interpret=True))
    monkeypatch.setattr(JES, "streaming_egnn_messages",
                        functools.partial(JES.streaming_egnn_messages, interpret=True))
    jkw, tkw = PATHS[path]
    arrs = _scene(0)
    js = JScene(*(jnp.asarray(a) for a in arrs))
    params = jcreate("egnn_mc", **SMALL).init(jax.random.PRNGKey(3), js,
                                              jgraph.knn_mask(js.pos, N - 1))
    # the parameters rounded to bf16 once, the same values on both sides
    params = jax.tree_util.tree_map(lambda p: jnp.asarray(p).astype(jnp.bfloat16), params)
    js16 = JScene(*(jnp.asarray(a).astype(jnp.bfloat16) for a in arrs))
    mask = jgraph.knn_mask(jnp.asarray(arrs[0]), N - 1)
    want = jcreate("egnn_mc", **jkw, **SMALL).apply(params, js16, mask)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))

    f32 = jax.tree_util.tree_map(lambda p: np.asarray(p.astype(jnp.float32)), params)
    model = create_model("egnn_mc", device="cpu", **tkw, **SMALL)
    model.load_state_dict(params_from_jax(f32))
    model = model.to(torch.bfloat16)
    ts = Scene(*(torch.from_numpy(a).to(torch.bfloat16) for a in arrs))
    with torch.no_grad():
        got = model(ts, tgraph.knn_mask(torch.from_numpy(arrs[0]), N - 1))
    assert got.dtype == torch.bfloat16 and got.shape == (B, N, 6)
    got = got.float().numpy()
    scale, err = np.abs(want).max(), np.abs(got - want).max()
    assert np.isfinite(got).all() and err <= MODEL_RTOL * scale, (err, scale)


def _k1_args(seed=0, Nn=N, He=H):
    g = torch.Generator().manual_seed(seed)

    def mk(*shape, scale=0.3):
        return (torch.randn(*shape, generator=g) * scale).to(torch.bfloat16)

    geom = mk(B, Nn, Nn, 8, scale=1.0)
    mask = (torch.rand(B, Nn, Nn, generator=g) > 0.3).to(torch.bfloat16)
    return [mk(B, Nn, He), mk(B, Nn, He), geom, mask, mk(5, He), mk(He, He), mk(He),
            mk(He, He), mk(He), mk(He)]


def _k3_args(seed=0, Nn=N, He=H):
    g = torch.Generator().manual_seed(seed)

    def mk(*shape, scale=0.3):
        return (torch.randn(*shape, generator=g) * scale).to(torch.bfloat16)

    pos0 = mk(B, Nn, 3, scale=1.0)
    return [mk(B, Nn, He), mk(B, Nn, He), pos0, mk(B, Nn, 3), (mk(B, Nn, 1).abs() + 0.5),
            pos0 + mk(B, Nn, 3, scale=0.05), torch.ones(B, Nn, Nn, dtype=torch.bfloat16),
            mk(5, He), mk(He, He), mk(He), mk(He, He), mk(He), mk(He)]


K1_GEOM = (2,)
K3_NODE = (2, 3, 4, 5)


@pytest.mark.parametrize("kernel", ["k1", "k3"])
def test_bf16_geometry_equals_the_hand_cast(kernel):
    args = _k1_args() if kernel == "k1" else _k3_args()
    fn = EM.fused_egnn_messages if kernel == "k1" else ES.streaming_egnn_messages
    cast = [t.float() if i in (K1_GEOM if kernel == "k1" else K3_NODE) else t
            for i, t in enumerate(args)]
    got, want = fn(*args), fn(*cast)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32


class _Recorder:
    """Stands in for the kernel library: reads the float32 buffers behind the
    geometry or node pointers while the launch holds them."""

    def __init__(self, reads):
        self.reads, self.calls, self.seen = reads, [], {}

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append(name)
            for i, count in self.reads.items():
                buf = (ctypes.c_float * count).from_address(args[i])
                self.seen[i] = np.frombuffer(buf, np.float32).copy()
            return 0
        return fn


@pytest.fixture
def card(monkeypatch):
    def stand_in(reads):
        rec = _Recorder(reads)
        monkeypatch.setattr(_build, "wants_kernel", lambda t: True)
        monkeypatch.setattr(_build, "kernels", lambda: rec)
        monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
        monkeypatch.setattr(_build, "sm_count", lambda t: 4)
        return rec
    return stand_in


@pytest.mark.parametrize("kernel", ["k1", "k3"])
def test_bf16_geometry_reaches_the_launch_as_float32(card, kernel):
    He = EM.KERNEL_WIDTH
    args = _k1_args(Nn=4, He=He) if kernel == "k1" else _k3_args(Nn=4, He=He)
    idx = K1_GEOM if kernel == "k1" else K3_NODE
    rec = card({i: args[i].numel() for i in idx})
    fn = EM.fused_egnn_messages if kernel == "k1" else ES.streaming_egnn_messages
    before = (fn.launches, fn.launches_bf16)
    with torch.no_grad():
        agg, trans = fn(*args)
    assert rec.calls == ["nbody_egnn_messages_bf16" if kernel == "k1" else "nbody_egnn_stream_bf16"]
    assert (fn.launches, fn.launches_bf16) == (before[0], before[1] + 1)
    for i in idx:
        np.testing.assert_array_equal(rec.seen[i], args[i].float().numpy().ravel())
    assert agg.dtype == torch.bfloat16 and trans.dtype == torch.float32

    args[idx[0]] = args[idx[0]].to(torch.int32)
    with pytest.raises(TypeError, match="floating point"):
        fn(*args)
    assert len(rec.calls) == 1
