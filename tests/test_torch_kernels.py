"""The kernels' plain versions against the JAX package's Pallas kernels, and the
wrappers' refusal to fall back.

The Pallas kernels run as the JAX package's own tests run them on the CPU, in
interpret mode.  The CUDA kernels themselves run only on the card, where
``chip_smoke.py`` holds each against its plain version.

Tolerances: K2 in float32 at rtol 2e-5 (the JAX package's own kernel test,
``tests/test_pallas_kernels.py``); K1 in float32 at rtol 1e-4, since the
Pallas kernel and the plain version sum products and means in another order.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu.core import (
    graph as jgraph,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu.ops.pallas import (
    egnn_messages as JEM,
    gravity as JGK,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch import (
    edge_phases,
    rollout_trace,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.ops import (
    _build,
    egnn_messages as EM,
    gravity as GK,
)


def _gravity_inputs(B, N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, N, 3)).astype(np.float32),
            (np.abs(rng.normal(size=(B, N, 1))) + 0.5).astype(np.float32))


def test_gravity_plain_matches_pallas_f32():
    pos, mass = _gravity_inputs(2, 100)
    got = GK.acceleration(torch.from_numpy(pos), torch.from_numpy(mass), 2.0, 0.2)
    want = JGK.pallas_acceleration(jnp.asarray(pos), jnp.asarray(mass), 2.0, 0.2, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=1e-5)


def test_gravity_plain_zero_softening_finite():
    pos, mass = _gravity_inputs(2, 6, seed=1)
    got = GK.acceleration(torch.from_numpy(pos), torch.from_numpy(mass), 2.0, 0.0)
    want = JGK.pallas_acceleration(jnp.asarray(pos), jnp.asarray(mass), 2.0, 0.0, interpret=True)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=1e-5)


def _edge_inputs(B=2, N=12, He=16, Hc=16, seed=0):
    rng = np.random.default_rng(seed)

    def mk(*shape, scale=0.3):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    pos = rng.normal(size=(B, N, 3)).astype(np.float32)
    return pos, dict(
        hA=mk(B, N, He), hB=mk(B, N, He), geom=mk(B, N, N, 8, scale=1.0),
        w_geom=mk(5, He), W2=mk(He, He), b2=mk(He), Wc1=mk(He, Hc), bc1=mk(Hc),
        wc2=mk(Hc, scale=1.0),
    )


_ORDER = ("hA", "hB", "geom", "mask", "w_geom", "W2", "b2", "Wc1", "bc1", "wc2")


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("k", [11, 3])
def test_edge_plain_matches_pallas_f32(version, k):
    pos, ins = _edge_inputs()
    ins["mask"] = np.array(jgraph.knn_mask(jnp.asarray(pos), k))
    want = JEM.fused_egnn_messages(*(jnp.asarray(ins[n]) for n in _ORDER),
                                   tanh=True, interpret=True, version=version)
    got = EM.fused_egnn_messages(*(torch.from_numpy(ins[n]) for n in _ORDER), tanh=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)


def test_edge_plain_without_tanh_and_empty_receiver():
    pos, ins = _edge_inputs(seed=3)
    mask = np.array(jgraph.knn_mask(jnp.asarray(pos), 4))
    mask[0, 5] = False  # a receiver with no senders: agg and trans are 0
    ins["mask"] = mask
    want = JEM.fused_egnn_messages(*(jnp.asarray(ins[n]) for n in _ORDER),
                                   tanh=False, interpret=True)
    got = EM.fused_egnn_messages(*(torch.from_numpy(ins[n]) for n in _ORDER), tanh=False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)
    assert float(got[0][0, 5].abs().max()) == 0.0 and float(got[1][0, 5].abs().max()) == 0.0


def test_receiver_tile():
    """One block over one sim cuts it into the fewest sub-tiles of at most 16
    receivers, evened out."""
    def tile(n):
        (tiles,) = EM.receiver_ranges(1, n, 1)
        return max(count for _, _, count in tiles)

    assert tile(100) == 15 and tile(16) == 16
    assert tile(17) == 9 and tile(1) == 1


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("B,N", [(1, 1), (1, 5), (64, 5), (64, 100), (8, 512), (1, 1000),
                                 (1, 4096)])
def test_receiver_ranges(B, N, sms):
    """The persistent grid's split: every receiver exactly once, block ranges
    balanced to within one receiver, no sub-tile across a sim or above 16."""
    blocks = EM.launch_blocks(B, N, sms)
    assert blocks == min(B * N, sms)
    ranges = EM.receiver_ranges(B, N, blocks)
    assert len(ranges) == blocks
    seen = []
    for tiles in ranges:
        assert tiles, "a launched block with no receiver"
        for b, i0, count in tiles:
            assert 1 <= count <= EM.MAX_RECEIVERS and 0 <= b < B
            assert 0 <= i0 and i0 + count <= N
            seen.extend(b * N + i for i in range(i0, i0 + count))
    assert seen == list(range(B * N))  # each once, in block order
    sizes = [sum(count for _, _, count in tiles) for tiles in ranges]
    assert max(sizes) - min(sizes) <= 1


@pytest.fixture
def no_card(monkeypatch):
    """Every tensor asks for the kernel, and CUDA is not available."""
    monkeypatch.setattr(_build, "wants_kernel", lambda t: True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "_lib", None)


def test_gravity_wrapper_refuses_to_fall_back(no_card):
    pos, mass = _gravity_inputs(1, 4)
    before = GK.acceleration.launches
    with pytest.raises(RuntimeError, match="no fallback"):
        GK.acceleration(torch.from_numpy(pos), torch.from_numpy(mass), 2.0, 0.2)
    assert GK.acceleration.launches == before


def test_edge_wrapper_refuses_to_fall_back(no_card):
    pos, ins = _edge_inputs(B=1, N=4, He=128, Hc=128)
    ins["mask"] = np.ones((1, 4, 4), np.float32)
    before = EM.fused_egnn_messages.launches
    with pytest.raises(RuntimeError, match="no fallback"):
        EM.fused_egnn_messages(*(torch.from_numpy(ins[n]) for n in _ORDER))
    assert EM.fused_egnn_messages.launches == before


def test_edge_wrapper_rejects_what_the_kernel_does_not_take(monkeypatch):
    monkeypatch.setattr(_build, "wants_kernel", lambda t: True)
    pos, ins = _edge_inputs()  # He = 16: the kernel is built for 128
    ins["mask"] = np.ones((2, 12, 12), np.float32)
    args = [torch.from_numpy(ins[n]) for n in _ORDER]
    with pytest.raises(ValueError, match="He = Hc = 128"):
        EM.fused_egnn_messages(*args)
    with pytest.raises(ValueError, match="silu"):
        EM.fused_egnn_messages(*args, activation="relu")
    with pytest.raises(TypeError):
        EM.fused_egnn_messages(*(a.double() for a in args))


def test_wants_kernel_dispatch():
    assert _build.wants_kernel(torch.zeros(1)) is False
    with pytest.raises(ValueError):
        _build.wants_kernel(torch.zeros(1, device="meta"))


def test_library_path_follows_every_source_and_header(tmp_path, monkeypatch):
    """An edited header (``csrc/*.cuh``, ``*.h``) rebuilds the library, as an
    edited ``.cu`` does: both are in the hash of its file name."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    assert all(p.endswith(".cu") for p in _build.sources())
    assert [os.path.basename(p) for p in _build.headers()] == ["egnn_edge.cuh",
                                                               "egnn_edge_bf16.cuh"]
    paths = [_build.library_path()]
    for name in ("egnn_edge.cuh", "egnn_edge_bf16.cuh", "egnn_stream.cu"):
        with open(csrc / name, "a") as f:
            f.write("\n// edited\n")
        paths.append(_build.library_path())
    (csrc / "extra.h").write_text("#pragma once\n")
    paths.append(_build.library_path())
    assert len(set(paths)) == 5
    assert all(os.path.dirname(p) == _build.BUILD_DIR for p in paths)
    # the instrumented build of edge_phases.py: a library of its own
    phases = _build.library_path((*_build.NVCC_FLAGS, "-DEGNN_EDGE_PHASES"), "libnbody_phases")
    assert phases not in paths and os.path.basename(phases).startswith("libnbody_phases-")


@pytest.mark.parametrize("script", [edge_phases, rollout_trace], ids=["edge_phases", "rollout_trace"])
def test_measurement_scripts_need_a_card(script, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert script.main([]) == 1
    assert "needs a CUDA card" in capsys.readouterr().err
