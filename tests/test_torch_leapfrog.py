"""The GT integrator K2-leapfrog: its plain version against the JAX package's
leapfrog, ``simulate``'s dispatch by shape, the integrator's launch rule, and
the wrapper's refusals.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it
bitwise against the loop of K2 launches and within a tolerance of the plain
loop.  Here the inputs are numpy arrays from a seed, handed to both packages
in float64 (``tests/conftest.py`` enables x64), so agreement is to rtol
1e-10: only summation order differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu.core import (
    physics as jphys,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch import (
    datagen_bench,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.core import (
    physics as tphys,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.ops import (
    _build,
    gravity as GK,
)

G, DT = 2.0, 0.01


def _states(B, N, seed, dim=3):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(B, N, dim)) * (N / 5.0) ** (1 / 3)
    vel = rng.normal(size=(B, N, dim))
    mass = np.abs(rng.normal(size=(B, N, 1))) + 0.5
    return pos, vel, mass


def _jax_frames(pos, vel, mass, T, freq, softening):
    """The body of the JAX package's ``sample_trajectory`` (core/physics.py:93-140)
    from given states: the first acceleration, then per frame (pos, vel, acc *
    mass) saved before ``freq`` leapfrog steps, in two nested scans."""
    params = jphys.GravityParams(softening=softening, dt=DT, interaction_strength=G)
    pos, vel, mass = (jnp.asarray(a) for a in (pos, vel, mass))
    acc = jphys.compute_acceleration(pos, mass, G, softening)

    def substeps(carry, _):
        p, v, a = carry
        frame = (p, v, a * mass)

        def one(c, _):
            return jphys.leapfrog_step(*c, mass, params), None

        carry, _ = jax.lax.scan(one, (p, v, a), None, length=freq)
        return carry, frame

    _, frames = jax.lax.scan(substeps, (pos, vel, acc), None, length=T // freq)
    return [np.moveaxis(np.asarray(f), 0, 1) for f in frames]  # [T, B, ...] -> [B, T, ...]


@pytest.mark.parametrize("T,freq,softening", [(50, 5, 0.2), (12, 1, 0.2), (30, 10, 0.0)])
def test_leapfrog_plain_matches_jax(T, freq, softening):
    pos, vel, mass = _states(3, 7, seed=T)
    got = GK.leapfrog_plain(*(torch.from_numpy(a) for a in (pos, vel, mass)), T, freq, G,
                            softening, DT)
    want = _jax_frames(pos, vel, mass, T, freq, softening)
    for g, w in zip(got, want):
        assert g.shape == (3, T // freq, 7, 3)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10, atol=1e-12)


def test_leapfrog_on_the_cpu_is_the_plain_loop():
    pos, vel, mass = (torch.from_numpy(a) for a in _states(2, 5, seed=1))
    before = GK.leapfrog.launches
    got = GK.leapfrog(pos, vel, mass, 20, 4, G, 0.2, DT)
    want = GK.leapfrog_plain(pos, vel, mass, 20, 4, G, 0.2, DT)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert GK.leapfrog.launches == before


@pytest.mark.parametrize("B,N,want", [(8, 512, "leapfrog"), (1, 8192, "leapfrog_loop"),
                                     (64, 100, "leapfrog"), (1, 7264, "leapfrog_loop")],
                         ids=["integrator", "loop-of-K2", "integrator-N100", "loop-of-K2-one-sim"])
def test_simulate_dispatch_by_shape(B, N, want, monkeypatch):
    """On the card (here stood in for), simulate takes the integrator where
    integrator_takes says so by shape and the loop of K2 launches elsewhere:
    past the shared-memory limit, and for one sim so large that its cluster
    would leave most of the card idle."""
    taken = []

    def stand_in(name):
        def run(pos, *args):
            taken.append(name)
            frames = torch.zeros((pos.shape[0], args[2] // args[3], pos.shape[1], 3))
            return frames, frames.clone(), frames.clone()
        return run

    for name in ("leapfrog", "leapfrog_loop"):
        monkeypatch.setattr(tphys, name, stand_in(name))
    monkeypatch.setattr(_build, "wants_kernel", lambda t: True)
    monkeypatch.setattr(_build, "sm_count", lambda t: 132)
    pos = torch.zeros((B, N, 3))
    loc, _, _ = tphys.simulate(pos, pos, torch.ones((B, N, 1)), 20, 5, tphys.GravityParams())
    assert taken == [want] and loc.shape == (B, 4, N, 3)
    assert GK.integrator_takes(B, N, 132) == (want == "leapfrog")


def test_simulate_on_the_cpu_is_the_plain_loop(monkeypatch):
    """On a CPU tensor simulate goes through leapfrog, which computes the plain loop."""
    pos, vel, mass = (torch.from_numpy(a) for a in _states(2, 6, seed=2))
    taken = []
    real = tphys.leapfrog
    monkeypatch.setattr(tphys, "leapfrog", lambda *a: taken.append("leapfrog") or real(*a))
    got = tphys.simulate(pos, vel, mass, 20, 5, tphys.GravityParams())
    assert taken == ["leapfrog"]
    want = GK.leapfrog_plain(pos, vel, mass, 20, 5, G, 0.2, DT)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# (B, N): the loop of K2 launches' faster run over the integrator's mean time at
# 200 substeps, on an H100 with 132 SMs (datagen_bench.py; two calls, the last
# eight shapes from the second, around the rule's boundary B N^2 = 2^26, where
# (4, 4096) read 0.95 against 1.23 in the first; chip_smoke.py's [integrate]
# for (64, 100) and (8, 512) at their GT lengths)
MEASURED = {(1, 2048): 5.01, (1, 3072): 1.91, (1, 4096): 1.27, (1, 4608): 0.76, (1, 5120): 0.69,
            (1, 6144): 0.41, (1, 7264): 0.39, (2, 4096): 1.72, (2, 5120): 0.76, (2, 7264): 0.39,
            (4, 5120): 0.72, (4, 7264): 0.68, (5, 7264): 0.86, (8, 4096): 0.75, (8, 7264): 0.60,
            (16, 7264): 0.75, (64, 2048): 0.89, (64, 100): 63.6, (8, 512): 23.4,
            (16, 2048): 1.18, (64, 1024): 2.01, (8, 2896): 0.79, (32, 1448): 0.83, (4, 4096): 0.95,
            (16, 2896): 0.67, (128, 724): 1.61, (2, 4352): 0.70}
# the loop's own time spread by up to 43% between two runs in one call (17.7
# and 25.3 ms at (8, 2896)), so near the boundary either path may measure faster
SPREAD = 1.3


@pytest.mark.parametrize("shape", list(MEASURED), ids=[f"{b}x{n}" for b, n in MEASURED])
def test_integrator_takes_the_measured_faster_path(shape):
    """The rule by shape takes, at every measured shape, the path that was
    faster, or one within the loop's own spread of it."""
    speedup = MEASURED[shape]
    if GK.integrator_takes(*shape, 132):
        assert speedup * SPREAD >= 1
    else:
        assert speedup <= SPREAD


def test_integrator_takes_only_what_fits():
    assert GK.integrator_takes(1, 1, 132) and GK.integrator_takes(64, 100, 78)
    assert not GK.integrator_takes(1, 7265, 132) and not GK.integrator_takes(1, 8192, 132)


def test_shared_memory_limit():
    """Two buffers of (x, y, z, m) a body fit one block's 227 KB up to N = 7264."""
    assert GK.leapfrog_fits(7264) and not GK.leapfrog_fits(7265)
    assert GK.leapfrog_shared_bytes(7264) <= 227 * 1024 < GK.leapfrog_shared_bytes(7265)
    assert GK.leapfrog_fits(1) and not GK.leapfrog_fits(0)
    with pytest.raises(ValueError, match="shared memory"):
        GK.leapfrog_launch(1, 7265, 132)


@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("B,N", [(64, 100), (8, 512), (1, 4096), (3, 300), (1, 1), (1, 7264)])
def test_cluster_rule_owns_every_receiver_once(B, N, sms):
    """The launch rule: a cluster of 1-16 blocks (a power of two, at most N), no more
    clusters' blocks than SMs where one block a sim would not already exceed them,
    threads in whole warps up to 512, shared memory within 227 KB, and the kernel's
    walk (block r's slice, group k's receivers k, k + groups, ...) owns every
    receiver of a sim exactly once."""
    c, threads, per = GK.leapfrog_launch(B, N, sms)
    assert c in (1, 2, 4, 8, 16) and c <= N and c == GK.cluster_size(B, N, sms)
    assert B * c <= max(sms, B)
    assert threads % 32 == 0 and 32 <= threads <= GK.MAX_THREADS and per in GK.PER_THREAD
    assert GK.leapfrog_shared_bytes(N) <= 232448
    groups = threads // GK.SPLIT
    owned = []
    for i0, i1 in GK.receiver_slices(N, c):
        assert i1 > i0
        for k in range(groups):
            owned.extend(i for i in range(i0 + k, i1, groups)[:per])
        assert len(range(i0, i1)) <= groups * per
    assert sorted(owned) == list(range(N))


@pytest.mark.parametrize("B,N,sms,want", [(64, 100, 132, 2), (8, 512, 132, 16), (8, 512, 114, 8),
                                          (1, 4096, 132, 16), (64, 100, 114, 1)])
def test_cluster_size_fills_the_card(B, N, sms, want):
    assert GK.cluster_size(B, N, sms) == want


def test_cluster_override_is_checked():
    assert GK.leapfrog_launch(8, 512, 132, cluster=8)[0] == 8
    for bad, n in ((32, 512), (4, 3), (0, 512)):
        with pytest.raises(ValueError, match="cluster"):
            GK.leapfrog_launch(8, n, 132, cluster=bad)


@pytest.fixture
def no_card(monkeypatch):
    """Every tensor asks for the kernel, and CUDA is not available."""
    monkeypatch.setattr(_build, "wants_kernel", lambda t: True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "_lib", None)


def test_leapfrog_wrapper_refuses_to_fall_back(no_card):
    pos, vel, mass = (torch.from_numpy(a).float() for a in _states(1, 4, seed=3))
    before = GK.leapfrog.launches
    with pytest.raises(RuntimeError, match="no fallback"):
        GK.leapfrog(pos, vel, mass, 20, 10, G, 0.2, DT)
    assert GK.leapfrog.launches == before


@pytest.mark.parametrize("case", ["float64", "dim2", "ragged-T"])
def test_leapfrog_wrapper_refuses_what_the_kernel_does_not_take(case, no_card):
    dim = 2 if case == "dim2" else 3
    pos, vel, mass = (torch.from_numpy(a) for a in _states(1, 4, seed=4, dim=dim))
    if case != "float64":
        pos, vel, mass = pos.float(), vel.float(), mass.float()
    T = 25 if case == "ragged-T" else 20
    error = TypeError if case == "float64" else ValueError
    before = GK.leapfrog.launches
    with pytest.raises(error):
        GK.leapfrog(pos, vel, mass, T, 10, G, 0.2, DT)
    assert GK.leapfrog.launches == before


def test_frame_count():
    assert GK.frame_count(2000, 10) == 200 and GK.frame_count(0, 10) == 0
    for T, freq in ((25, 10), (10, 0), (-10, 10)):
        with pytest.raises(ValueError):
            GK.frame_count(T, freq)


@pytest.mark.parametrize("B,N,substeps,want_ms", [(64, 100, 2000, 0.38037), (8, 512, 1000, 0.62038),
                                                  (64, 100, 10000, 1.90873)])
def test_datagen_bound(B, N, substeps, want_ms):
    """20 flops a pair, one acceleration for frame 0 and one a substep up to the
    last frame, at 67 TFLOP/s: operations, not the frames' bytes, bound it."""
    got, by = datagen_bench.bound_ms(B, N, substeps)
    assert by == "operations" and got == pytest.approx(want_ms, abs=1e-5)


def test_datagen_bench_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert datagen_bench.main([]) == 1
    assert "needs a CUDA card" in capsys.readouterr().err


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("B,N", [(64, 5), (16, 5), (1, 5), (64, 2), (1, 2), (16, 100)])
def test_cluster_rule_owns_every_receiver_once_at_the_training_shapes(B, N, sms):
    """The trainer's GT shapes: N=5 (a cluster of 2 blocks a sim at B=64, so
    each block owns 2 or 3 receivers and lanes past N carry nothing), N=2 and
    the N=100 study run's B=16."""
    test_cluster_rule_owns_every_receiver_once(B, N, sms)
    c, _, _ = GK.leapfrog_launch(B, N, sms)
    assert all(i1 > i0 for i0, i1 in GK.receiver_slices(N, c))
