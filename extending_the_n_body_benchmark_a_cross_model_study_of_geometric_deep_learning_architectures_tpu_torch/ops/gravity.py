"""Softened pairwise gravity and the GT leapfrog: kernels K2 and K2-leapfrog
(``csrc/gravity.cu``) and their plain versions.

``acceleration`` is kernel K2: on a CPU tensor it computes
:func:`acceleration_plain`; on a CUDA tensor it launches the f32 kernel and
counts the launch in ``acceleration.launches``.

``leapfrog`` integrates a whole GT batch: the initial acceleration, then per
frame ``(pos, vel, acc * mass)`` saved before stepping and ``sample_freq``
kick-drift-kick substeps.  On a CPU tensor it computes :func:`leapfrog_plain`,
the loop of substeps on ``acceleration_plain``; on a CUDA tensor it launches
the integrator, one launch for the batch, counted in ``leapfrog.launches``.
The integrator and the loop of K2 launches (``leapfrog_loop`` on
``acceleration``) share one pair arithmetic and one summation order, so on the
card they give bitwise the same trajectories.  Both kernels replace the JAX
package's Pallas ``pallas_acceleration`` (``ops/pallas/gravity.py:69``); see
the source note in ``csrc/gravity.cu``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from . import _build

SPLIT = 8  # threads that share one receiver's sum (kSplit in the source)
MAX_CLUSTER = 16  # blocks of one sim's cluster (kMaxCluster)
MAX_THREADS = 512  # threads of an integrator block (kMaxThreads)
PER_THREAD = (1, 2, 4, 8)  # receivers a thread group may own (the kernel's instances)
MAX_SHARED_BYTES = 232448  # shared memory a block may use on Hopper (227 KB)
# simulate's rule (integrator_takes), from datagen_bench.py's sweeps on an H100:
# the loop of K2 launches costs the host ~0.1 ms a substep until K2's own work,
# B N^2 pairs at ~1 ps a pair over the card, outgrows it; the integrator's
# substep costs ~87 ps a pair of one block's N^2 / cluster where each block has
# an SM to itself (about twice that where blocks share SMs), and a sim is one
# cluster of at most 16 blocks
SUBSTEP_PAIRS_MAX = 1 << 26  # B N^2: the loop's substep is still the host's
BLOCK_PAIRS_MAX = 1 << 20  # N^2 / cluster: the integrator's substep within it


def acceleration_plain(pos: torch.Tensor, mass: torch.Tensor, G, softening) -> torch.Tensor:
    """``a_i = G * sum_j (r_j - r_i) * m_j / (|r_j - r_i|^2 + eps^2)^{3/2}``.

    ``pos [..., N, 3]``, ``mass [..., N, 1]`` -> ``[..., N, 3]``.  A pair with
    ``r2 == 0`` (only possible with zero softening) contributes nothing.
    """
    rel = pos[..., None, :, :] - pos[..., :, None, :]  # rel[..., i, j] = r_j - r_i
    r2 = torch.sum(rel * rel, dim=-1) + softening**2
    good = r2 > 0
    inv_r3 = torch.where(good, torch.where(good, r2, torch.ones_like(r2)) ** -1.5,
                         torch.zeros_like(r2))
    w = inv_r3 * mass[..., None, :, 0]
    return G * torch.sum(rel * w[..., None], dim=-2)


def acceleration(pos: torch.Tensor, mass: torch.Tensor, G, softening) -> torch.Tensor:
    """Kernel K2 on a CUDA tensor, the plain version on a CPU tensor."""
    if not _build.wants_kernel(pos):
        return acceleration_plain(pos, mass, G, softening)
    if pos.dtype != torch.float32 or mass.dtype != torch.float32:
        raise TypeError(f"the gravity kernel takes float32, got {pos.dtype}/{mass.dtype}")
    if pos.shape[-1] != 3 or mass.shape[:-1] != pos.shape[:-1] or mass.shape[-1] != 1:
        raise ValueError(f"want pos [..., N, 3] and mass [..., N, 1], got {pos.shape} {mass.shape}")
    if mass.device != pos.device:
        raise ValueError("pos and mass lie on different devices")
    lead, n = pos.shape[:-2], pos.shape[-2]
    p = pos.reshape(-1, n, 3).contiguous()
    m = mass.reshape(-1, n, 1).contiguous()
    out = torch.empty_like(p)
    err = _build.kernels().nbody_gravity_f32(
        p.data_ptr(), m.data_ptr(), out.data_ptr(), p.shape[0], n,
        float(G), float(softening), _build.stream_ptr(p),
    )
    _build.check(err, "nbody_gravity_f32")
    acceleration.launches += 1
    return out.reshape(*lead, n, 3)


acceleration.launches = 0

Accel = Callable[[torch.Tensor, torch.Tensor, float, float], torch.Tensor]
Frames = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def frame_count(T: int, sample_freq: int) -> int:
    """The frames of ``T`` substeps saved every ``sample_freq``."""
    if sample_freq < 1 or T < 0 or T % sample_freq:
        raise ValueError(f"T={T} is not a multiple of sample_freq={sample_freq}")
    return T // sample_freq


def kick_drift_kick(pos, vel, acc, mass, G, softening, dt, accel: Accel):
    """One leapfrog substep; returns ``(pos, vel, acc)``."""
    vel = vel + acc * (dt / 2.0)
    pos = pos + vel * dt
    acc = accel(pos, mass, G, softening)
    vel = vel + acc * (dt / 2.0)
    return pos, vel, acc


def leapfrog_loop(pos, vel, mass, T: int, sample_freq: int, G, softening, dt,
                  accel: Accel) -> Frames:
    """``loc, vel, force [B, T // sample_freq, N, d]`` from ``pos, vel [B, N, d]``,
    one ``accel`` call a substep: frame ``k`` is the state after ``k *
    sample_freq`` substeps, force is ``acc * mass``."""
    frames = frame_count(T, sample_freq)
    B, N, d = pos.shape
    loc_s = torch.empty((B, frames, N, d), dtype=pos.dtype, device=pos.device)
    vel_s = torch.empty_like(loc_s)
    force_s = torch.empty_like(loc_s)
    acc = accel(pos, mass, G, softening)
    for t in range(frames):
        loc_s[:, t] = pos
        vel_s[:, t] = vel
        force_s[:, t] = acc * mass
        for _ in range(sample_freq):
            pos, vel, acc = kick_drift_kick(pos, vel, acc, mass, G, softening, dt, accel)
    return loc_s, vel_s, force_s


def leapfrog_plain(pos, vel, mass, T: int, sample_freq: int, G, softening, dt) -> Frames:
    """The integrator's plain version: the loop of substeps on ``acceleration_plain``."""
    return leapfrog_loop(pos, vel, mass, T, sample_freq, G, softening, dt, acceleration_plain)


def leapfrog_shared_bytes(n: int) -> int:
    """An integrator block's shared memory: two buffers of ``n`` (x, y, z, m)."""
    return 2 * 16 * n


def leapfrog_fits(n: int) -> bool:
    """Whether the integrator takes ``n`` bodies: their positions, double-buffered,
    fit one block's shared memory (n <= 7264).  ``simulate`` on the card takes
    the loop of K2 launches above that."""
    return 1 <= n and leapfrog_shared_bytes(n) <= MAX_SHARED_BYTES


def cluster_size(B: int, N: int, sms: int) -> int:
    """Blocks of one sim's cluster: the largest power of two up to 16 and up to
    ``N`` with ``B`` clusters on at most ``sms`` SMs, raised, if need be, until
    each block's slice of receivers fits its threads."""
    c = 1
    while 2 * c <= min(MAX_CLUSTER, N) and B * 2 * c <= sms:
        c *= 2
    while -(-N // c) > MAX_THREADS // SPLIT * PER_THREAD[-1] and 2 * c <= MAX_CLUSTER:
        c *= 2
    return c


def integrator_takes(B: int, N: int, sms: int) -> bool:
    """``simulate``'s rule on the card: the integrator when the positions fit
    (:func:`leapfrog_fits`), the loop of K2 launches is bound by the host's
    launches (``B N^2 <= SUBSTEP_PAIRS_MAX``), and a block's pairs a substep
    cost less than those launches (``N^2 / cluster <= BLOCK_PAIRS_MAX``); else
    the loop, which spreads each substep over the whole card."""
    if not leapfrog_fits(N):
        return False
    return B * N * N <= SUBSTEP_PAIRS_MAX and N * N <= BLOCK_PAIRS_MAX * cluster_size(B, N, sms)


def receiver_slices(N: int, cluster: int):
    """Block ``r`` of a cluster owns receivers ``[r N // C, (r + 1) N // C)``."""
    return [(r * N // cluster, (r + 1) * N // cluster) for r in range(cluster)]


def leapfrog_launch(B: int, N: int, sms: int, cluster: Optional[int] = None):
    """The integrator's launch ``(cluster, threads, per)``: ``B`` clusters of
    ``cluster`` blocks of ``threads`` threads, each thread group of ``SPLIT``
    threads owning up to ``per`` receivers of its block's slice.  ``cluster``
    defaults to :func:`cluster_size`."""
    if not leapfrog_fits(N):
        raise ValueError(f"N={N} bodies do not fit the integrator's shared memory")
    c = cluster_size(B, N, sms) if cluster is None else cluster
    if not 1 <= c <= min(MAX_CLUSTER, N):
        raise ValueError(f"a cluster of {c} blocks for N={N}")
    slice_ = -(-N // c)
    groups = MAX_THREADS // SPLIT
    per = next((p for p in PER_THREAD if -(-slice_ // p) <= groups), None)
    if per is None:
        raise ValueError(f"{slice_} receivers a block do not fit {MAX_THREADS} threads")
    groups = -(-slice_ // per)
    return c, -(-groups * SPLIT // 32) * 32, per


def leapfrog(pos, vel, mass, T: int, sample_freq: int, G, softening, dt) -> Frames:
    """Kernel K2-leapfrog on a CUDA tensor (one launch, shaped by
    :func:`leapfrog_launch`), :func:`leapfrog_plain` on a CPU tensor."""
    if not _build.wants_kernel(pos):
        return leapfrog_plain(pos, vel, mass, T, sample_freq, G, softening, dt)
    frame_count(T, sample_freq)
    if any(t.dtype != torch.float32 for t in (pos, vel, mass)):
        raise TypeError(f"the integrator takes float32, got {pos.dtype}/{vel.dtype}/{mass.dtype}")
    if pos.dim() != 3 or pos.shape[-1] != 3 or vel.shape != pos.shape \
            or mass.shape != (*pos.shape[:2], 1):
        raise ValueError(f"want pos, vel [B, N, 3] and mass [B, N, 1], "
                         f"got {pos.shape} {vel.shape} {mass.shape}")
    if vel.device != pos.device or mass.device != pos.device:
        raise ValueError("pos, vel and mass lie on different devices")
    _build.kernels()  # no card: raises, before the SM count is asked for
    launch = leapfrog_launch(pos.shape[0], pos.shape[1], _build.sm_count(pos))
    return launch_leapfrog(launch, pos, vel, mass, T, sample_freq, G, softening, dt)


def launch_leapfrog(launch, pos, vel, mass, T: int, sample_freq: int, G, softening,
                    dt) -> Frames:
    """One launch of K2-leapfrog at ``launch = (cluster, threads, per)`` on
    inputs as :func:`leapfrog` checks them, counted in ``leapfrog.launches``.
    ``leapfrog`` passes the rule's launch; ``datagen_bench`` passes the cluster
    sizes it sweeps."""
    frames = frame_count(T, sample_freq)
    B, N, _ = pos.shape
    p, v, m = (t.contiguous() for t in (pos, vel, mass))
    loc_s = torch.empty((B, frames, N, 3), dtype=torch.float32, device=pos.device)
    vel_s = torch.empty_like(loc_s)
    force_s = torch.empty_like(loc_s)
    if frames:
        c, threads, per = launch
        err = _build.kernels().nbody_leapfrog_f32(
            p.data_ptr(), v.data_ptr(), m.data_ptr(), loc_s.data_ptr(), vel_s.data_ptr(),
            force_s.data_ptr(), B, N, frames, sample_freq, float(G), float(softening),
            float(dt) / 2.0, float(dt), c, threads, per, _build.stream_ptr(p),
        )
        _build.check(err, "nbody_leapfrog_f32")
        leapfrog.launches += 1
    return loc_s, vel_s, force_s


leapfrog.launches = 0
