"""Macro-property kernels (the port's own copy of the JAX package's
``metrics/macros.py``, NumPy only): vectorised ports of the reference's
pure-Python loops in ``datasets/nbody/visualization_utils.py`` (HOT LOOP #3 in SURVEY.md).

Count semantics are matched *exactly* — the KS parity acceptance criterion
compares these counts' distributions — but the O(sims*steps*N^2) Python loops
become NumPy array programs (running-streak logic via ``maximum.accumulate``).

Kernels:
* :func:`count_stickings_and_collisions`  (``visualization_utils.py:1093-1124``)
* :func:`count_balls_leaving_defined_area` (``:1145-1167``)
* :func:`max_com_distance`                 (``:1170-1187``)
* :func:`count_sharp_turns`                (``:1190-1222``)
* :func:`count_group_collisions`           (``:1455-1610``)
"""

from __future__ import annotations

import os
from itertools import combinations
from typing import Dict, Tuple

import numpy as np


def _streak_lengths(c: np.ndarray) -> np.ndarray:
    """Running consecutive-True streak along axis 1.

    c: bool ``[S, T, ...]`` -> int ``[S, T, ...]`` where out[t] is the length
    of the True-run ending at t (0 where c[t] is False).
    """
    t = c.shape[1]
    idx = np.arange(t).reshape((1, t) + (1,) * (c.ndim - 2))
    last_false = np.maximum.accumulate(np.where(~c, idx, -1), axis=1)
    return np.where(c, idx - last_false, 0)


def _pair_distances(loc: np.ndarray) -> Tuple[np.ndarray, list]:
    """Distances for all unordered pairs: ``[S, T, P]`` and the pair list."""
    n = loc.shape[2]
    pairs = list(combinations(range(n), 2))
    i = np.array([p[0] for p in pairs])
    j = np.array([p[1] for p in pairs])
    diff = loc[:, :, i, :] - loc[:, :, j, :]
    return np.linalg.norm(diff, axis=-1), pairs


def count_stickings_and_collisions(
    loc: np.ndarray, time_threshold: int = 3, distance_threshold: float = 0.5
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-sim sticking and collision counts.

    Reference semantics (``visualization_utils.py:1093-1124``): scanning steps
    1..T-1, each new contact run counts as a collision at onset; when a run
    reaches ``time_threshold`` consecutive steps it converts into a sticking
    (collision count decremented).  Equivalently: over contact runs within
    steps 1..T-1, ``stickings = #runs with length >= L`` and
    ``collisions = #runs - stickings``.

    Args:
      loc: ``[S, T, N, 3]``.
    Returns:
      ``(sticking_counts [S], collision_counts [S])`` float arrays.
    """
    dist, _ = _pair_distances(loc)
    c = dist[:, 1:, :] <= distance_threshold  # steps 1..T-1 only
    prev = np.concatenate([np.zeros_like(c[:, :1]), c[:, :-1]], axis=1)
    starts = c & ~prev
    n_runs = starts.sum(axis=(1, 2)).astype(np.float64)
    streak = _streak_lengths(c)
    n_stick = (streak == time_threshold).sum(axis=(1, 2)).astype(np.float64)
    return n_stick, n_runs - n_stick


def count_balls_leaving_defined_area(
    loc: np.ndarray, distance_threshold: float = 15.0
) -> np.ndarray:
    """Bodies >threshold away from the *current* CoM for >10 consecutive steps
    *at the end of the trajectory* (``visualization_utils.py:1145-1167``:
    the streak counter is only inspected after the loop, so only the trailing
    run matters).

    Args:
      loc: ``[S, T, N, 3]``.
    Returns:
      ``[S]`` counts of such bodies per simulation.
    """
    com = loc.mean(axis=2, keepdims=True)  # [S,T,1,3]
    outside = np.linalg.norm(loc - com, axis=-1) > distance_threshold  # [S,T,N]
    outside = outside[:, 1:, :]  # loop starts at step 1
    streak = _streak_lengths(outside)
    return (streak[:, -1, :] > 10).sum(axis=1).astype(np.float64)


def max_com_distance(loc: np.ndarray) -> np.ndarray:
    """Max distance of the CoM from its starting position
    (``visualization_utils.py:1170-1187``)."""
    com = loc.mean(axis=2)  # [S,T,3]
    d = np.linalg.norm(com[:, 1:] - com[:, :1], axis=-1)
    return d.max(axis=1)


def count_sharp_turns(vel: np.ndarray, angle_threshold: float = 30.0) -> np.ndarray:
    """Number of velocity-direction changes sharper than ``angle_threshold``
    degrees (``visualization_utils.py:1190-1222``).  Zero-speed frames yield
    NaN angles which compare False, matching the reference.

    Args:
      vel: ``[S, T, N, 3]``.
    Returns:
      ``[S]`` counts.
    """
    a = vel[:, 1:]
    b = vel[:, :-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        cos = (a * b).sum(-1) / (
            np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
        )
        ang = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))
        sharp = ang > angle_threshold
    return np.nansum(sharp, axis=(1, 2)).astype(np.float64)


def _runs_from_bool(c: np.ndarray, time_threshold: int, num_steps: int):
    """Stuck intervals ([t_start, t_end] inclusive) from a contact series.

    Mirrors the incremental bookkeeping of
    ``visualization_utils.py:1510-1571``: an interval opens when the contact
    streak reaches ``time_threshold`` (start = step - L + 1) and closes at the
    step before separation; still-open intervals close at ``num_steps - 1``.
    """
    intervals = []
    run = 0
    start = None
    for t in range(num_steps):
        if c[t]:
            run += 1
            if run == time_threshold:
                start = t - time_threshold + 1
        else:
            if run >= time_threshold:
                intervals.append((start, t - 1))
            run = 0
    if run >= time_threshold:
        intervals.append((start, num_steps - 1))
    return intervals


def count_group_collisions(
    loc: np.ndarray, time_threshold: int = 2, distance_threshold: float = 2.0
) -> np.ndarray:
    """Pair-meets-triplet group collisions
    (``visualization_utils.py:1455-1610``).

    For every disjoint (stuck pair, stuck triplet) combination, each pair of
    overlapping stuck intervals contributes one count if any pair-body comes
    within ``distance_threshold`` of any triplet-body at any step from the
    overlap start to the end of the trajectory.

    Distances are precomputed vectorised; the interval bookkeeping stays in
    Python (tiny: C(N,2)+C(N,3) groups per sim).
    """
    num_sims, num_steps, n_balls, _ = loc.shape
    dist, pairs = _pair_distances(loc)  # [S,T,P]
    pair_idx = {p: k for k, p in enumerate(pairs)}
    triplets = list(combinations(range(n_balls), 3))

    counts = np.zeros(num_sims)
    for s in range(num_sims):
        d = dist[s]  # [T,P]
        contact = d <= distance_threshold  # [T,P]
        stuck_pairs = {}
        for p, k in pair_idx.items():
            iv = _runs_from_bool(contact[:, k], time_threshold, num_steps)
            if iv:
                stuck_pairs[p] = iv
        stuck_triplets = {}
        for tri in triplets:
            i, j, k = tri
            c3 = (
                contact[:, pair_idx[(i, j)]]
                & contact[:, pair_idx[(i, k)]]
                & contact[:, pair_idx[(j, k)]]
            )
            iv = _runs_from_bool(c3, time_threshold, num_steps)
            if iv:
                stuck_triplets[tri] = iv

        # Last contact step per pair (-1 when never): the cross-contact test
        # "any of the 6 pair/triplet cross pairs in contact at any step >=
        # o_start" is exactly max(last_contact over those 6) >= o_start —
        # O(1) per combination instead of an O(T) scan (the scan made the
        # macro minutes-per-sim on contact-dense N=100 data; same
        # restructure as the C++ kernel).
        any_c = contact.any(axis=0)
        last_contact = np.where(
            any_c, num_steps - 1 - np.argmax(contact[::-1], axis=0), -1
        )

        group = 0
        for pair, p_ivs in stuck_pairs.items():
            for tri, t_ivs in stuck_triplets.items():
                if not set(pair).isdisjoint(tri):
                    continue
                max_last = -1
                for i in pair:
                    for j in tri:
                        key = (i, j) if i < j else (j, i)
                        lc = last_contact[pair_idx[key]]
                        if lc > max_last:
                            max_last = lc
                if max_last < 0:
                    continue
                for p_start, p_end in p_ivs:
                    for t_start, t_end in t_ivs:
                        o_start = max(p_start, t_start)
                        o_end = min(p_end, t_end)
                        if o_start <= o_end and o_start <= max_last:
                            group += 1
        counts[s] = group
    return counts


def stuck_cluster_sizes(
    loc: np.ndarray, time_threshold: int = 2, distance_threshold: float = 2.0
) -> np.ndarray:
    """Per-sim time-mean size of the largest *stuck cluster*.

    First-party large-N extension (round-5; no reference analogue — the
    reference's contact-topology macro is the pair-meets-triplet
    ``count_group_collisions``, ``visualization_utils.py:1455-1610``, which
    is Θ(C(N,2)·C(N,3)) by construction and is NaN-gated above
    ``NBX_GROUP_MACRO_MAX_N`` bodies, see PARITY.md).  This macro keeps the
    same *stuck-pair* primitive (contact = pairwise distance ≤ 2.0; a pair
    is stuck at step t iff the contact run containing t lasts ≥ 2 steps,
    exactly ``_runs_from_bool`` membership) but summarises the contact
    topology through connected components instead of combination counts:

      per step t: build the graph over bodies whose edges are the
      currently-stuck pairs; the step statistic is the size of its largest
      connected component (0 when nothing is stuck);
      per sim: the mean of that statistic over all T steps.

    O(T·N²·α) via union-find (C++ twin) / min-label propagation (here), so
    it stays exact and cheap at the bench shape where the group macro
    saturates.  At N=5 it reduces to the reference's stuck-pair/triplet
    vocabulary: one stuck pair over k steps scores 2k/T, a stuck triplet
    3k/T, a disjoint pair+triplet 3k/T (largest component) — the same
    events the group macro enumerates, summarised by size instead of
    combination count.

    Args:
      loc: ``[S, T, N, 3]``.
    Returns:
      ``[S]`` float array (mean largest stuck-cluster size per sim).
    """
    num_sims, num_steps, n, _ = loc.shape
    dist, pairs = _pair_distances(loc)  # [S,T,P]
    contact = dist <= distance_threshold
    # pair stuck at t <=> the contact run containing t has total length >= L
    # (run length = forward streak + backward streak - 1)
    fwd = _streak_lengths(contact)
    bwd = _streak_lengths(contact[:, ::-1])[:, ::-1]
    stuck = np.where(contact, fwd + bwd - 1, 0) >= time_threshold  # [S,T,P]

    i_idx = np.array([p[0] for p in pairs])
    j_idx = np.array([p[1] for p in pairs])
    out = np.zeros(num_sims)
    # chunk over time to bound the [S,chunk,N,N] adjacency memory at big N
    chunk = max(1, int(2e7 // max(1, num_sims * n * n)))
    for t0 in range(0, num_steps, chunk):
        st = stuck[:, t0:t0 + chunk]  # [S,C,P]
        c = st.shape[1]
        adj = np.zeros((num_sims, c, n, n), dtype=bool)
        adj[:, :, i_idx, j_idx] = st
        adj |= np.swapaxes(adj, -1, -2)
        active = adj.any(-1)  # [S,C,N]
        labels = np.broadcast_to(np.arange(n), (num_sims, c, n)).copy()
        for _ in range(n):  # min-label propagation, early fixpoint exit
            neigh = np.where(adj, labels[:, :, None, :], n).min(-1)
            new = np.minimum(labels, neigh)
            if np.array_equal(new, labels):
                break
            labels = new
        sizes = np.zeros((num_sims, c, n), dtype=np.int64)
        s_i = np.arange(num_sims)[:, None, None]
        t_i = np.arange(c)[None, :, None]
        np.add.at(sizes, (np.broadcast_to(s_i, labels.shape),
                          np.broadcast_to(t_i, labels.shape), labels), active)
        out += sizes.max(-1).sum(axis=1)
    return out / float(num_steps)


def compute_all_macros(loc: np.ndarray, vel: np.ndarray) -> Dict[str, np.ndarray]:
    """All per-sim macro statistics for one trajectory batch.

    Uses the native C++ kernels (:mod:`.native`) when the library builds;
    each native wrapper falls back to its vectorised NumPy twin above on its
    own (and ``NBX_DISABLE_NATIVE=1`` forces that path), so no dispatch is
    needed here.

    Args:
      loc, vel: ``[S, T, N, 3]``.
    Returns:
      dict of ``[S]`` arrays keyed by the reference JSON field names
      (``utils/hpo_metrics.py:9-16`` plus ``com_movement``).
    """
    loc = np.asarray(loc, dtype=np.float64)
    vel = np.asarray(vel, dtype=np.float64)

    from . import native

    # group_collision_count is Θ(C(N,2)·C(N,3)) BY CONSTRUCTION (the
    # reference enumerates every disjoint pair×triplet combination,
    # visualization_utils.py:1455-1610) — designed for N=5 where that is 10
    # triplets.  At the bench shape N=100 with real gravity data the
    # contact graph is dense (measured: 23% contact density, 4505/4950
    # pairs "stuck", ~9 intervals each), so the enumeration is ~4e8 live
    # combinations per sim and the count saturates — minutes of CPU per
    # sim for a distribution with no discriminative signal.  Above the
    # gate (default 32 bodies, env NBX_GROUP_MACRO_MAX_N) the macro is
    # reported as NaN; every downstream consumer already drops NaN macros
    # (ks_p returns NaN on empty input, fisher_combine drops NaN/<=0), so
    # large-N runs are scored on the remaining five-of-six reference
    # macros.  Documented as a deviation in PARITY.md.
    n_bodies = loc.shape[2]
    max_n = int(os.environ.get("NBX_GROUP_MACRO_MAX_N", "32"))
    if n_bodies <= max_n:
        group = native.count_group_collisions(loc)
    else:
        group = np.full(loc.shape[0], np.nan)

    stick, coll = native.count_stickings_and_collisions(loc)
    return {
        "sticking_histogram": stick,
        "collision_histogram": coll,
        "leaving_count": native.count_balls_leaving_defined_area(loc),
        "sharp_turn_count_30": native.count_sharp_turns(vel, 30),
        "sharp_turn_count_45": native.count_sharp_turns(vel, 45),
        "com_movement": native.max_com_distance(loc),
        "group_collision_count": group,
        # first-party O(T*N^2) contact-topology macro — restores a sixth
        # scored distribution above the group-macro N gate (round-5; see
        # stuck_cluster_sizes docstring + PARITY.md)
        "stuck_cluster_size": native.stuck_cluster_sizes(loc),
    }
