"""The bf16 edge chunk's agg order (``csrc/egnn_edge_bf16.cuh``), emulated on the CPU.

K1-bf16, K3-bf16 and K3-elem sum ``mask * m2`` per receiver straight from the
W2 product's accumulators: edge row ``e`` of a chunk sits at tile row
``tile_row(e)``, so lane ``(g, t4)`` of warp ``(wm, wn)`` holds the 4
consecutive edge rows ``wm*32 + 4g .. + 3``; a lane sums its rows per receiver
in row order (head, middles, tail), the 8 lanes that share ``t4`` combine heads
with a segmented shuffle sum (``slab_sums``), a slab's first and last receivers
go to the groups' heads and tails and ``combine_groups`` adds those.  The card
runs it; here the same steps run in Python, on every sub-tile shape the path
can give (``n`` from 1 row per receiver to 1000, ragged last chunks): every
live row must land in its own receiver exactly once, and the float32 sums must
match a plain segment sum to float32 rounding.  The emulation's constants are
read from the headers, so the two cannot drift apart.
"""

from __future__ import annotations

import collections
import os
import re

import numpy as np
import pytest
import torch

from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.ops import (
    _build,
    egnn_messages as EM,
)


def header_constants() -> dict:
    """The namespace-scope ``constexpr int`` constants of egnn_edge.cuh, in order."""
    with open(os.path.join(_build.CSRC_DIR, "egnn_edge.cuh")) as f:
        src = f.read()
    out = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", src, re.M):
        out[name] = int(eval(expr.replace("/", "//"), {}, dict(out)))
    return out


CONST = header_constants()
ROWS, GROUPS, GROUP_ROWS = CONST["kRows"], CONST["kGroups"], CONST["kGroupRows"]
LANES = 8  # lanes that share t4: the mma fragment's row index g


def tile_row(e: int) -> int:
    """``tile_row`` of egnn_edge_bf16.cuh."""
    return (e & ~(GROUP_ROWS - 1)) | ((e & 3) << 3) | ((e >> 2) & 7)


def group_ends(g, r0, valid, n):
    lo = g * GROUP_ROWS
    hi = min(lo + GROUP_ROWS, valid) - 1
    return (r0 + lo) // n, (r0 + hi) // n


def chunk_agg(r0: int, valid: int, n: int, value, acc: dict) -> None:
    """One chunk's agg, in the kernel's order.  ``value(e)`` is chunk row e's mask *
    m2 (any object with ``+``); rows past ``valid`` give ``value(None)``, a zero."""
    last = (r0 + valid - 1) // n
    part = {}

    def put(il, ends, wm, v):
        if il == ends[0]:
            key = (wm, 0)
        elif il == ends[1]:
            key = (wm, 1)
        else:
            acc[il] = acc[il] + v
            return
        assert key not in part, "a group's head or tail put twice"
        part[key] = v

    for wm in range(ROWS // GROUP_ROWS):
        lanes = []
        for g in range(LANES):
            e0 = wm * GROUP_ROWS + 4 * g
            il = [min((r0 + e0 + k) // n, last) for k in range(4)]
            v = [value(e0 + k if e0 + k < valid else None) for k in range(4)]
            cur, run, head = il[0], v[0], None
            for k in range(1, 4):
                if il[k] == cur:
                    run = run + v[k]
                    continue
                if cur == il[0]:
                    head = run
                else:  # a receiver inside the lane's rows
                    acc[cur] = acc[cur] + run
                cur, run = il[k], v[k]
            if cur == il[0]:
                head = run
            lanes.append((il[0], il[3], head, run))
        if wm * GROUP_ROWS >= valid:
            continue
        ends = group_ends(wm, r0, valid, n)
        a = [x[0] for x in lanes]
        b = [x[1] for x in lanes]
        z = [x[2] for x in lanes]
        for off in (1, 2, 4):  # __shfl_down_sync by 4 * off: every lane reads the old z
            z = [z[g] + z[g + off] if g + off < LANES and a[g + off] == a[g] else z[g]
                 for g in range(LANES)]
        for g in range(LANES):
            if g == 0 or b[g - 1] != a[g]:
                put(a[g], ends, wm, z[g])
            if b[g] != a[g]:
                joins = g < LANES - 1 and a[g + 1] == b[g]
                put(b[g], ends, wm, lanes[g][3] + z[g + 1] if joins else lanes[g][3])
    # combine_groups of egnn_edge.cuh
    cur, total = -1, None
    for g in range(GROUPS):
        if g * GROUP_ROWS >= valid:
            break
        ends = group_ends(g, r0, valid, n)
        head = part.pop((g, 0))
        if ends[0] == cur:
            total = total + head
        else:
            if cur >= 0:
                acc[cur] = acc[cur] + total
            cur, total = ends[0], head
        if ends[1] != ends[0]:
            acc[cur] = acc[cur] + total
            cur, total = ends[1], part.pop((g, 1))
    if cur >= 0:
        acc[cur] = acc[cur] + total
    assert not part, f"heads or tails nobody combined: {sorted(part)}"


def subtile_agg(nrecv: int, n: int, value, zero) -> list:
    """The sums of a sub-tile of nrecv receivers, chunk by chunk."""
    rows = nrecv * n
    acc = collections.defaultdict(lambda: zero)
    for r0 in range(0, rows, ROWS):
        chunk_agg(r0, min(ROWS, rows - r0), n, lambda e, r0=r0: zero if e is None else value(r0 + e),
                  acc)
    assert set(acc) <= set(range(nrecv)), f"a sum landed outside the sub-tile: {sorted(acc)}"
    return [acc[i] for i in range(nrecv)]


def test_constants_and_the_tile_row_permutation():
    """The emulation's constants are the header's, and tile_row puts the edge rows
    of lane g at the mma accumulator rows g + 8 (2 mt + half), 4 consecutive rows."""
    assert (ROWS, GROUPS, GROUP_ROWS) == (128, 4, 32)
    with open(os.path.join(_build.CSRC_DIR, "egnn_edge_bf16.cuh")) as f:
        src = f.read()
    assert "return (e & ~(kGroupRows - 1)) | ((e & 3) << 3) | ((e >> 2) & 7);" in src
    assert sorted(tile_row(e) for e in range(ROWS)) == list(range(ROWS))
    for wm in range(GROUPS):
        for g in range(LANES):
            for mt in range(2):
                for half in range(2):
                    acc_row = wm * GROUP_ROWS + mt * 16 + half * 8 + g  # mma_product's layout
                    assert tile_row(wm * GROUP_ROWS + 4 * g + 2 * mt + half) == acc_row


# the receivers a sub-tile can hold (kMaxTi at most) at each n, and the path shapes'
# own sub-tiles from receiver_ranges
NS = (1, 2, 3, 5, 7, 31, 32, 33, 100, 512, 1000)


def subtile_sizes(n: int) -> set:
    sizes = {1, 2, 3, 7, CONST["kMaxTi"] - 1, CONST["kMaxTi"]}
    for b in (1, 2, 8, 64):
        for tiles in EM.receiver_ranges(b, n, min(b * n, 132)):
            sizes |= {count for _, _, count in tiles}
    return sizes


@pytest.mark.parametrize("n", NS)
def test_every_live_row_lands_in_its_receiver_once(n):
    for nrecv in sorted(subtile_sizes(n)):
        got = subtile_agg(nrecv, n, lambda r: collections.Counter({r: 1}), collections.Counter())
        for il, c in enumerate(got):
            assert c == collections.Counter(range(il * n, (il + 1) * n)), (n, nrecv, il)


@pytest.mark.parametrize("n", NS)
def test_sums_match_a_plain_segment_sum(n):
    rng = np.random.default_rng(n)
    cols = 8  # a lane's columns
    for nrecv in sorted(subtile_sizes(n)):
        rows = nrecv * n
        m2 = rng.standard_normal((rows, cols)).astype(np.float32)
        mask = (rng.random(rows) < 0.7).astype(np.float32)
        vals = torch.from_numpy(mask[:, None] * m2)  # exact: the mask is 0 or 1
        got = torch.stack(subtile_agg(nrecv, n, lambda r: vals[r], torch.zeros(cols)))
        want = vals.double().reshape(nrecv, n, cols).sum(1)
        bound = 4 * n * np.finfo(np.float32).eps * vals.double().abs().reshape(nrecv, n, cols).sum(1)
        assert got.dtype == torch.float32
        assert bool(((got.double() - want).abs() <= bound + 1e-30).all()), (n, nrecv)



def test_rollout_trace_runs_the_streaming_configs():
    """``rollout_trace --family egnn_mc_stream``: the committed N=100 checkpoint in the
    streaming model at the smoke's [bign-rollout] shape, in f32 and in the two mixed
    bf16 configs, each a model that loads the checkpoint."""
    from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch import (
        rollout_trace as trace,
        weights,
    )
    from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.models import (
        create_model,
    )

    ckpt, b, n, substeps, shape, configs = trace.FAMILIES["egnn_mc_stream"]
    assert ckpt == trace.CKPT and (b, n, substeps) == (8, 512, 1000) and shape == {"streaming": True}
    assert [c[0] for c in configs] == ["f32", "stream-mixed-bf16", "stream-mixed-ebf16"]
    family = trace.MODEL["egnn_mc_stream"]
    state = weights.params_from_jax(weights.read_jax_checkpoint(ckpt), family)
    for name, kw, train_mode in configs:
        model = create_model(family, device="cpu", **shape, **kw)
        model.load_state_dict(state)
        assert model.streaming and not train_mode
        assert model.compute_dtype == (None if name == "f32" else torch.bfloat16)
