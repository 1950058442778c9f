"""Where the edge kernels' time goes, phase by phase, on the card.

    python -m extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.edge_phases

Launches each form of the edge stage at its path's shape: K1 f32 and K1-bf16
at (B, N) = (64, 100), K3 f32 at (8, 512) and (1, 1000), K3-bf16, K3-elem and
K3-elem with f32 operands (K3-elem-f32) at (8, 512), fully connected, inputs
and weights drawn from a seed at the model's init scale.  First each form's
time with the normal library (CUDA events, ``ms``), and its error against
the plain version run in float64 on the same inputs (the exact function: no
bf16 rounding, no ``elem_bf16``) beside the plain version's in the form's
own dtype (TF32 off): max abs error over max |reference| of ``agg`` and
``trans``, and their ratio.  Then ``csrc/*.cu`` is built once more with
``-DEGNN_EDGE_PHASES`` into the package's ``_build/`` (a library of its own
beside the normal one), the wrappers are pointed at it, and each form runs
again.  Thread 0 of every block stamps ``clock64()`` at each phase boundary
(``csrc/egnn_edge.cuh``, ``PhaseClock``): a phase's clocks are thread 0's
time in it, and ``barrier`` is thread 0's wait at the barriers, which is the
time the slowest warp of the phase took beyond thread 0.  Prints the card's
name and power limit, one JSON line per form with its time and float64
errors, then one per form with the SM clocks per chunk of each phase summed
over the blocks' thread 0, its share, the chunks and blocks of one launch,
and the instrumented launch's time (``ms_instrumented``).  The phases'
names come from the instrumented library; a library built before m1's load
wait was a phase of its own gives them as ``PHASES_BEFORE_M1_LOAD``, so a
parent commit's package can be measured with this script.
Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import sys

from . import _tf32  # noqa: F401  (TF32 off before torch is used)
import torch

from .bign_bench import card_name
from .ops import _build
from .ops import egnn_messages as EM
from .ops import egnn_stream as ES

# egnn_edge.cuh's enum Phase before it had m1's loads apart (a parent's library,
# which does not export nbody_edge_phase_names), then chunks and blocks
PHASES_BEFORE_M1_LOAD = ("stage", "prologue", "m1", "w2_product", "m2_epilogue", "agg",
                         "wc1_product_epilogue", "trans", "barrier", "means")
WIDTH = 128
K1_SHAPE, K3_SHAPE, K3_WIDE = (64, 100), (8, 512), (1, 1000)


def load_instrumented() -> ctypes.CDLL:
    """Build and bind the instrumented library, and make the wrappers launch it."""
    lib = ctypes.CDLL(_build.build(("-DEGNN_EDGE_PHASES",), "libnbody_phases"))
    _build.bind(lib)
    for fn in (lib.nbody_egnn_messages_phases, lib.nbody_egnn_stream_phases):
        fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    _build._lib = lib
    return lib


def phase_names(lib: ctypes.CDLL) -> tuple:
    """The names of the instrumented library's phases, in the order it counts them."""
    if not hasattr(lib, "nbody_edge_phase_names"):
        return PHASES_BEFORE_M1_LOAD
    lib.nbody_edge_phase_names.restype = ctypes.c_char_p
    return tuple(lib.nbody_edge_phase_names().decode().split(","))


def inputs(bb: int, nn_: int, dev, gen):
    """hA, hB, node data, geometry, an FC mask and the edge weights of one layer."""
    def randn(*shape, scale=1.0):
        return torch.randn(shape, device=dev, generator=gen) * scale

    pos0 = randn(bb, nn_, 3, scale=(nn_ / 5.0) ** (1 / 3))
    vel = randn(bb, nn_, 3)
    mass = torch.rand((bb, nn_, 1), device=dev, generator=gen) + 0.5
    coord = pos0 + 0.1 * randn(bb, nn_, 3)
    geom = torch.cat([randn(bb, nn_, nn_, 5, scale=0.5), randn(bb, nn_, nn_, 3)], dim=-1)
    mask = 1.0 - torch.eye(nn_, device=dev).expand(bb, nn_, nn_).contiguous()
    w = (randn(5, WIDTH, scale=WIDTH ** -0.5), randn(WIDTH, WIDTH, scale=WIDTH ** -0.5),
         randn(WIDTH, scale=0.1), randn(WIDTH, WIDTH, scale=WIDTH ** -0.5),
         randn(WIDTH, scale=0.1), randn(WIDTH, scale=WIDTH ** -0.5))
    h = (randn(bb, nn_, WIDTH), randn(bb, nn_, WIDTH))
    return h, (pos0, vel, mass, coord), geom, mask, w


def timed_ms(call, iters: int) -> float:
    """CUDA-event ms a launch of ``call`` over ``iters`` launches, after a warm-up."""
    call()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def f64_errors(call, plain, args, kwargs=None) -> dict:
    """The kernel's and the plain version's errors (both in the form's dtypes) against
    the plain version in float64 on the same inputs, per output: max abs error /
    max |reference|.  The reference is the exact function: in float64 no operand
    rounds, and it runs without ``elem_bf16``."""
    kwargs = kwargs or {}
    got = call(*args, **kwargs)
    p = plain(*args, **kwargs)
    ref = plain(*(a.double() for a in args),
                **{k: v for k, v in kwargs.items() if k != "elem_bf16"})
    out = {}
    for part, k, q, r in zip(("agg", "trans"), got, p, ref):
        scale = r.abs().max().item()
        ek = (k.double() - r).abs().max().item() / scale
        ep = (q.double() - r).abs().max().item() / scale
        out[part] = {"kernel": ek, "plain": ep, "ratio": ek / ep if ep > 0 else float("inf")}
    return out


def split(read, names, call, iters: int) -> dict:
    """Run ``call`` ``iters`` times after a warm-up; the phase clocks of one launch,
    by phase ``names``."""
    out = (ctypes.c_ulonglong * (len(names) + 2))()
    call()
    torch.cuda.synchronize()
    _build.check(read(out), "phases")  # zero the totals after the warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        call()
    end.record()
    end.synchronize()
    _build.check(read(out), "phases")
    ticks = [v / iters for v in out]
    chunks, blocks = ticks[-2], ticks[-1]
    total = sum(ticks[:len(names)])
    return {
        "ms_instrumented": start.elapsed_time(end) / iters,
        "chunks": chunks, "blocks": blocks,
        "clocks_per_chunk": {p: t / chunks for p, t in zip(names, ticks)},
        "share": {p: t / total for p, t in zip(names, ticks)},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("edge_phases needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    print(card_name(), flush=True)
    bf16 = torch.bfloat16
    forms = []  # (form, shape, wrapper, args, kwargs, phase reader, plain version)
    with torch.no_grad():
        (hA, hB), _, geom, mask, w = inputs(*K1_SHAPE, dev, gen)
        k1b = (*(t.to(bf16) for t in (hA, hB)), geom, mask, *(t.to(bf16) for t in w))
        forms += [("K1", K1_SHAPE, EM.fused_egnn_messages, (hA, hB, geom, mask, *w), {},
                   "nbody_egnn_messages_phases", EM.egnn_messages_plain),
                  ("K1-bf16", K1_SHAPE, EM.fused_egnn_messages, k1b, {},
                   "nbody_egnn_messages_phases", EM.egnn_messages_plain)]
        for shape in (K3_SHAPE, K3_WIDE):
            (hA, hB), node, _, mask, w = inputs(*shape, dev, gen)
            forms.append(("K3", shape, ES.streaming_egnn_messages, (hA, hB, *node, mask, *w), {},
                          "nbody_egnn_stream_phases", ES.streaming_egnn_messages_plain))
            if shape == K3_SHAPE:
                k3b = (*(t.to(bf16) for t in (hA, hB)), *node, mask, *(t.to(bf16) for t in w))
                forms += [(form, shape, ES.streaming_egnn_messages, a, {"elem_bf16": elem},
                           "nbody_egnn_stream_phases", ES.streaming_egnn_messages_plain)
                          for form, a, elem in (("K3-bf16", k3b, False), ("K3-elem", k3b, True),
                                                ("K3-elem-f32", (hA, hB, *node, mask, *w), True))]
        calls = [functools.partial(fn, *a, **kw) for _, _, fn, a, kw, _, _ in forms]
        for (form, shape, fn, a, kw, _, plain), call in zip(forms, calls):  # the normal library
            row = {"form": form, "shape": shape, "ms": timed_ms(call, args.iters),
                   "err_f64": f64_errors(fn, plain, a, kw)}
            torch.cuda.empty_cache()
            print(json.dumps(row), flush=True)
        lib = load_instrumented()
        names = phase_names(lib)
        for (form, shape, _, _, _, reader, _), call in zip(forms, calls):
            row = split(getattr(lib, reader), names, call, args.iters)
            print(json.dumps({"form": form, "shape": shape, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
