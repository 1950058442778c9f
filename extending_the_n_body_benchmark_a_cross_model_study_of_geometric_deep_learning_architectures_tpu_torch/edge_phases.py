"""Where the edge kernels' time goes, phase by phase, on the card.

    python -m extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.edge_phases

Builds ``csrc/*.cu`` once more with ``-DEGNN_EDGE_PHASES`` into the package's
``_build/`` (a library of its own beside the normal one), points the wrappers
at it, and launches each form of the edge stage at its path's shape: K1 f32
and K1-bf16 at (B, N) = (64, 100), K3 f32, K3-bf16 and K3-elem at (8, 512),
fully connected, inputs and weights drawn from a seed at the model's init
scale.  Thread 0 of every block stamps ``clock64()`` at each phase boundary
(``csrc/egnn_edge.cuh``, ``PhaseClock``): a phase's clocks are thread 0's time
in it, and ``barrier`` is thread 0's wait at the barriers, which is the time
the slowest warp of the phase took beyond thread 0.  Prints the card's name and
power limit, then one JSON line per form: the SM clocks per chunk of each phase
summed over the blocks' thread 0, its share, the chunks and blocks of one
launch, and the instrumented launch's time (CUDA events).  Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import torch

from .bign_bench import card_name
from .ops import _build
from .ops import egnn_messages as EM
from .ops import egnn_stream as ES

PHASES = ("stage", "prologue", "m1", "w2_product", "m2_epilogue", "agg", "wc1_product_epilogue",
          "trans", "barrier", "means")  # egnn_edge.cuh, enum Phase, then chunks and blocks
WIDTH = 128
K1_SHAPE, K3_SHAPE = (64, 100), (8, 512)


def load_instrumented() -> ctypes.CDLL:
    """Build and bind the instrumented library, and make the wrappers launch it."""
    lib = ctypes.CDLL(_build.build(("-DEGNN_EDGE_PHASES",), "libnbody_phases"))
    _build.bind(lib)
    for fn in (lib.nbody_egnn_messages_phases, lib.nbody_egnn_stream_phases):
        fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    _build._lib = lib
    return lib


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


def split(read, call, iters: int) -> dict:
    """Run ``call`` ``iters`` times after a warm-up; the phase clocks of one launch."""
    out = (ctypes.c_ulonglong * (len(PHASES) + 2))()
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
    total = sum(ticks[:len(PHASES)])
    return {
        "ms": start.elapsed_time(end) / iters,
        "chunks": chunks, "blocks": blocks,
        "clocks_per_chunk": {p: t / chunks for p, t in zip(PHASES, ticks)},
        "share": {p: t / total for p, t in zip(PHASES, ticks)},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("edge_phases needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    lib = load_instrumented()
    print(card_name(), flush=True)
    bf16 = torch.bfloat16
    with torch.no_grad():
        (hA, hB), _, geom, mask, w = inputs(*K1_SHAPE, dev, gen)
        hb = [t.to(bf16) for t in (hA, hB)]
        wb = [t.to(bf16) for t in w]
        forms = {
            "K1": lambda: EM.fused_egnn_messages(hA, hB, geom, mask, *w),
            "K1-bf16": lambda: EM.fused_egnn_messages(*hb, geom, mask, *wb),
        }
        for form, call in forms.items():
            row = split(lib.nbody_egnn_messages_phases, call, args.iters)
            print(json.dumps({"form": form, "shape": K1_SHAPE, **row}), flush=True)
        del geom
        (hA, hB), node, _, mask, w = inputs(*K3_SHAPE, dev, gen)
        hb = [t.to(bf16) for t in (hA, hB)]
        wb = [t.to(bf16) for t in w]
        forms = {
            "K3": lambda: ES.streaming_egnn_messages(hA, hB, *node, mask, *w),
            "K3-bf16": lambda: ES.streaming_egnn_messages(*hb, *node, mask, *wb),
            "K3-elem": lambda: ES.streaming_egnn_messages(*hb, *node, mask, *wb, elem_bf16=True),
        }
        for form, call in forms.items():
            row = split(lib.nbody_egnn_stream_phases, call, args.iters)
            print(json.dumps({"form": form, "shape": K3_SHAPE, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
