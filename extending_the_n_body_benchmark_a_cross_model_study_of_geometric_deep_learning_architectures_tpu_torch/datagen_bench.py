"""GT datagen on the card: seconds per GT batch through the integrator
K2-leapfrog (one launch) and through the loop of K2 launches (one a substep).

    python -m extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.datagen_bench \\
        [--shapes 64:100:2000,8:512:1000,64:100:10000] [--clusters 4,8,16] [--runs 3]

For each ``B:N:substeps`` shape (a frame every 10 substeps, G = 2, softening
0.2, dt = 0.01, states from ``sample_initial_conditions`` with seed 12): the
loop of K2 launches once, the integrator ``--runs`` times, the loop again (in
turns, so that a drift of the card shows), then the integrator ``--runs``
times at each ``--clusters`` size that the shape can take, each call timed by
CUDA events.  Beside them: the integrator's bound, the larger of its
operations (20 flops a pair, one acceleration for the first frame and one a
substep up to the last frame) at 67 TFLOP/s and its bytes (the states read
once, the frames written once) at 3.35 TB/s, the share of it reached, its
launch, and the path ``simulate`` takes at the shape (``integrator_takes``).
Prints the card's name and power limit, then one JSON line per shape.  Needs
a card.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Sequence

from . import _tf32  # noqa: F401  (TF32 off before torch is used)
import torch

from .bign_bench import card_name
from .core.physics import sample_initial_conditions
from .ops import _build, gravity

SHAPES = ((64, 100, 2000), (8, 512, 1000), (64, 100, 10000))
SAMPLE_FREQ, G, SOFTENING, DT, SEED = 10, 2.0, 0.2, 0.01, 12
FLOPS_PER_PAIR = 20  # 3 sub, 6 for r2 + eps^2, rsqrt, 3 for inv^3 * m, 3 FMA
PEAK_F32_FLOPS, PEAK_BYTES = 67e12, 3.35e12  # H100 SXM: f32 on CUDA cores, HBM3


def bound_ms(B: int, N: int, substeps: int, freq: int = SAMPLE_FREQ):
    """The integrator's bound in ms and what sets it ("bytes" or "operations")."""
    frames = substeps // freq
    accels = 1 + (frames - 1) * freq
    t_ops = FLOPS_PER_PAIR * B * N * N * accels / PEAK_F32_FLOPS
    t_bytes = 4 * (B * N * 7 + 3 * B * frames * N * 3) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def event_s(fn) -> float:
    """Seconds of one call, by CUDA events."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def launch(B: int, N: int, sms: int, cluster=None) -> Dict:
    c, threads, per = gravity.leapfrog_launch(B, N, sms, cluster)
    return {"cluster": c, "threads": threads, "per": per}


def measure(B: int, N: int, substeps: int, dev, clusters: Sequence[int] = (),
            runs: int = 3) -> Dict:
    g = torch.Generator(device=dev).manual_seed(SEED)
    state = sample_initial_conditions(B, N, device=dev, generator=g)
    args = (substeps, SAMPLE_FREQ, G, SOFTENING, DT)
    sms = _build.sm_count(state[0])

    def integrator(cluster=None):
        if cluster is None:  # the wrapper, at the rule's cluster size
            return gravity.leapfrog(*state, *args)
        return gravity.launch_leapfrog(gravity.leapfrog_launch(B, N, sms, cluster), *state, *args)

    def k2_loop():
        return gravity.leapfrog_loop(*state, *args, gravity.acceleration)

    integrator()  # the library's first launch of this shape
    loop_first = event_s(k2_loop)
    times = [event_s(integrator) for _ in range(runs)]
    loop_last = event_s(k2_loop)
    mean = sum(times) / len(times)
    bound, by = bound_ms(B, N, substeps)
    tries = {}
    for c in clusters:
        try:
            shape = launch(B, N, sms, c)
        except ValueError:  # a cluster size this N cannot take
            continue
        tries[c] = {"s": [event_s(lambda: integrator(c)) for _ in range(runs)], **shape}
    return {"B": B, "N": N, "substeps": substeps, "integrator_s": times, "integrator_mean_s": mean,
            "k2_loop_s": [loop_first, loop_last],
            "speedup": min(loop_first, loop_last) / mean,
            "us_per_substep": mean * 1e6 / max(1, substeps - SAMPLE_FREQ),
            "bound_ms": bound, "bound_by": by, "bound_share": bound / 1e3 / mean,
            **launch(B, N, sms), "sms": sms, "clusters": tries,
            "simulate_takes": "integrator" if gravity.integrator_takes(B, N, sms) else "k2_loop"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default=",".join(":".join(map(str, s)) for s in SHAPES))
    ap.add_argument("--clusters", default="")
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("datagen_bench needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    clusters = [int(c) for c in args.clusters.split(",") if c]
    print(card_name(), flush=True)
    for shape in args.shapes.split(","):
        B, N, substeps = (int(x) for x in shape.split(":"))
        print(json.dumps(measure(B, N, substeps, dev, clusters, args.runs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
