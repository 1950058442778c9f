"""Where a rollout step's time goes on the card: device busy time against wall time.

    python -m extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.rollout_trace [--family egnn_mc|egnn_mc_stream|segnn|equiformer_v2|graph_transformer] [--runs 3]

``egnn_mc`` (the default) rolls the committed N=100 checkpoint (EGNN-MC
6 x 128, fully connected, B=64) out from fresh ground truth (seed 0, 2000
substeps, a frame every 10: 199 steps), in f32 and in mixed bf16, as
``chip_smoke.py``'s ``[rollout]`` and ``[rollout-bf16]`` do;
``egnn_mc_stream`` rolls the same checkpoint in the streaming model at N=512,
B=8 (1000 substeps: 99 steps, K3 six times a step) in f32,
``stream-mixed-bf16`` (K3-bf16) and ``stream-mixed-ebf16`` (K3-elem), as
``[bign-rollout]`` and ``[bign-rollout-bf16]`` do; ``segnn`` rolls
the committed SEGNN checkpoint (L6 w448, N=5, B=64) out over the
evaluation's 999 steps (10000 substeps), in f32, as ``[segnn-rollout]``
does; ``equiformer_v2`` the committed EquiformerV2 checkpoint (L8 c128, N=5,
B=64) over the same 999 steps, in training mode with live dropout (the
evaluation's mode, masks seeded with 0); its trace of ~1.3M kernels takes
minutes to read (~15 minutes in all); ``graph_transformer`` the committed
GraphTransformer checkpoint (L8 h248, 8 heads, N=5, B=64) over the same 999
steps, in training mode with live dropout, as ``[gt-rollout]`` rolls it.
Each config runs once to warm up, then ``--runs`` times untraced (wall ms a
step: host clock, synchronised at the end), then once under
``torch.profiler``: the summed time of the CUDA kernels a step, the edge
kernel's part of it, and the device's idle share of the traced wall time;
then once more untraced, after the trace (whether tracing changed the
process's later launches).  The rollout launches without waiting on
the device, so a step takes the longer of the host's launches and the
device's work: where the untraced wall time a step is well above the
device's busy time, the host sets it.  Prints the card's name and power
limit, then one JSON line per config.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from .bign_bench import card_name
from .core.scene import Scene
from .data.gravity_otf import GravityDatasetOtf
from .models import create_model
from .rollout.self_feed import make_rollout_fn
from .weights import params_from_jax, read_jax_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "docs", "results", "fidelity_n100", "egnn_n100_ckpt_30_model.ckpt")
SEGNN_CKPT = os.path.join(REPO, "docs", "results", "segnn10m_r5", "ckpt_110_model.ckpt")
EQV2_CKPT = os.path.join(REPO, "docs", "results", "eqv2_10m_L8c128_cont", "ckpt_130_model.ckpt")
GT_CKPT = os.path.join(REPO, "docs", "results", "gt10m_r5", "ckpt_130_model.ckpt")
SAMPLE_FREQ = 10
# family -> (checkpoint, B, N, substeps, model kwargs, configs: (name, kwargs, train mode))
FAMILIES = {
    "egnn_mc": (CKPT, 64, 100, 2000, {},
                (("f32", {}, False), ("mixed-bf16", {"compute_dtype": "bfloat16"}, False))),
    "egnn_mc_stream": (CKPT, 8, 512, 1000, {"streaming": True},
                       (("f32", {}, False),
                        ("stream-mixed-bf16", {"compute_dtype": "bfloat16"}, False),
                        ("stream-mixed-ebf16", {"compute_dtype": "bfloat16",
                                                "stream_elem_bf16": True}, False))),
    "segnn": (SEGNN_CKPT, 64, 5, 10000, {"num_layers": 6, "hidden_features": 448},
              (("f32", {}, False),)),
    "equiformer_v2": (EQV2_CKPT, 64, 5, 10000,
                      {"num_layers": 8, "sphere_channels": 128, "attn_hidden_channels": 128,
                       "ffn_hidden_channels": 128, "num_heads": 8},
                      (("f32-train", {}, True),)),
    "graph_transformer": (GT_CKPT, 64, 5, 10000,
                          {"num_layers": 8, "hidden_features": 248, "num_heads": 8},
                          (("f32-train", {}, True),)),
}
# the registry's name of a family's model, where it differs from the family's
MODEL = {"egnn_mc_stream": "egnn_mc"}
# the edge kernels' __global__ names (csrc/egnn_messages.cu, K1; csrc/egnn_stream.cu, K3),
# each a prefix of its bf16 form's
EDGE_KERNELS = ("egnn_edge_kernel", "egnn_stream_kernel")


def device_us(event) -> float:
    """An event's own device time in microseconds (the attribute's name moved)."""
    t = getattr(event, "self_device_time_total", None)
    return float(t if t is not None else event.self_cuda_time_total)


def measure(model, scene0, target: str, steps: int, runs: int) -> dict:
    fn = make_rollout_fn(model, steps + 1, target=target)
    fn(scene0)
    torch.cuda.synchronize()
    walls = []
    for _ in range(runs):
        t = time.perf_counter()
        fn(scene0)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3 / steps)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        fn(scene0)
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t) * 1e3 / steps
    t = time.perf_counter()
    fn(scene0)
    torch.cuda.synchronize()
    after = (time.perf_counter() - t) * 1e3 / steps
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(device_us(e) for e in kernels) / 1e3 / steps
    edge = sum(device_us(e) for e in kernels
               if any(k in e.key for k in EDGE_KERNELS)) / 1e3 / steps
    launches = sum(e.count for e in kernels) / steps
    return {
        "wall_ms_per_step": sorted(walls),
        "traced_wall_ms_per_step": traced,
        "wall_ms_per_step_after_trace": after,
        "device_busy_ms_per_step": busy,
        "edge_kernel_ms_per_step": edge,
        "device_ops_per_step": launches,
        "device_idle_share_traced": 1.0 - busy / traced if traced > 0 else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", choices=sorted(FAMILIES), default="egnn_mc")
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rollout_trace needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(card_name(), flush=True)
    ckpt, b, n, substeps, shape, configs = FAMILIES[args.family]
    family = MODEL.get(args.family, args.family)
    state = params_from_jax(read_jax_checkpoint(ckpt), family)
    ds = GravityDatasetOtf(batch_size=b, sim_length=substeps, sample_freq=SAMPLE_FREQ,
                           num_nodes=n, interaction_strength=2.0, softening=0.2, seed=0,
                           device=dev)
    loc, vel, force, mass = ds.get_ground_truth_trajectories()
    scene0 = Scene(pos=loc[:, 0], vel=vel[:, 0], force=force[:, 0], mass=mass)
    steps = int(loc.shape[1]) - 1
    for config, kw, train_mode in configs:
        model = create_model(family, device=dev, **shape, **kw)
        model.load_state_dict(state)
        model.train(train_mode)
        row = measure(model, scene0, ds.target, steps, args.runs)
        print(json.dumps({"family": args.family, "config": config, "train_mode": train_mode,
                          "B": b, "N": n,
                          "steps": steps, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
