"""Big-N rollout bench: the dense edge stage (K1) against the streaming one (K3).

Counterpart of the JAX package's ``scripts/bign_bench.py``.  The same self-feed
rollout (``rollout.self_feed.make_rollout_fn``, fully connected) of EGNN-MC
(6 layers, width 128, f32) runs at large N in two single-card configurations:

* ``dense-k1``: ``EGNNMC()``, whose layers build the ``[B, N, N, 8]`` geometry
  and the ``[B, N, N, 4]`` edge attributes in device memory and hand them to
  kernel K1 (``csrc/egnn_messages.cu``);
* ``streaming-k3``: ``EGNNMC(streaming=True)``, whose kernel K3
  (``csrc/egnn_stream.cu``) computes the geometry from O(N) node data, so only
  the ``[B, N, N]`` mask lives in device memory.

Both use the same random parameters, drawn from ``torch.Generator(seed)``.  Per
row: steps/s over ``--steps`` steps after one short warm-up rollout, the
warm-up's seconds (``compile_s``: kernel library load and allocator warm-up;
nothing is compiled per shape), ``survived_min``, and the peak device memory
of the timed rollout (``torch.cuda.max_memory_allocated``) beside what was
already allocated when it started (the model, the scene and whatever else the
process holds), so that the rollout's own peak is their difference.

    python -m extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.bign_bench \\
        [--steps 50] [--shapes 256:16,512:8,1024:2,4096:1] [--device cuda|cpu] [--out FILE]

It runs on the card unless ``--device cpu`` is given, prints the payload (the
keys of the JAX script's ``bign_bench.json``) as one JSON object on stdout, and
writes it to a file only when ``--out`` names one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Dict, List, Tuple

from . import _tf32  # noqa: F401  (TF32 off before torch is used)
import torch

from .core.scene import Scene
from .models import EGNNMC, MODEL_DEFAULTS
from .models.egnn_mc import EGNNBlock
from .rollout.self_feed import make_rollout_fn

#: (N, B): the JAX script's rows, plus one beyond what the dense path can hold
#: on a TPU core; the batch shrinks with N
SHAPES: List[Tuple[int, int]] = [(256, 16), (512, 8), (1024, 2), (4096, 1)]
PATHS = {"dense-k1": False, "streaming-k3": True}  # path name -> streaming
WARMUP_STEPS = 2
SEED = 2  # the parameters' seed, as the JAX script's PRNGKey(2)
#: the JAX runs' result history, which this script never writes into
RESULTS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "docs", "results")


def seeded_state(seed: int) -> Dict[str, torch.Tensor]:
    """EGNN-MC (the registry's defaults) parameters drawn from
    ``torch.Generator().manual_seed(seed)``, with the default init's
    distributions: ``U(+-1/sqrt(fan_in))``, and the coordinate head's Xavier
    of gain 1e-3."""
    gen = torch.Generator().manual_seed(seed)
    model = EGNNMC(**MODEL_DEFAULTS["egnn_mc"])

    def draw(t: torch.Tensor, bound: float) -> None:
        t.uniform_(-bound, bound, generator=gen)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.Linear):
                draw(mod.weight, mod.in_features ** -0.5)
                draw(mod.bias, mod.in_features ** -0.5)
            elif isinstance(mod, EGNNBlock):
                for w, b in ((mod.edge_w1, mod.edge_b1), (mod.edge_w2, mod.edge_b2),
                             (mod.coord_w1, mod.coord_b1)):
                    draw(w, w.shape[0] ** -0.5)
                    draw(b, w.shape[0] ** -0.5)
                fan_in, fan_out = mod.coord_w2.shape
                draw(mod.coord_w2, 1e-3 * (6.0 / (fan_in + fan_out)) ** 0.5)
    return model.state_dict()


def make_scene(B: int, N: int, device, seed: int = 0) -> Scene:
    """The JAX script's scene: positions N(0, 1), velocities N(0, 0.01), unit masses."""
    gen = torch.Generator(device=device).manual_seed(seed)
    pos = torch.randn((B, N, 3), generator=gen, device=device)
    vel = torch.randn((B, N, 3), generator=gen, device=device) * 0.1
    return Scene(pos=pos, vel=vel, force=torch.zeros_like(pos),
                 mass=torch.ones((B, N, 1), device=device))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure_row(N: int, B: int, path: str, steps: int, state, device="cuda") -> Dict:
    """One row: the ``path`` model rolled out ``steps`` frames on ``make_scene(B, N)``."""
    model = EGNNMC(**MODEL_DEFAULTS["egnn_mc"], streaming=PATHS[path])
    model.load_state_dict(state)
    model = model.to(device).eval()
    scene = make_scene(B, N, device)
    on_card = torch.device(device).type == "cuda"

    t0 = time.perf_counter()
    make_rollout_fn(model, WARMUP_STEPS)(scene)
    _sync(device)
    warmup_s = time.perf_counter() - t0

    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
        start_bytes = torch.cuda.memory_allocated(device)
    fn = make_rollout_fn(model, steps)
    t0 = time.perf_counter()
    loc, _, survived = fn(scene)
    _sync(device)
    dt = time.perf_counter() - t0
    if not torch.isfinite(loc).all():
        raise RuntimeError(f"{path} rollout at N={N} B={B} is not finite")
    return {
        "n_bodies": N, "batch": B, "path": path,
        "steps_per_sec": (steps - 1) / dt,
        "compile_s": warmup_s,
        "survived_min": int(survived.min()),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(device) if on_card else None,
        "start_allocated_bytes": start_bytes if on_card else None,
    }


def card_name() -> str:
    """``name, power limit`` of the first card as nvidia-smi gives them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout.strip() else ""


def max_sm_clock_mhz() -> float:
    """The first card's maximum SM clock in MHz as nvidia-smi reports it
    (``clocks.max.sm``)."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return float(res.stdout.split()[0])


def run(shapes, steps: int, device) -> Dict:
    state = seeded_state(SEED)
    rows = []
    for N, B in shapes:
        for path in PATHS:
            row = measure_row(N, B, path, steps, state, device)
            print(f"N={N:5d} B={B:3d} {path:13s}: {row['steps_per_sec']:8.2f} steps/s "
                  f"survived_min {row['survived_min']} peak {row['max_memory_allocated_bytes']} B",
                  flush=True)
            rows.append(row)
    on_card = torch.device(device).type == "cuda"
    return {
        "rollout_steps": steps,
        "model": "egnn_mc L6 H128 f32",
        "tile_i": None, "tile_j": None,  # TPU tile sizes: no counterpart on the card
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "card": card_name() if on_card else None,
        "rows": rows,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--shapes", default=",".join(f"{n}:{b}" for n, b in SHAPES),
                    help="comma-separated N:B pairs")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the payload to this file")
    args = ap.parse_args(argv)
    if args.out and os.path.abspath(args.out).startswith(RESULTS_DIR + os.sep):
        raise SystemExit(f"--out {args.out}: docs/results/ holds the JAX runs' history")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: give --device cpu to run on the CPU")
    shapes = [tuple(int(x) for x in s.split(":")) for s in args.shapes.split(",")]
    payload = run(shapes, args.steps, torch.device(args.device))
    print(json.dumps(payload), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(payload, fh, indent=1)


if __name__ == "__main__":
    main()
