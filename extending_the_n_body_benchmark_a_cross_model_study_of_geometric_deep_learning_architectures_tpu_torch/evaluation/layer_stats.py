"""Per-layer activation statistics: counterpart of the JAX package's
``evaluation/layer_stats.py`` and of its trainer's ``_build_layer_stats_fn``.

With ``trainer.debug_layer_stats_every`` set, the trainer appends one record
to ``<run>/layer_stats.jsonl`` every that many steps of an epoch:
``{"step": epoch, "debug/<flax path>.absmax|std|nan_or_inf": value}`` for
the model's top-level layers, under the flax paths the JAX package's model
gives them (``weights.flax_layer_paths``), so the records of both packages
read alike.  :func:`capture` takes them with forward hooks in one forward
pass; the record costs one device-to-host fetch.  :func:`summarize` is the
explosion forensics over the file: per-layer peak and last ``|activation|``
and the first step at which a layer went non-finite.

    python -m <package>.evaluation.layer_stats RUN_DIR [--top K]
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import torch

from ..weights import flax_layer_paths


def capture(model, scene, mask) -> Dict[str, torch.Tensor]:
    """``{"<flax path>.absmax|std|nan_or_inf": 0-d tensor}`` on the model's
    device, from one forward pass of ``model`` (in eval mode, no gradients)
    on ``scene`` and ``mask``."""
    stats: Dict[str, torch.Tensor] = {}

    def hook(names):
        def record(module, inputs, out):
            v = out.detach()
            for name in names:
                stats[f"{name}.absmax"] = v.abs().max()
                stats[f"{name}.std"] = v.std(correction=0)
                stats[f"{name}.nan_or_inf"] = (~torch.isfinite(v)).any()
        return record

    handles = [m.register_forward_hook(hook(names)) for m, names in flax_layer_paths(model)]
    was_training = model.training
    try:
        model.eval()
        with torch.no_grad():
            model(scene, mask)
    finally:
        model.train(was_training)
        for h in handles:
            h.remove()
    return stats


def record(step: int, stats: Dict[str, torch.Tensor]) -> dict:
    """The JSONL record of :func:`capture`'s statistics: one fetch."""
    values = torch.stack([v.to(torch.float64) for v in stats.values()]).cpu().tolist()
    return {"step": int(step), **{f"debug/{k}": v for k, v in zip(stats, values)}}


def load_layer_stats(run_dir: str) -> List[dict]:
    path = os.path.join(run_dir, "layer_stats.jsonl")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def summarize(records: List[dict]) -> Dict:
    """Per-layer summary: peak |act|, last std, first NaN/Inf step."""
    layers: Dict[str, Dict] = {}
    first_bad: Optional[int] = None
    first_bad_layer: Optional[str] = None
    for rec in records:
        step = rec.get("step", -1)
        for key, val in rec.items():
            if not key.startswith("debug/"):
                continue
            name, _, stat = key[len("debug/"):].rpartition(".")
            entry = layers.setdefault(name, {"absmax_peak": 0.0, "absmax_last": 0.0,
                                             "std_last": 0.0, "first_nan_step": None})
            if stat == "absmax":
                entry["absmax_peak"] = max(entry["absmax_peak"], val)
                entry["absmax_last"] = val
            elif stat == "std":
                entry["std_last"] = val
            elif stat == "nan_or_inf" and val:
                if entry["first_nan_step"] is None:
                    entry["first_nan_step"] = step
                if first_bad is None or step < first_bad:
                    first_bad, first_bad_layer = step, name
    return {
        "layers": layers,
        "first_nan_step": first_bad,
        "first_nan_layer": first_bad_layer,
        "num_records": len(records),
    }


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Summarize a run's layer_stats.jsonl")
    p.add_argument("run_dir")
    p.add_argument("--top", type=int, default=10, help="layers by peak |act|")
    args = p.parse_args(argv)
    s = summarize(load_layer_stats(args.run_dir))
    print(f"{s['num_records']} stat records")
    if s["first_nan_step"] is not None:
        print(f"FIRST NaN/Inf: step {s['first_nan_step']} in {s['first_nan_layer']}")
    else:
        print("no NaN/Inf recorded")
    ranked = sorted(s["layers"].items(), key=lambda kv: -kv[1]["absmax_peak"])
    for name, e in ranked[: args.top]:
        flag = f"  NaN@{e['first_nan_step']}" if e["first_nan_step"] is not None else ""
        print(f"  {name}: peak|act| {e['absmax_peak']:.3g} "
              f"last|act| {e['absmax_last']:.3g} last std {e['std_last']:.3g}{flag}")
    return s


if __name__ == "__main__":
    main()
