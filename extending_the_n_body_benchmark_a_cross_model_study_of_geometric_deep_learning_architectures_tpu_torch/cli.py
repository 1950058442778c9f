"""Command-line entry point of the port::

    python -m extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.cli \\
        {train,self-feed,validate,ks-test,hpo} [--device cpu] ...

The JAX package's mains, with their flags and defaults, each on the card
unless ``--device`` names another device:

* ``train``: its ``train_main`` (``train.py``), the same config and
  dot-overrides; under a launcher (``torchrun --nproc_per_node K -m
  <package>.cli train ...``) it joins the launcher's process group first
  (``parallel.mesh.initialize_distributed``), and with a group of K > 1
  ranks up (the launcher's, or one the caller set up) the trainer runs
  data parallel;
* ``self-feed``: its ``self_feed_main`` (``self_feed.py``), a battery of
  self-feed draws of a run's checkpoint against fresh GT;
* ``validate``: its ``validate_main`` (``validate.py``), the run's loss and
  percentage errors over fresh batches;
* ``ks-test``: its ``ks_test_main``, the KS ranking of a run's checkpoints
  (``evaluation.ks_checkpoints``);
* ``hpo``: its ``hpo_main``, a TPE study (``hpo.hpo``).

The studies keep their module main: ``python -m <package>.evaluation.studies``.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import statistics
import sys

import numpy as np
from . import _tf32  # noqa: F401  (TF32 off before torch is used)
import torch

_SELF_FEED_DOC = """Self-feed rollout and macro evaluation of a run's checkpoint.

``--draws K`` runs K independent evaluation draws (fresh ground truth each,
and in train mode the model in training mode, a model with dropout drawing
its masks from the seed ``--seed + draw``) and reports each draw's, the best
and the median combined KS p."""

_VALIDATE_DOC = """One-step validation of a trained checkpoint: fresh on-the-fly batches,
the mean loss and per-target percentage errors."""


def set_seed(seed) -> None:
    """Seed Python's, NumPy's and torch's generators (nothing for None)."""
    if seed is None:
        return
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def _device_flag(argv):
    """``(--device value, the other arguments)``."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default="cuda")
    known, rest = p.parse_known_args(argv)
    return known.device, rest


def train_main(argv=None):
    from .parallel.mesh import initialize_distributed, launcher_env
    from .train.trainer import create_trainer_from_args
    from .utils.config import parse_args

    if launcher_env():
        initialize_distributed()
    device, rest = _device_flag(argv)
    args, resolved = parse_args(rest)
    set_seed(getattr(args, "seed", None))
    trainer = create_trainer_from_args(args, resolved_config=resolved, device=device)
    print(f"Training {args.model_type} | params: {trainer.n_params:,} | "
          f"run dir: {trainer.save_dir_path}")
    trainer.train()
    return trainer


def resolve_train_mode(flag: str, targs) -> bool:
    """``--train_mode``: ``auto`` is the run's ``self_feed_train_mode``."""
    if flag == "auto":
        return bool(getattr(targs, "self_feed_train_mode", True))
    return flag == "on"


def resolve_matmul_precision(flag: str, targs):
    """``--matmul_precision``: ``auto`` is the run's
    ``self_feed_matmul_precision``, ``default`` is None (the device's default);
    anything else is itself."""
    if flag == "auto":
        return getattr(targs, "self_feed_matmul_precision", None)
    if flag == "default":
        return None
    return flag


def best_and_median(draws):
    """The best draw and the median combined p, NaN-safe: a draw whose
    combined p is NaN never wins and stays out of the median (NaN when no draw
    has a p)."""
    def p(d):
        v = d["combined_pvalue"]
        return v if v == v else -1.0

    best = max(draws, key=p)
    valid = sorted(p(d) for d in draws if p(d) >= 0.0)
    return best, (statistics.median(valid) if valid else float("nan"))


def self_feed_main(argv=None):
    p = argparse.ArgumentParser(description=_SELF_FEED_DOC)
    p.add_argument("--run_dir", required=True)
    p.add_argument("--checkpoint", default="model.ckpt")
    p.add_argument("--n_bodies", type=int, default=None)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--plot", action="store_true")
    p.add_argument("--out", default=None, help="output dir (default: run_dir/generated_trajectories)")
    p.add_argument("--draws", type=int, default=1, help="independent evaluation draws")
    p.add_argument("--seed", type=int, default=0, help="base rollout rng seed")
    p.add_argument("--train_mode", choices=["auto", "on", "off"], default="auto",
                   help="rollout in training mode (auto: the run's self_feed_train_mode)")
    p.add_argument("--matmul_precision", default="auto",
                   help="matmul precision of the rollout (float32: TF32 off; 'auto': the "
                   "run's self_feed_matmul_precision; 'default': the device's default)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from .metrics import artifacts
    from .rollout.self_feed import run_self_feed
    from .train.restore import load_run
    from .train.trainer import matmul_precision

    model, dataset, targs = load_run(args.run_dir, checkpoint=args.checkpoint,
                                     n_bodies=args.n_bodies, seed=args.seed, device=args.device)
    if args.steps is None:
        # the trainer's own checkpoint evaluations roll out this far
        args.steps = getattr(targs, "self_feed_limit_steps", None)
    train_mode = resolve_train_mode(args.train_mode, targs)
    precision = resolve_matmul_precision(args.matmul_precision, targs)

    out = args.out or os.path.join(args.run_dir, "generated_trajectories")
    draws = []
    for i in range(max(1, args.draws)):
        with matmul_precision(precision):
            loc_gt, vel_gt, loc_pred, vel_pred, survived = run_self_feed(
                model, dataset, num_steps=args.steps, batch_size=args.batch_size,
                train_mode=train_mode, rng=args.seed + i,
            )
        draw_out = out if args.draws <= 1 else os.path.join(out, f"draw_{i:02d}")
        per, combined, _, _ = artifacts.evaluate_rollout(
            draw_out, loc_gt, vel_gt, loc_pred, vel_pred, plot=args.plot
        )
        draws.append({"draw": i, "steps_survived": survived, "combined_pvalue": combined,
                      "per_macro": per})
        print(f"draw {i}: survived={survived} combined p={combined:.4g}")

    best, median = best_and_median(draws)
    for k, v in best["per_macro"].items():
        print(f"  ks p [{k}] (best draw): {v:.4g}")
    print(f"steps survived (best draw): {best['steps_survived']}")
    print(f"combined macro p: best={best['combined_pvalue']:.4g} "
          f"median={median:.4g} over {len(draws)} draw(s) "
          f"(train_mode={'on' if train_mode else 'off'})")
    summary = {"train_mode": train_mode, "seed": args.seed, "draws": draws,
               "best_combined_pvalue": best["combined_pvalue"],
               "median_combined_pvalue": median}
    # written for one draw too: it marks a finished battery
    with open(os.path.join(out, "self_feed_draws.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(f"artifacts written to {out}")
    return summary


def validate_main(argv=None):
    p = argparse.ArgumentParser(description=_VALIDATE_DOC)
    p.add_argument("--run_dir", required=True)
    p.add_argument("--checkpoint", default="model.ckpt")
    p.add_argument("--batches", type=int, default=10)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from .core import graph as G
    from .train.losses import build_loss_fn, percentage_errors
    from .train.restore import load_run
    from .train.trainer import resolve_dtype

    model, dataset, targs = load_run(args.run_dir, checkpoint=args.checkpoint, device=args.device)
    model.eval()
    loss_fn = build_loss_fn(targs)
    k = getattr(targs, "num_neighbors", None) or dataset.num_nodes - 1
    targets = targs.target.split("+")
    # the run's training dtype, so the loss compares with its logged validation
    dtype = resolve_dtype(getattr(targs, "precision_mode", "single"))

    rows = []
    with torch.no_grad():  # the model's edge stage is then kernel K1 on the card
        for _ in range(args.batches):
            scene, y = dataset.get_batch()
            scene, y = scene.astype(dtype), y.to(dtype)
            pred = model(scene, G.knn_mask(scene.pos, k))
            total, terms = loss_fn(pred, scene, y)
            rows.append((total, terms, percentage_errors(pred, y, targets)))
    # one fetch for all batches, in float64
    keys_t, keys_p = list(rows[0][1]), list(rows[0][2])
    arr = torch.stack([torch.stack([t] + [a[k_] for k_ in keys_t] + [b[k_] for k_ in keys_p])
                       .to(torch.float64) for t, a, b in rows]).cpu().numpy()
    means = arr.mean(axis=0)
    result = {"loss": float(means[0]),
              **{k_: float(v) for k_, v in zip(keys_t, means[1:1 + len(keys_t)])},
              **{k_: float(v) for k_, v in zip(keys_p, means[1 + len(keys_t):])}}
    print(f"valid/loss: {result['loss']:.6f} over {args.batches} batches")
    for key in keys_t:
        print(f"valid/{key}: {result[key]:.6f}")
    for key in keys_p:
        print(f"valid/{key}: {result[key]:.3f}%")
    return result


def ks_test_main(argv=None):
    """KS-rank the checkpoints of a run (or summarise several runs)."""
    from .evaluation.ks_checkpoints import main

    return main(argv)


def hpo_main(argv=None):
    """A hyper-parameter study."""
    from .hpo.hpo import main

    return main(argv)


MAINS = {"train": train_main, "self-feed": self_feed_main, "validate": validate_main,
         "ks-test": ks_test_main, "hpo": hpo_main}


def kernel_launches() -> dict:
    """This process's launches of each kernel form so far, by its wrapper's
    counter (a wrapper counts only where it launches its kernel, on the card)."""
    from .ops import egnn_messages as EM, egnn_stream as ES, gravity

    k1, k3 = EM.fused_egnn_messages, ES.streaming_egnn_messages
    return {"k1": k1.launches, "k1_bf16": k1.launches_bf16,
            "k2": gravity.acceleration.launches, "leapfrog": gravity.leapfrog.launches,
            "k3": k3.launches, "k3_bf16": k3.launches_bf16, "k3_elem": k3.launches_elem}


def main(argv=None):
    """Run a command; where it launched a kernel, a last line names the
    launches, e.g. ``kernel launches (train on cuda): {"k1": 5970, ...}``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in MAINS:
        raise SystemExit(f"usage: python -m <package>.cli {{{','.join(MAINS)}}} [--device cpu] "
                         "...; python -m <package>.cli <command> --help for its flags")
    before = kernel_launches()
    out = MAINS[argv[0]](argv[1:])
    launched = {k: n - before[k] for k, n in kernel_launches().items() if n > before[k]}
    if launched:
        print(f"kernel launches ({argv[0]} on {_device_flag(argv[1:])[0]}): "
              f"{json.dumps(launched)}", flush=True)
    return out


if __name__ == "__main__":
    main()
