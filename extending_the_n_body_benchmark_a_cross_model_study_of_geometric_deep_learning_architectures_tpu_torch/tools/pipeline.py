"""Resilient train -> KS-score -> draw-battery pipeline runner: counterpart
of the JAX repo's ``scripts/pipeline.py``, with the same stages, files and
decisions, each stage the port's own CLI in a subprocess:

1. **train**: ``python -m <package>.cli train`` for the requested
   model/overrides unless the work dir already holds a usable run.  Before
   every attempt the card is probed in a bounded subprocess
   (``utils.device.wait_for_backend``); attempts retry with a poll interval
   until ``--deadline-hours`` elapses.  An attempt resumes from the newest
   ``model.ckpt`` under the workdir (the port's or the JAX trainer's).
   There is no fallback to the CPU: a card that never answers ends the
   pipeline with ``{"status": "failed", "stage": "train"}``.
2. **score**: ``cli ks-test`` (published six-macro basis; no GT is drawn,
   so no device work) on every run dir without a ``ks_summary.json``.
3. **draws**: ``cli self-feed --draws K`` batteries at the top ``--top-k``
   checkpoints by in-run combined p, skipping finished ones.

Each stage re-checks its files, so the same command after a crash or an
outage goes on where it stopped.  Prints a final JSON line with the best
combined p found across the runs and batteries.  ``--device`` (a torch
device, default ``cuda``) is passed to every stage and names what the probe
tests; ``--device cpu`` runs the loop on the host.

Usage:
    python -m <package>.tools.pipeline --workdir /tmp/gt10m --model graph_transformer \\
        --epochs 900 --draws 12 --top-k 3 \\
        -o model.num_layers=8 -o model.hidden_features=248 -o model.num_heads=8
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

#: the repo root's config.yaml, the JAX pipeline's default ``--config``
ROOT_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.realpath(__file__)))),
    "config.yaml")
CLI = __package__.rsplit(".", 1)[0] + ".cli"  # also under ``python -m``

Runner = Callable[..., "subprocess.CompletedProcess"]


def _cli(command: str, device: str) -> List[str]:
    """The head of a stage's command: the port's CLI on ``device``."""
    return [sys.executable, "-m", CLI, command, "--device", device]


def _default_wait():
    from ..utils.device import wait_for_backend

    return wait_for_backend


def latest_run(workdir: str) -> Optional[str]:
    """Newest run dir under ``<workdir>/runs/<model>/<stamp>`` or None."""
    runs = glob.glob(os.path.join(workdir, "runs", "*", "*"))
    runs = [r for r in runs if os.path.isdir(r)]
    return max(runs, key=os.path.getmtime) if runs else None


def run_usable(run_dir: Optional[str], min_checkpoints: int) -> bool:
    if not run_dir:
        return False
    ckpts = os.path.join(run_dir, "checkpoints")
    return os.path.isdir(ckpts) and len(os.listdir(ckpts)) >= min_checkpoints


def runs_with_checkpoints(workdir: str) -> List[str]:
    """All run dirs under the workdir that hold at least one checkpoint,
    oldest first (a continued run appends a fresh run dir holding only the
    epochs it added)."""
    out = []
    for r in glob.glob(os.path.join(workdir, "runs", "*", "*")):
        ckpts = os.path.join(r, "checkpoints")
        if os.path.isdir(ckpts) and os.listdir(ckpts):
            out.append(r)
    return sorted(out, key=os.path.getmtime)


def total_epochs_reached(workdir: str) -> int:
    """Highest checkpoint epoch across every run dir (continuations count)."""
    best = 0
    for r in runs_with_checkpoints(workdir):
        for name in os.listdir(os.path.join(r, "checkpoints")):
            try:
                best = max(best, int(name))
            except ValueError:
                continue
    return best


def continuation_ckpt(workdir: str) -> Optional[str]:
    """Newest partial run's ``model.ckpt`` to resume from, or None.

    The trainer snapshots ``model.ckpt`` every save cadence and on a crash,
    so an outage mid-run leaves a resumable state.  A run killed before its
    first checkpoint dir still counts: the crash snapshot alone is
    resumable."""
    runs = sorted(
        (r for r in glob.glob(os.path.join(workdir, "runs", "*", "*"))
         if os.path.isdir(r)),
        key=os.path.getmtime,
    )
    for r in reversed(runs):
        ck = os.path.join(r, "model.ckpt")
        if os.path.exists(ck):
            return ck
    return None


def _train_cmd(args, model_path: Optional[str] = None) -> List[str]:
    cmd = _cli("train", args.device) + [
        "--config", args.config,
        "--main.model_type", args.model,
        "--trainer.train_steps", str(args.epochs),
        "--trainer.run_name", args.run_name,
    ]
    overrides = {}
    for ov in args.override:
        key, _, val = ov.partition("=")
        overrides[key] = val
    if model_path:
        # resume against the root config and the explicit overrides, never the
        # old run's round-tripped config.yaml (it lacks fields added since)
        cmd += ["--trainer.model_path", model_path]
        # an explicitly seeded dataset would replay its stream from epoch 0 on
        # resume (the checkpoint restores parameters, optimizer and step, not
        # the data generator): bump the seed by the epochs already consumed.
        # Unseeded runs draw fresh entropy anyway.
        if "dataloader.seed" in overrides:
            base = int(overrides["dataloader.seed"])
            bumped = base + total_epochs_reached(args.workdir)
            overrides["dataloader.seed"] = str(bumped)
            print(f"pipeline: resume bumps dataloader.seed {base} -> {bumped}",
                  file=sys.stderr)
    for key, val in overrides.items():
        cmd += [f"--{key}", val]
    return cmd


def _target_reached(args) -> bool:
    """Training is done once the epoch target is reached across continuation
    run dirs (checkpoints land every ``--ckpt-interval`` epochs, so the last
    one is at the largest multiple <= the target).  ``--min-checkpoints`` is
    the criterion only when the target is below one interval: it must not
    call a partly trained run done."""
    final_epoch = (args.epochs // args.ckpt_interval) * args.ckpt_interval
    if final_epoch > 0:
        return total_epochs_reached(args.workdir) >= final_epoch
    return run_usable(latest_run(args.workdir), args.min_checkpoints)


def ensure_run(args, runner: Runner = subprocess.run,
               wait_fn: Optional[Callable[..., bool]] = None) -> Optional[str]:
    """Train until a usable run exists in ``args.workdir`` or the deadline hits."""
    if wait_fn is None:
        wait_fn = _default_wait()
    os.makedirs(args.workdir, exist_ok=True)
    if _target_reached(args):
        run = latest_run(args.workdir)
        print(f"pipeline: reusing run {run}", file=sys.stderr)
        return run
    deadline = time.time() + args.deadline_hours * 3600.0
    attempt, stalls = 0, 0
    while time.time() < deadline:
        remaining = deadline - time.time()
        if not wait_fn(max_wait_s=remaining, probe_timeout_s=90.0,
                       poll_s=args.poll_s, platform=args.device, verbose=True):
            break
        attempt += 1
        resume = continuation_ckpt(args.workdir)
        before = total_epochs_reached(args.workdir)
        print(
            "pipeline: training attempt "
            f"{attempt}{f' (resuming from {resume})' if resume else ''}",
            file=sys.stderr,
        )
        log = os.path.join(args.workdir, f"train_attempt{attempt}.log")
        with open(log, "w") as fh:
            try:
                runner(_train_cmd(args, model_path=resume), cwd=args.workdir,
                       stdout=fh, stderr=subprocess.STDOUT,
                       timeout=args.train_timeout_s)
            except subprocess.TimeoutExpired:
                # an overrunning attempt is not fatal: its checkpoints are on
                # disk and the next attempt resumes from them
                print(f"pipeline: attempt {attempt} hit --train-timeout-s "
                      f"({args.train_timeout_s:.0f}s); will resume",
                      file=sys.stderr)
        if _target_reached(args):
            return latest_run(args.workdir)
        # two consecutive attempts without epoch progress end the retries
        # (e.g. a finished run whose last checkpoint misses the target)
        stalls = stalls + 1 if total_epochs_reached(args.workdir) <= before else 0
        if stalls >= 2:
            print("pipeline: no epoch progress over two attempts; "
                  "giving up on training", file=sys.stderr)
            break
        print(f"pipeline: attempt {attempt} did not reach the target "
              f"(see {log}); re-probing", file=sys.stderr)
        time.sleep(min(args.poll_s, max(0.0, deadline - time.time())))
    if _target_reached(args):
        return latest_run(args.workdir)
    # a run within one checkpoint interval of the target is accepted: scored
    # and drawn beats discarding nearly all of a training run
    final_epoch = (args.epochs // args.ckpt_interval) * args.ckpt_interval
    total = total_epochs_reached(args.workdir)
    if final_epoch > 0 and total >= final_epoch - args.ckpt_interval and total > 0:
        print(f"pipeline: accepting near-complete run at epoch {total} "
              f"(target {final_epoch})", file=sys.stderr)
        return latest_run(args.workdir)
    return None


def score_run(run_dir: str, runner: Runner = subprocess.run,
              timeout_s: float = 5400.0, device: str = "cuda") -> bool:
    """Produce ``ks_summary.json`` for ``run_dir`` if missing (no GT is
    drawn: the scorer reads the checkpoints' macro files on the host)."""
    summary = os.path.join(run_dir, "ks_summary.json")
    if os.path.exists(summary):
        return True
    try:
        runner(_cli("ks-test", device) + [run_dir], timeout=timeout_s)
    except subprocess.TimeoutExpired:
        print(f"pipeline: scoring {run_dir} timed out", file=sys.stderr)
    return os.path.exists(summary)


def aggregate_top_checkpoints(run_dirs: List[str], k: int) -> List[tuple]:
    """Top-k (run_dir, checkpoint) pairs by in-run combined p across all
    run dirs of a workdir: a continued run's summaries compete as one
    series (its checkpoints are split across run dirs)."""
    ranked = []
    for rd in run_dirs:
        try:
            with open(os.path.join(rd, "ks_summary.json")) as fh:
                summary = json.load(fh)
        except (OSError, ValueError):
            continue
        for rec in summary.get("results", []):
            ck = str(rec["checkpoint"])
            if os.path.exists(os.path.join(rd, "checkpoints", ck, "model.ckpt")):
                ranked.append((rec.get("combined_pvalue", 0.0), rd, ck))
    ranked.sort(key=lambda t: -t[0])
    return [(rd, ck) for _, rd, ck in ranked[:k]]


def draw_batteries_at(targets: List[tuple], args,
                      runner: Runner = subprocess.run,
                      wait_fn: Optional[Callable[..., bool]] = None,
                      seed: Optional[int] = None,
                      prefix: str = "draws_ckpt") -> None:
    """Draw batteries at explicit (run_dir, checkpoint) targets."""
    if wait_fn is None:
        wait_fn = _default_wait()
    for run_dir, ck in targets:
        out_dir = os.path.join(run_dir, f"{prefix}{ck}")
        # done = the end-of-battery summary exists; a battery killed mid-draws
        # leaves only draw_NN/ dirs and runs again (self-feed overwrites them)
        if os.path.exists(os.path.join(out_dir, "self_feed_draws.json")):
            continue
        if not wait_fn(max_wait_s=args.deadline_hours * 3600.0,
                       probe_timeout_s=90.0, poll_s=args.poll_s,
                       platform=args.device, verbose=True):
            print("pipeline: backend never recovered; skipping draws",
                  file=sys.stderr)
            return
        print(f"pipeline: draws at {run_dir} checkpoint {ck}", file=sys.stderr)
        try:
            runner(_cli("self-feed", args.device) + [
                "--run_dir", run_dir,
                "--checkpoint", f"checkpoints/{ck}/model.ckpt",
                "--draws", str(args.draws),
                "--seed", str(args.draw_seed if seed is None else seed),
                "--out", out_dir,
            ], timeout=args.draw_timeout_s)
        except subprocess.TimeoutExpired:
            print(f"pipeline: battery at {run_dir} ckpt {ck} timed out; "
                  "continuing", file=sys.stderr)


def best_checkpoint_overall(run_dirs: List[str]) -> Optional[tuple]:
    """(run_dir, checkpoint) with the highest combined p across in-run
    summaries and existing draw batteries: the second battery's target."""
    best_p, best = -1.0, None
    for rd in run_dirs:
        try:
            with open(os.path.join(rd, "ks_summary.json")) as fh:
                for rec in json.load(fh).get("results", []):
                    ck = str(rec["checkpoint"])
                    p = rec.get("combined_pvalue", 0.0)
                    if p > best_p and os.path.exists(
                        os.path.join(rd, "checkpoints", ck, "model.ckpt")
                    ):
                        best_p, best = p, (rd, ck)
        except (OSError, ValueError):
            pass
        for f in glob.glob(os.path.join(rd, "draws_ckpt*", "self_feed_draws.json")):
            ck = os.path.basename(os.path.dirname(f))[len("draws_ckpt"):]
            try:
                with open(f) as fh:
                    p = json.load(fh).get("best_combined_pvalue", 0.0)
            except (OSError, ValueError):
                continue
            if p > best_p and os.path.exists(
                os.path.join(rd, "checkpoints", ck, "model.ckpt")
            ):
                best_p, best = p, (rd, ck)
    return best


def best_combined_p(workdir: str) -> Dict[str, float]:
    """Best combined p across every run's ks_summary and draw batteries."""
    best_in_run, best_draw = 0.0, 0.0
    for run in glob.glob(os.path.join(workdir, "runs", "*", "*")):
        try:
            with open(os.path.join(run, "ks_summary.json")) as fh:
                summary = json.load(fh)
            best_in_run = max(
                best_in_run,
                max((r.get("combined_pvalue", 0.0)
                     for r in summary.get("results", [])), default=0.0))
        except (OSError, ValueError):
            pass
        for f in glob.glob(os.path.join(run, "draws*_ckpt*", "self_feed_draws.json")):
            try:
                with open(f) as fh:
                    draws = json.load(fh)
                best_draw = max(
                    best_draw,
                    max((d.get("combined_pvalue", 0.0)
                         for d in draws.get("draws", [])), default=0.0))
            except (OSError, ValueError):
                pass
    return {"best_in_run": best_in_run, "best_draw": best_draw,
            "best": max(best_in_run, best_draw)}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workdir", required=True,
                   help="pipeline working dir (runs/ + sim cache live here)")
    p.add_argument("--model", required=True)
    p.add_argument("--epochs", type=int, required=True,
                   help="trainer.train_steps (epochs of 1000 steps)")
    p.add_argument("--config", default=ROOT_CONFIG)
    p.add_argument("--run-name", default="pipeline")
    p.add_argument("-o", "--override", action="append", default=[],
                   help="dot-path config override, e.g. model.num_layers=8")
    p.add_argument("--min-checkpoints", type=int, default=100,
                   help="checkpoint dirs required to call a run usable")
    p.add_argument("--ckpt-interval", dest="ckpt_interval", type=int,
                   default=10,
                   help="checkpoint cadence in epochs (trainer "
                        "test_macros_every); with continuations, training "
                        "is also done once any checkpoint reaches the last "
                        "multiple of this <= --epochs")
    p.add_argument("--draws", type=int, default=12)
    p.add_argument("--draw-seed", type=int, default=0)
    p.add_argument("--second-draw-seed", dest="second_draw_seed", type=int,
                   default=None,
                   help="if set, run one extra battery with this seed at "
                        "the best checkpoint found so far")
    p.add_argument("--top-k", type=int, default=3,
                   help="checkpoints (by in-run p) to run draw batteries at")
    p.add_argument("--deadline-hours", type=float, default=12.0)
    p.add_argument("--poll-s", dest="poll_s", type=float, default=300.0)
    p.add_argument("--train-timeout-s", type=float, default=21600.0)
    p.add_argument("--draw-timeout-s", type=float, default=3600.0)
    p.add_argument("--skip-draws", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of every stage and of the health probe "
                        "(cuda, cuda:1, cpu); never falls back to the CPU")
    return p


def main(argv: Optional[Sequence[str]] = None,
         runner: Runner = subprocess.run,
         wait_fn: Optional[Callable[..., bool]] = None) -> int:
    args = build_parser().parse_args(argv)
    # the trainer runs with cwd=args.workdir, so every path handed to it (the
    # resume checkpoint found under the workdir, the config) must be absolute
    args.workdir = os.path.abspath(args.workdir)
    args.config = os.path.abspath(args.config)
    run = ensure_run(args, runner=runner, wait_fn=wait_fn)
    if run is None:
        print(json.dumps({"status": "failed", "stage": "train"}))
        return 1
    # a resumed run leaves its earlier epochs in older run dirs: score every
    # dir so the draw targets compete across the whole series
    all_runs = runs_with_checkpoints(args.workdir) or [run]
    for rd in all_runs:
        score_run(rd, runner=runner, device=args.device)
    if not os.path.exists(os.path.join(run, "ks_summary.json")):
        print(json.dumps({"status": "failed", "stage": "score", "run": run}))
        return 1
    if not args.skip_draws:
        draw_batteries_at(
            aggregate_top_checkpoints(all_runs, args.top_k),
            args, runner=runner, wait_fn=wait_fn,
        )
        if args.second_draw_seed is not None:
            target = best_checkpoint_overall(all_runs)
            if target is not None:
                draw_batteries_at([target], args, runner=runner,
                                  wait_fn=wait_fn,
                                  seed=args.second_draw_seed,
                                  prefix="draws2_ckpt")
    result = best_combined_p(args.workdir)
    result.update({"status": "ok", "run": run})
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
