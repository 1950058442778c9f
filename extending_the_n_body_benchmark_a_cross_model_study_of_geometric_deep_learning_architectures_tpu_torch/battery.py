"""The self-feed battery of the committed N=100 checkpoint, on both scoring
bases, through the ``self-feed`` main.

    python -m extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.battery \\
        [--family egnn_mc|ponita|segnn|equiformer_v2|graph_transformer] [--seeds 281 9272] [--compute-dtypes float32 bfloat16] \\
        [--draws 6] [--batch-size B] [--checkpoint PATH] [--device cuda] [--out DIR]

For each compute dtype it builds a run dir around the checkpoint (by default
the committed ``docs/results/fidelity_n100/egnn_n100_ckpt_30_model.ckpt``;
``train.restore.make_run_dir``) with the study protocol that trained it
(``docs/results/fidelity_n100/README.md`` section 3: EGNN-MC 6 x 128, N=100,
B=16, sim_length 2500, T=250, ``self_feed_limit_steps`` 249; and
``--model.compute_dtype bfloat16`` for the mixed model), then runs
``cli self-feed --draws D --seed S [--batch_size B]`` for each seed.  Nothing
is trained.  ``--family ponita`` scores PONITA instead (by default the
committed ``docs/results/ponita10m_r5_partial/model.ckpt``, L5 h480, in f32)
in a run dir of the queue step that trained it
(``scripts/queues/tpu_queue48.sh:63-64``: the reference workload, N=5,
B=64, T=1000, 999 steps a draw), and ``--family segnn`` scores SEGNN (by
default the committed ``docs/results/segnn10m_r5/ckpt_110_model.ckpt``, L6
w448, in f32) in a run dir of its queue step (``tpu_queue48.sh:55-56``, the
same workload), beside the checkpoint's committed batteries
(``draws_ckpt110.json``, seed 281, and ``draws2_ckpt110.json``, seed 9272:
12 draws each, on the six-macro basis).  ``--family equiformer_v2`` scores
EquiformerV2 (by default the committed
``docs/results/eqv2_10m_L8c128_cont/ckpt_130_model.ckpt``, L8 c128, in f32,
rolled out in training mode with live dropout, as the run's
``self_feed_train_mode`` says) in a run dir of its queue step
(``scripts/queues/tpu_queue44.sh:43-48``, the same workload), beside the
committed ``draws_ckpt130_1.json`` (seed 281) and ``draws2_ckpt130_1.json``
(seed 9272).  ``--family graph_transformer`` scores GraphTransformer (by
default the committed ``docs/results/gt10m_r5/ckpt_130_model.ckpt``, L8
h248, 8 heads, in f32, rolled out in training mode with live dropout) in a
run dir of its queue step (``scripts/queues/tpu_queue48.sh:58-60``, the
same workload), beside the committed ``draws_ckpt130.json`` (seed 281) and
``draws2_ckpt130.json`` (seed 9272).

Each draw is scored on two bases:

* six macros: the ``combined_pvalue`` of ``self_feed_draws.json``, the
  basis both packages score N=100 on today (``metrics.ks.combine_scored``:
  ``stuck_cluster_size`` in place of the NaN-gated group macro; at N=5 the
  group macro itself is scored);
* five macros: a Fisher combine of the same ``per_macro`` over the five
  reference macros, ``stuck_cluster_size`` left out, the basis of the
  committed batteries (``egnn_n100_draws{,2}_ckpt30.json``), which predate
  the sixth.

It prints one line a draw, one a battery (best / median / worst on both
bases, beside the committed battery of the same seed where there is one) and
a last JSON line with everything.  On the card unless ``--device`` says
otherwise.  ``--rescore FILE ...`` runs nothing and scores batteries already
written (either package's ``self_feed_draws.json``) on both bases.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time

from .metrics.ks import SCORED_MACROS, fisher_combine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIDELITY = os.path.join(REPO, "docs", "results", "fidelity_n100")
CKPT = os.path.join(FIDELITY, "egnn_n100_ckpt_30_model.ckpt")
# the committed batteries of the checkpoint, by seed
COMMITTED = {281: os.path.join(FIDELITY, "egnn_n100_draws_ckpt30.json"),
             9272: os.path.join(FIDELITY, "egnn_n100_draws2_ckpt30.json")}
# the committed PONITA checkpoint and the run that trained it
PONITA_CKPT = os.path.join(REPO, "docs", "results", "ponita10m_r5_partial", "model.ckpt")
PONITA_RUN_ARGV = ["--main.model_type", "ponita", "--model.num_layers", "5",
                   "--model.hidden_features", "480"]
# the committed SEGNN checkpoint, the run that trained it and its batteries
SEGNN_DIR = os.path.join(REPO, "docs", "results", "segnn10m_r5")
SEGNN_CKPT = os.path.join(SEGNN_DIR, "ckpt_110_model.ckpt")
SEGNN_RUN_ARGV = ["--main.model_type", "segnn", "--model.num_layers", "6",
                  "--model.hidden_features", "448"]
SEGNN_COMMITTED = {281: os.path.join(SEGNN_DIR, "draws_ckpt110.json"),
                   9272: os.path.join(SEGNN_DIR, "draws2_ckpt110.json")}
# the committed EquiformerV2 checkpoint, the run that trained it and its batteries
EQV2_DIR = os.path.join(REPO, "docs", "results", "eqv2_10m_L8c128_cont")
EQV2_CKPT = os.path.join(EQV2_DIR, "ckpt_130_model.ckpt")
EQV2_RUN_ARGV = ["--main.model_type", "equiformer_v2", "--model.num_layers", "8",
                 "--model.sphere_channels", "128", "--model.attn_hidden_channels", "128",
                 "--model.ffn_hidden_channels", "128", "--model.num_heads", "8",
                 "--model.remat", "true"]
EQV2_COMMITTED = {281: os.path.join(EQV2_DIR, "draws_ckpt130_1.json"),
                  9272: os.path.join(EQV2_DIR, "draws2_ckpt130_1.json")}
# the committed GraphTransformer checkpoint, the run that trained it and its batteries
GT_DIR = os.path.join(REPO, "docs", "results", "gt10m_r5")
GT_CKPT = os.path.join(GT_DIR, "ckpt_130_model.ckpt")
GT_RUN_ARGV = ["--main.model_type", "graph_transformer", "--model.num_layers", "8",
               "--model.hidden_features", "248", "--model.num_heads", "8"]
GT_COMMITTED = {281: os.path.join(GT_DIR, "draws_ckpt130.json"),
                9272: os.path.join(GT_DIR, "draws2_ckpt130.json")}
# the study protocol that trained the checkpoint (README section 3)
STUDY_RUN_ARGV = ["--dataloader.batch_size", "16",
                  "--dataloader.gravity_dataset.num_atoms", "100",
                  "--dataloader.gravity_dataset.sim_length", "2500",
                  "--trainer.self_feed_limit_steps", "249"]


def five_macro_p(per: dict) -> float:
    """Fisher over the five reference macros of a ``per_macro`` dict (its
    NaN-gated group macro dropped, ``stuck_cluster_size`` left out): the basis
    of the batteries committed before the sixth macro."""
    return fisher_combine([per.get(k, float("nan")) for k in SCORED_MACROS])


def _six(draw) -> float:
    """A draw's six-macro p: its combined p where the six were scored (the
    group macro itself, or ``stuck_cluster_size`` in its place above the
    group macro's N gate), NaN for a draw scored before the sixth existed."""
    per = draw["per_macro"]
    group = per.get("group_collision_count", float("nan"))
    scored = "stuck_cluster_size" in per or group == group
    return draw["combined_pvalue"] if scored else float("nan")


def bases(draws) -> dict:
    """``{"six": [...], "five": [...], "survived": [...]}`` of a battery's
    draws; six is NaN for a draw scored before the sixth macro existed."""
    return {"six": [_six(d) for d in draws],
            "five": [five_macro_p(d["per_macro"]) for d in draws],
            "survived": [d["steps_survived"] for d in draws]}


def spread(ps) -> dict:
    """Best, median and worst of finite p-values (NaN where there are none)."""
    ok = sorted(p for p in ps if p == p)
    nan = float("nan")
    return {"best": ok[-1] if ok else nan, "median": statistics.median(ok) if ok else nan,
            "worst": ok[0] if ok else nan}


def committed(seed: int, batteries=None):
    """The committed battery of ``seed`` among ``batteries`` (by default the
    N=100 checkpoint's) on both bases (six is NaN for the batteries scored
    before the sixth macro) and each draw's survived, or None."""
    path = (COMMITTED if batteries is None else batteries).get(seed)
    if path is None or not os.path.exists(path):
        return None
    with open(path) as f:
        b = bases(json.load(f)["draws"])
    return {"six": b["six"], "five": b["five"], "survived": b["survived"]}


def make_study_run_dir(run_dir: str, compute_dtype: str = "float32", checkpoint: str = CKPT) -> str:
    """A run dir of the study protocol around ``checkpoint`` (the committed
    one by default)."""
    from .train.restore import make_run_dir

    argv = list(STUDY_RUN_ARGV)
    if compute_dtype != "float32":
        argv += ["--model.compute_dtype", compute_dtype]
    return make_run_dir(run_dir, argv, checkpoint)


def _fmt(s: dict) -> str:
    return " ".join(f"{k}={v:.3e}" for k, v in s.items())


def run_battery(run_dir: str, seed: int, draws: int, device: str, out: str,
                batch_size=None, batteries=None) -> dict:
    """``cli self-feed`` on ``run_dir``; the battery on both bases, beside
    the committed battery of ``seed`` among ``batteries``."""
    from .cli import self_feed_main

    t0 = time.perf_counter()
    argv = ["--run_dir", run_dir, "--draws", str(draws), "--seed", str(seed), "--out", out,
            "--device", device]
    summary = self_feed_main(argv + (["--batch_size", str(batch_size)] if batch_size else []))
    seconds = time.perf_counter() - t0
    b = bases(summary["draws"])
    return {"seed": seed, "draws": draws, "seconds": seconds, **b,
            "six_spread": spread(b["six"]), "five_spread": spread(b["five"]),
            "committed": committed(seed, batteries)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--family", default="egnn_mc",
                   choices=["egnn_mc", "ponita", "segnn", "equiformer_v2", "graph_transformer"])
    p.add_argument("--seeds", type=int, nargs="+", default=[281, 9272])
    p.add_argument("--compute-dtypes", nargs="+", default=["float32", "bfloat16"],
                   choices=["float32", "bfloat16"])
    p.add_argument("--draws", type=int, default=6)
    p.add_argument("--batch-size", type=int, default=None,
                   help="sims a draw (default: the protocol's 16)")
    p.add_argument("--checkpoint", default=None,
                   help="the checkpoint to score (default: the family's committed one; the "
                   "N=100 one's committed batteries are printed beside)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None, help="where the run dirs go (default: a temporary "
                   "directory, removed at the end)")
    p.add_argument("--rescore", nargs="+", default=None, metavar="JSON",
                   help="score these self_feed_draws.json files on both bases, and run nothing")
    args = p.parse_args(argv)
    # the families at the reference workload: (checkpoint, run argv, committed batteries)
    queued = {"ponita": (PONITA_CKPT, PONITA_RUN_ARGV, {}),
              "segnn": (SEGNN_CKPT, SEGNN_RUN_ARGV, SEGNN_COMMITTED),
              "equiformer_v2": (EQV2_CKPT, EQV2_RUN_ARGV, EQV2_COMMITTED),
              "graph_transformer": (GT_CKPT, GT_RUN_ARGV, GT_COMMITTED)}.get(args.family)
    default_ckpt = queued[0] if queued else CKPT
    if args.checkpoint is None:
        args.checkpoint = default_ckpt
    if queued:
        args.compute_dtypes = ["float32"]  # none has a mixed-precision form

    if args.rescore:
        results = []
        for path in args.rescore:
            with open(path) as f:
                b = bases(json.load(f)["draws"])
            for i, (surv, six, five) in enumerate(zip(b["survived"], b["six"], b["five"])):
                print(f"  {path} draw {i}: survived={surv} six-macro p={six:.3e} "
                      f"five-macro p={five:.3e}", flush=True)
            print(f"[rescore {path}] six-macro {_fmt(spread(b['six']))}; five-macro "
                  f"{_fmt(spread(b['five']))}", flush=True)
            results.append({"file": path, **b})
        print(json.dumps({"rescore": results}), flush=True)
        return results

    results = []
    with tempfile.TemporaryDirectory() as tmp:
        root = args.out or tmp
        for dtype in args.compute_dtypes:
            if queued:
                from .train.restore import make_run_dir

                run_dir = make_run_dir(os.path.join(root, f"{args.family}10m"), queued[1],
                                       args.checkpoint)
            else:
                run_dir = make_study_run_dir(os.path.join(root, f"egnn_n100_{dtype}"), dtype,
                                             args.checkpoint)
            for seed in args.seeds:
                r = run_battery(run_dir, seed, args.draws, args.device,
                                os.path.join(run_dir, f"battery_seed{seed}"), args.batch_size,
                                queued[2] if queued else None)
                protocol_b = 64 if queued else 16
                r.update(family=args.family, compute_dtype=dtype, checkpoint=args.checkpoint,
                         batch_size=args.batch_size or protocol_b)
                if (os.path.abspath(args.checkpoint) != os.path.abspath(default_ckpt)
                        or r["batch_size"] != protocol_b):
                    r["committed"] = None  # the committed batteries scored another run
                for i, (surv, six, five) in enumerate(zip(r["survived"], r["six"], r["five"])):
                    print(f"  {dtype} seed {seed} draw {i}: survived={surv} six-macro p={six:.3e} "
                          f"five-macro p={five:.3e}", flush=True)
                line = (f"[battery {dtype} seed {seed}] {r['seconds']:.2f} s; six-macro "
                        f"{_fmt(r['six_spread'])}; five-macro {_fmt(r['five_spread'])}")
                if r["committed"]:
                    line += (f"; committed six-macro {_fmt(spread(r['committed']['six']))}, "
                             f"five-macro {_fmt(spread(r['committed']['five']))}, "
                             f"survived {r['committed']['survived']}")
                print(line, flush=True)
                results.append(r)
    print(json.dumps({"battery": results}), flush=True)
    return results


if __name__ == "__main__":
    main()
