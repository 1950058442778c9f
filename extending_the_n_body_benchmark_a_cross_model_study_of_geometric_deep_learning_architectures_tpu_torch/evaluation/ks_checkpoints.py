"""Checkpoint KS ranking: counterpart of the JAX package's
``evaluation/ks_checkpoints.py``.

Walks ``<run>/checkpoints/<int>/`` (run dirs of either package), recomputes
each checkpoint's per-macro KS p-values from its macro JSONs (GT against
predicted), Fisher-combines them, optionally draws the GT-vs-GT floor, and
reports the best checkpoint: ``ks_results.csv``, ``ks_results.png`` (the
p-values against checkpoint) and ``ks_summary.json`` in the run dir.
:func:`combined_pvalues_report` aggregates several runs into one summary CSV
and an overlay of their curves (``<csv>_multi.png``), :func:`time_cutoff_report`
the checkpoint each run reached within a wall-clock budget.  The figures come
from ``viz/macro_plots.py`` (numpy only).

    python -m <package>.cli ks-test RUN [RUN ...] [--baseline] [--multi-out CSV] [--hours H]
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, Optional, Tuple

from ..metrics import artifacts
from ..metrics import macros as M
from ..metrics.ks import SCORED_MACROS, fisher_combine, ks_p, macro_ks_pvalues

ENERGY_KEYS = ["energy_total", "energy_potential", "energy_kinetic"]


def load_checkpoint_pvalues(
    ckpt_dir: str, include_energy: bool = True
) -> Tuple[Dict[str, float], float]:
    """Per-macro (and energy) p-values of one checkpoint dir and their Fisher
    combination.

    ``include_energy=True`` is the HPO objective's basis: any energy p > 0
    joins the combine, so an energy series whose p underflows to an exact 0.0
    is left out while a clamped 1e-300 is kept.  ``include_energy=False`` is the
    published scoreboard's: the macro files only.  ``stuck_cluster_size`` is
    combined in place of ``group_collision_count`` when the latter is NaN (the
    N gate of ``metrics.ks``), and recorded only otherwise.  The energy
    p-values are reported in ``per`` either way."""
    per: Dict[str, float] = {}
    pvals: List[float] = []
    data = artifacts.read_macro_jsons(ckpt_dir)
    for key in SCORED_MACROS:
        if key not in data:
            per[key] = float("nan")
            continue
        p = ks_p(data[key]["ground truth"], data[key]["predicted"])
        per[key] = p
        if p == p and p > 0.0:
            pvals.append(p)
    if "stuck_cluster_size" in data:
        p_ext = ks_p(data["stuck_cluster_size"]["ground truth"],
                     data["stuck_cluster_size"]["predicted"])
        per["stuck_cluster_size"] = p_ext
        group = per.get("group_collision_count", float("nan"))
        if group != group and p_ext == p_ext and p_ext > 0.0:
            pvals.append(p_ext)
    energy_path = os.path.join(ckpt_dir, "nbody_macro_metrics.json")
    if os.path.exists(energy_path):
        try:
            with open(energy_path) as f:
                m = json.load(f)
            for key in ENERGY_KEYS:
                p = float(m.get("ks_pvalues", {}).get(key, float("nan")))
                per[key] = p
                if include_energy and p == p and p > 0.0:
                    pvals.append(p)
        except Exception:  # an unreadable energy record scores the macros alone
            pass
    return per, fisher_combine(pvals)


def gt_baseline_pvalues(
    dataset, n_pairs: int = 5, batch_size: Optional[int] = None
) -> List[float]:
    """GT-vs-GT combined p-values, the macro noise floor: each compares the
    macros of two independent fresh batches."""
    out = []
    for _ in range(n_pairs):
        loc1, vel1, *_ = dataset.get_ground_truth_trajectories(batch_size)
        loc2, vel2, *_ = dataset.get_ground_truth_trajectories(batch_size)
        g1 = M.compute_all_macros(artifacts.host(loc1), artifacts.host(vel1))
        g2 = M.compute_all_macros(artifacts.host(loc2), artifacts.host(vel2))
        out.append(macro_ks_pvalues(g1, g2)[1])
    return out


def evaluate_run_checkpoints(
    run_path: str,
    baseline_dataset=None,
    plot: bool = True,
) -> Dict:
    """Rank every checkpoint of a run dir on the published basis (macros
    only); write ``ks_results.csv``, ``ks_summary.json`` and with ``plot``
    ``ks_results.png``: the combined p and each metric's p against checkpoint
    (a metric a checkpoint lacks is NaN there)."""
    ckpt_root = os.path.join(run_path, "checkpoints")
    if not os.path.isdir(ckpt_root):
        raise FileNotFoundError(f"no checkpoints/ under {run_path}")
    steps = sorted((d for d in os.listdir(ckpt_root) if d.isdigit()), key=int)

    rows = []
    for step in steps:
        per, combined = load_checkpoint_pvalues(
            os.path.join(ckpt_root, step), include_energy=False
        )
        rows.append({"checkpoint": int(step), "combined_pvalue": combined, **per})

    # every metric any checkpoint has: a checkpoint dir may lack some artifacts
    # (a run killed mid-evaluation), and its CSV cells stay empty
    all_keys = sorted({k for r in rows for k in r if k not in ("checkpoint", "combined_pvalue")})

    valid = [r for r in rows if r["combined_pvalue"] == r["combined_pvalue"]]
    best = max(valid, key=lambda r: r["combined_pvalue"]) if valid else None
    first_sig = next(
        (r["checkpoint"] for r in valid if r["combined_pvalue"] >= 0.05), None
    )
    baseline = gt_baseline_pvalues(baseline_dataset) if baseline_dataset is not None else None

    if rows:
        with open(os.path.join(run_path, "ks_results.csv"), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["checkpoint", "combined_pvalue", *all_keys],
                               restval="")
            w.writeheader()
            w.writerows(rows)
    if plot and rows:
        from ..viz.macro_plots import plot_pvalue_series

        plot_pvalue_series(run_path, [r["checkpoint"] for r in rows],
                           [r["combined_pvalue"] for r in rows],
                           per_metric={k: [r.get(k, float("nan")) for r in rows]
                                       for k in all_keys},
                           filename="ks_results.png")

    summary = {
        "run_path": run_path,
        "num_checkpoints": len(rows),
        "best_checkpoint": best["checkpoint"] if best else None,
        "best_combined_pvalue": best["combined_pvalue"] if best else None,
        "first_checkpoint_p_ge_0.05": first_sig,
        "gt_baseline_pvalues": baseline,
        "results": rows,
    }
    with open(os.path.join(run_path, "ks_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def combined_pvalues_report(
    run_paths: List[str], out_csv: str, plot: bool = True
) -> List[Dict]:
    """Each run's best checkpoint, its combined p and its first checkpoint with
    p >= 0.05, as a summary CSV (runs without ``checkpoints/`` are skipped);
    with ``plot`` the runs' combined-p curves overlaid in ``<csv>_multi.png``,
    each labelled ``model (run)``."""
    rows = []
    series = {}
    for rp in run_paths:
        try:
            s = evaluate_run_checkpoints(rp, plot=False)
        except FileNotFoundError:
            continue
        model = os.path.basename(os.path.dirname(os.path.normpath(rp)))
        series[f"{model} ({os.path.basename(os.path.normpath(rp))})"] = s["results"]
        rows.append({
            "model": model,
            "run": rp,
            "best_checkpoint": s["best_checkpoint"],
            "best_combined_pvalue": s["best_combined_pvalue"],
            "first_checkpoint_p_ge_0.05": s["first_checkpoint_p_ge_0.05"],
        })
    if plot and series:
        _plot_multi_model(series, os.path.splitext(out_csv)[0] + "_multi.png")
    os.makedirs(os.path.dirname(os.path.abspath(out_csv)), exist_ok=True)
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["model", "run", "best_checkpoint",
                                          "best_combined_pvalue", "first_checkpoint_p_ge_0.05"])
        w.writeheader()
        w.writerows(rows)
    return rows


def _plot_multi_model(series: Dict[str, List[Dict]], out_png: str) -> None:
    """Overlaid combined-p curves, one per run, log y."""
    from ..viz import raster
    from ..viz.macro_plots import multi_model_figure

    os.makedirs(os.path.dirname(os.path.abspath(out_png)), exist_ok=True)
    raster.save(multi_model_figure(series, os.path.basename(out_png)), out_png)


def time_cutoff_report(
    run_paths: List[str], hours: float = 8.0, out_json: Optional[str] = None
) -> Dict[str, int]:
    """The last checkpoint each run reached within ``hours`` of its first
    logged record (the ``_time`` stamps of its ``metrics.jsonl``); a run with
    no stamped record is skipped."""
    out: Dict[str, int] = {}
    for rp in run_paths:
        path = os.path.join(rp, "metrics.jsonl")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            records = [json.loads(line) for line in f if line.strip()]
        times = [r["_time"] for r in records if "_time" in r]
        if not times:
            continue
        t0 = min(times)
        best = 0
        for r in records:
            if "self_feed/step" in r and r["_time"] - t0 <= hours * 3600:
                best = max(best, int(r["self_feed/step"]) + 1)
        out[rp] = best
    if out_json:
        with open(out_json, "w") as f:
            json.dump({"hours": hours, "max_checkpoint": out}, f, indent=2)
    return out


def main(argv=None):
    import argparse

    from ..data.gravity_otf import GravityDatasetOtf
    from ..train.restore import find_dataset_metadata

    p = argparse.ArgumentParser(description="KS-rank a run's checkpoints")
    p.add_argument("run_path", nargs="+")
    p.add_argument("--baseline", action="store_true", help="compute GT-GT floor")
    p.add_argument("--multi-out", default=None,
                   help="aggregate several runs into this summary csv")
    p.add_argument("--hours", type=float, default=None,
                   help="also report max checkpoint within this wall-clock budget")
    p.add_argument("--device", default="cuda", help="where --baseline draws its GT")
    args = p.parse_args(argv)

    if len(args.run_path) > 1 or args.multi_out:
        out_csv = args.multi_out or "combined_pvalues_summary.csv"
        rows = combined_pvalues_report(args.run_path, out_csv)
        for r in rows:
            bp = r["best_combined_pvalue"]
            ptxt = f"{bp:.3g}" if bp is not None else "n/a (no scored checkpoints)"
            print(f"{r['model']}: best ckpt {r['best_checkpoint']} p={ptxt} "
                  f"first p>=0.05: {r['first_checkpoint_p_ge_0.05']}")
        if args.hours:
            for rp, ck in time_cutoff_report(args.run_path, hours=args.hours).items():
                print(f"{rp}: max checkpoint in {args.hours}h = {ck}")
        print(f"summary csv: {out_csv}")
        return rows

    run_path = args.run_path[0]
    ds = None
    if args.baseline:
        meta = find_dataset_metadata(run_path)
        if meta is not None:
            ds = GravityDatasetOtf.from_metadata(meta, cache_data=False, device=args.device)
    s = evaluate_run_checkpoints(run_path, baseline_dataset=ds)
    print(f"best checkpoint: {s['best_checkpoint']} (combined p = {s['best_combined_pvalue']})")
    if args.hours:
        for rp, ck in time_cutoff_report([run_path], hours=args.hours).items():
            print(f"{rp}: max checkpoint in {args.hours}h = {ck}")
    return s


if __name__ == "__main__":
    main()
