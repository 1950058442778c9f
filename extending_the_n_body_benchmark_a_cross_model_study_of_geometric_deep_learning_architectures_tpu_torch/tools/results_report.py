"""Regenerate the multi-model combined-p report from archived evidence:
counterpart of the JAX repo's ``scripts/results_report.py``, writing the
same CSV.

Reads the committed ``docs/results/<run>/ks_summary.json`` archives (the
raw run dirs are transient), so the report is reproducible from the repo
alone.

Usage::

    python -m <package>.tools.results_report [--results-dir docs/results] [--no-plot]

Writes ``combined_pvalues_summary.csv`` and ``combined_pvalues_multi.png``
into the results dir.  Each row aggregates one archived run: its in-run best
checkpoint and the best battery (``draws*.json``).  The figure is
``evaluation.ks_checkpoints._plot_multi_model``'s (``viz/``, numpy only).
Host only.
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import re
import sys

FIELDS = [
    "folder",
    "model",
    "num_checkpoints",
    "best_checkpoint",
    "best_combined_pvalue",
    "first_checkpoint_p_ge_0.05",
    "best_draw_pvalue",
    "best_draw_checkpoint",
    "best_overall_pvalue",
    "superseded_by",
]

_SUPERSEDED_RE = re.compile(r"^superseded-by:\s*(\S+)", re.MULTILINE)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _superseded_by(folder_path: str) -> str:
    """Successor row named by a ``superseded-by:`` marker in the folder's
    README (or a parent grouping folder's README), else ''.  Historical rows
    stay in the CSV for provenance, flagged."""
    for candidate in (folder_path, os.path.dirname(folder_path)):
        readme = os.path.join(candidate, "README.md")
        try:
            with open(readme) as fh:
                m = _SUPERSEDED_RE.search(fh.read())
        except OSError:
            continue
        if m:
            return m.group(1)
    return ""


def _model_from_run_path(run_path: str, folder: str) -> str:
    # an archived run_path looks like .../runs/<model>/<timestamp>__name; take
    # the last "runs" segment: pipeline workdirs nest their own runs/ under a
    # runs/-rooted workdir (runs/gt10m/<cand>/runs/graph_transformer/...)
    parts = os.path.normpath(run_path).split(os.sep)
    if "runs" in parts:
        i = len(parts) - 1 - parts[::-1].index("runs")
        if i + 1 < len(parts):
            return parts[i + 1]
    return folder.split("_")[0]


def _best_draw(folder_path: str):
    """Best battery best-p across draws_ckpt*.json / draws*.json archives."""
    best, ck = float("nan"), None
    for f in sorted(glob.glob(os.path.join(folder_path, "draws*.json"))):
        try:
            with open(f) as fh:
                d = json.load(fh)
        except Exception:
            continue
        p = d.get("best_combined_pvalue")
        if p is None and "draws" in d:
            vals = [x.get("combined_pvalue", float("nan")) for x in d["draws"]]
            vals = [v for v in vals if v == v]
            p = max(vals) if vals else None
        if p is not None and (best != best or p > best):
            best = p
            # the checkpoint id is what follows 'ckpt' (draws2_ckpt870.json
            # is checkpoint 870, not 2870)
            m = re.search(r"ckpt(\d+)", os.path.basename(f))
            ck = int(m.group(1)) if m else None
    return best, ck


def collect(results_dir: str):
    rows, series = [], {}
    # one level for the standard <run> archives, two for grouped ones like
    # gt_10m_chase/<workdir-name>/
    for summary_path in sorted(
        glob.glob(os.path.join(results_dir, "*", "ks_summary.json"))
        + glob.glob(os.path.join(results_dir, "*", "*", "ks_summary.json"))
    ):
        folder_path = os.path.dirname(summary_path)
        folder = os.path.relpath(folder_path, results_dir)
        try:
            with open(summary_path) as fh:
                s = json.load(fh)
        except Exception:
            continue
        model = _model_from_run_path(s.get("run_path", ""), folder)
        draw_p, draw_ck = _best_draw(folder_path)
        in_run = s.get("best_combined_pvalue", float("nan"))
        candidates = [v for v in (in_run, draw_p) if v == v]
        superseded = _superseded_by(folder_path)
        rows.append(
            {
                "folder": folder,
                "model": model,
                "num_checkpoints": s.get("num_checkpoints"),
                "best_checkpoint": s.get("best_checkpoint"),
                "best_combined_pvalue": in_run,
                "first_checkpoint_p_ge_0.05": s.get("first_checkpoint_p_ge_0.05"),
                "best_draw_pvalue": draw_p if draw_p == draw_p else "",
                "best_draw_checkpoint": draw_ck if draw_ck is not None else "",
                "best_overall_pvalue": max(candidates) if candidates else "",
                "superseded_by": superseded,
            }
        )
        # the multi-model figure shows only current rows
        if s.get("results") and not superseded:
            series[f"{model} ({folder})"] = s["results"]
    return rows, series


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--results-dir", default=os.path.join(REPO, "docs", "results"))
    p.add_argument("--no-plot", action="store_true")
    args = p.parse_args(argv)

    rows, series = collect(args.results_dir)
    if not rows:
        print(f"no ks_summary.json archives under {args.results_dir}", file=sys.stderr)
        return 1

    out_csv = os.path.join(args.results_dir, "combined_pvalues_summary.csv")
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=FIELDS)
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {out_csv} ({len(rows)} runs)")

    if not args.no_plot and series:
        from ..evaluation.ks_checkpoints import _plot_multi_model

        out_png = os.path.join(args.results_dir, "combined_pvalues_multi.png")
        _plot_multi_model(series, out_png)
        print(f"wrote {out_png}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
