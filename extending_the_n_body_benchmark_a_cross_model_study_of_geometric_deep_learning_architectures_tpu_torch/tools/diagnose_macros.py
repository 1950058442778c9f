"""Per-macro KS diagnosis for a run (or draws file): which macro binds?
Counterpart of the JAX repo's ``scripts/diagnose_macros.py``; prints the
same table.

The Fisher combine (``metrics/ks.py``) is dominated by its smallest
p-value, so a floored combined p almost always traces to one macro
distribution the model cannot match.  This tool gathers every scored record
it finds for a run, the in-run ``ks_summary.json`` series and any
``draws*/self_feed_draws.json`` batteries, and prints, per macro: median and
best p, how often that macro is the minimum of its record (the "binding"
count), and a verdict line.  Host only.

Usage:
  python -m <package>.tools.diagnose_macros <run_dir | draws.json> [more paths...]
  python -m <package>.tools.diagnose_macros --top 5 /tmp/gt_10m_deep/runs/*/*
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import sys

_EXCLUDED = ("energy_",)  # energy terms are diagnostics, not in the combine


def _records_from_path(path: str):
    """Yield (label, combined_p, {macro: p}) from a run dir or JSON file."""
    if os.path.isfile(path):
        yield from _records_from_json(path)
        return
    ks = os.path.join(path, "ks_summary.json")
    if os.path.isfile(ks):
        yield from _records_from_json(ks)
    for f in sorted(glob.glob(os.path.join(path, "draws*", "self_feed_draws.json"))):
        yield from _records_from_json(f)


def _macro_items(rec: dict):
    src = rec.get("per_macro") or rec
    return {
        k: v
        for k, v in src.items()
        if isinstance(v, (int, float))
        and not any(k.startswith(p) for p in _EXCLUDED)
        and k not in ("combined_pvalue", "checkpoint", "draw", "steps_survived")
    }


def _records_from_json(f: str):
    try:
        with open(f) as fh:
            d = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        print(f"warn: skipping {f}: {e}", file=sys.stderr)
        return
    base = os.path.basename(os.path.dirname(f)) or f
    if "results" in d:  # ks_summary.json: in-run checkpoint series
        for r in d["results"]:
            yield (f"{base}:ckpt{r.get('checkpoint')}", r.get("combined_pvalue"), _macro_items(r))
    elif "draws" in d:  # self_feed_draws.json: a draw battery
        for r in d["draws"]:
            yield (f"{base}:draw{r.get('draw')}", r.get("combined_pvalue"), _macro_items(r))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="+", help="run dirs and/or ks/draws JSON files")
    ap.add_argument("--top", type=int, default=3, help="best records to list")
    args = ap.parse_args(argv)

    records = []
    for p in args.paths:
        records.extend(_records_from_path(p))
    records = [r for r in records if r[1] is not None and r[2]]
    if not records:
        print("no scored records found", file=sys.stderr)
        return 1

    records.sort(key=lambda r: -r[1])
    print(f"{len(records)} scored records (checkpoints + draws)\n")
    print(f"top {min(args.top, len(records))} by combined p:")
    for label, cp, _ in records[: args.top]:
        print(f"  {cp:11.3e}  {label}")

    macros = sorted({k for _, _, m in records for k in m})
    stats = {}
    for k in macros:
        vals = [m[k] for _, _, m in records if k in m]
        binding = sum(1 for _, _, m in records if m and min(m, key=m.get) == k)
        stats[k] = (statistics.median(vals), max(vals), binding)

    print("\nper-macro (sorted by median p — lowest = the constraint):")
    print(f"  {'macro':<26} {'median p':>10} {'best p':>10} {'binding':>8}")
    for k in sorted(macros, key=lambda k: stats[k][0]):
        med, best, binding = stats[k]
        print(f"  {k:<26} {med:>10.2e} {best:>10.2e} {binding:>5}/{len(records)}")

    worst = min(macros, key=lambda k: stats[k][0])
    med, best, binding = stats[worst]
    print(
        f"\nverdict: '{worst}' binds ({binding}/{len(records)} records, median "
        f"{med:.2e})" + ("" if best < 0.05 else f" — but its best draw reaches {best:.2f}, so it's lottery-recoverable")
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
