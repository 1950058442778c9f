"""Archive a pipeline workdir into a ``docs/results/`` row: counterpart of
the JAX repo's ``scripts/archive_row.py``, writing the same tree.

The workdir (ignored ``runs/``) holds the evidence a scoreboard row needs:
per-checkpoint KS series (``ks_summary.json``, from ``cli ks-test``) and the
self-feed batteries (``draws_ckpt*/self_feed_draws.json``).  This flattens
them into ``docs/results/<row>/`` in the layout of the hand-archived rows:
one ``ks_summary.json`` per source run dir (suffixed when a workdir has
several), ``draws_ckptNN.json`` / ``draws2_ckptNN.json`` battery summaries,
``ks_results.csv``/``.png`` where the scorer wrote them, the headline
checkpoint's ``model.ckpt``, and a provenance README with the headline
numbers.  The port's checkpoints are in the JAX layout, so a row archived
from a port workdir stands beside the JAX rows.  Host only.

Usage::

    python -m <package>.tools.archive_row --workdir runs/r2/egnn_hpo_winner \\
        --dest egnn_hpo_winner [--note "..."]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def collect(workdir: str):
    """(run_dir, files) pairs worth archiving, oldest run first."""
    out = []
    run_dirs = sorted(
        (r for r in glob.glob(os.path.join(workdir, "runs", "*", "*"))
         if os.path.isdir(r)),
        key=os.path.basename,
    )
    for rd in run_dirs:
        files = []
        for name in ("ks_summary.json", "ks_results.csv", "ks_results.png"):
            p = os.path.join(rd, name)
            if os.path.exists(p):
                files.append((p, name))
        for f in sorted(glob.glob(os.path.join(rd, "draws*", "self_feed_draws.json"))):
            files.append((f, os.path.basename(os.path.dirname(f)) + ".json"))
        if files:
            out.append((rd, files))
    return out


def headline(dest: str):
    """(best in-run p/ckpt/file, best battery p/file) across archived files.
    Each tuple carries the archived file the headline came from, so the
    checkpoint-keeping step can resolve it back to its source run dir
    (checkpoint numbers repeat across run dirs)."""
    best_run = (-1.0, None, None)
    best_draw = (-1.0, None)
    # a malformed or partial file (no 'checkpoint', a non-dict root, a
    # non-numeric p) is skipped, not a crash after the copies landed
    for f in glob.glob(os.path.join(dest, "ks_summary*.json")):
        try:
            with open(f) as fh:
                for rec in json.load(fh).get("results", []):
                    p = rec.get("combined_pvalue", 0.0)
                    if p > best_run[0]:
                        best_run = (p, str(rec.get("checkpoint", "?")),
                                    os.path.basename(f))
        except (OSError, ValueError, KeyError, AttributeError, TypeError):
            continue
    for f in glob.glob(os.path.join(dest, "draws*ckpt*.json")):
        try:
            with open(f) as fh:
                p = json.load(fh).get("best_combined_pvalue", 0.0)
        except (OSError, ValueError, KeyError, AttributeError, TypeError):
            continue
        if p > best_draw[0]:
            best_draw = (p, os.path.basename(f))
    return best_run, best_draw


def _keep_headline_ckpt(pairs, dest: str, run_ck, draw_f,
                        src_map=None, run_f=None) -> str | None:
    """Copy the headline checkpoint's parameters into the archive, so the row
    can be drawn again from git alone when ``runs/`` is gone.

    Checkpoint numbers repeat across a workdir's run dirs (continuations
    count on from their resume epoch), so the parameters come from the run
    dir that produced the headline file (``src_map``: archived file name ->
    source run dir).  Other run dirs are only a fallback, with a warning,
    when the headline's own dir lost its checkpoint."""
    ck = None
    headline_file = None
    if draw_f:  # draws_ckptNN.json / draws2_ckptNN.json -> NN
        m = re.search(r"ckpt(\d+)", draw_f)
        ck = m.group(1) if m else None
        headline_file = draw_f
    if ck is None:
        ck = run_ck
        headline_file = run_f
    if ck is None:
        return None
    candidates = [rd for rd, _files in reversed(pairs)]  # newest first
    preferred = (src_map or {}).get(headline_file)
    if preferred in candidates:
        candidates.remove(preferred)
        candidates.insert(0, preferred)
    for rd in candidates:
        src = os.path.join(rd, "checkpoints", str(ck), "model.ckpt")
        if os.path.exists(src):
            if preferred is not None and rd != preferred:
                print(f"archive_row: WARNING headline run dir {preferred} "
                      f"has no checkpoint {ck}; keeping params from {rd} "
                      "(may be a different trajectory)", file=sys.stderr)
            out = os.path.join(dest, f"ckpt_{ck}_model.ckpt")
            shutil.copy2(src, out)
            return out
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--dest", required=True,
                    help="row name under docs/results/")
    ap.add_argument("--results-dir",
                    default=os.path.join(REPO, "docs", "results"))
    ap.add_argument("--note", default="")
    ap.add_argument("--no-keep-ckpt", action="store_true",
                    help="skip archiving the headline checkpoint params")
    args = ap.parse_args(argv)

    pairs = collect(args.workdir)
    if not pairs:
        print(f"archive_row: nothing to archive under {args.workdir}",
              file=sys.stderr)
        return 1
    dest = os.path.join(args.results_dir, args.dest)
    os.makedirs(dest, exist_ok=True)
    # archiving again after the workdir grew (1 -> N run dirs) must not leave
    # the old unsuffixed copies beside the new suffixed ones
    for pat in ("ks_summary*.json", "ks_results*", "draws*ckpt*.json"):
        for old in glob.glob(os.path.join(dest, pat)):
            os.remove(old)
    sources = []
    src_map = {}  # archived file name -> source run dir
    for i, (rd, files) in enumerate(pairs):
        suffix = "" if len(pairs) == 1 else f"_{i}"
        for src, name in files:
            base, ext = os.path.splitext(name)
            archived = f"{base}{suffix}{ext}"
            shutil.copy2(src, os.path.join(dest, archived))
            src_map[archived] = rd
        sources.append(os.path.relpath(rd, args.workdir))

    (run_p, run_ck, run_f), (draw_p, draw_f) = headline(dest)
    kept = None
    if not args.no_keep_ckpt:
        kept = _keep_headline_ckpt(pairs, dest, run_ck, draw_f,
                                   src_map=src_map, run_f=run_f)
    # the README's text is the JAX script's, byte for byte: rows archived by
    # either package read alike
    with open(os.path.join(dest, "README.md"), "w") as fh:
        fh.write(f"# {args.dest}\n\n")
        if args.note:
            fh.write(args.note.rstrip() + "\n\n")
        fh.write(f"Archived from `{args.workdir}` "
                 f"(run dirs: {', '.join(sources)}).\n\n")
        if run_ck is not None:
            fh.write(f"- best in-run combined KS p: **{run_p:.4g}** "
                     f"@ ckpt {run_ck}\n")
        if draw_f is not None:
            fh.write(f"- best battery draw: **{draw_p:.4g}** ({draw_f})\n")
        if kept is not None:
            fh.write(f"- headline checkpoint params kept: "
                     f"`{os.path.basename(kept)}` (re-batteryable via "
                     f"`self_feed.py --draws`)\n")
    print(json.dumps({
        "dest": dest, "sources": sources,
        "best_in_run_p": run_p, "best_in_run_ckpt": run_ck,
        "best_battery_p": draw_p, "best_battery_file": draw_f,
        "kept_ckpt": kept,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
