"""Visualization CLI: counterpart of the JAX package's ``viz/cli.py``.  Loads
the per-sim trajectory ``.npy`` dumps of a rollout (``loc_{actual,pred}_sim_i.npy``
and ``vel_...``, as ``metrics.artifacts.save_trajectories`` writes them) and
writes the macro JSONs, the histogram and trajectory figures and, on request,
the extended artifacts, the HTML animation and the mp4/GIF.

Usage::

    python -m <package>.viz.cli --folder runs/<...>/checkpoints/10/trajectories_data
    python -m <package>.viz.cli --folder ... --animate --html --extended
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def load_trajectories(folder: str):
    n = len(glob.glob(os.path.join(folder, "loc_pred_sim_*.npy")))
    if n == 0:
        raise FileNotFoundError(f"no loc_pred_sim_*.npy under {folder}")

    def stack(prefix):
        return np.stack(
            [np.load(os.path.join(folder, f"{prefix}_sim_{i}.npy")) for i in range(n)]
        )

    return (
        stack("loc_actual"),
        stack("vel_actual"),
        stack("loc_pred"),
        stack("vel_pred"),
    )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--folder", required=True, help="trajectories_data dir")
    p.add_argument("--out", default=None, help="output dir (default: sibling plots/)")
    p.add_argument("--animate", action="store_true", help="write mp4/GIF of sim 0")
    p.add_argument("--html", action="store_true", help="write interactive HTML")
    p.add_argument("--extended", action="store_true", help="feature/energy JSONs too")
    args = p.parse_args(argv)

    from ..metrics import artifacts
    from . import trajectories as T

    loc_a, vel_a, loc_p, vel_p = load_trajectories(args.folder)
    out = args.out or os.path.join(os.path.dirname(os.path.normpath(args.folder)), "plots")
    per, combined, _, _ = artifacts.evaluate_rollout(
        out, loc_a, vel_a, loc_p, vel_p,
        save_trajectory_npys=False, plot=True, extended=args.extended,
    )
    T.plot_trajectories_3d(out, loc_a, title="ground truth sim 0",
                           filename="trajectory_3d_actual.png")
    T.plot_trajectories_3d(out, loc_p, title="predicted sim 0",
                           filename="trajectory_3d_pred.png")
    if args.html:
        T.interactive_trajectory_html(out, loc_a, loc_p)
    if args.animate:
        T.animate_trajectory(out, loc_p)

    print(f"combined macro p: {combined:.4g}")
    for k, v in per.items():
        print(f"  ks p [{k}]: {v:.4g}")
    print(f"plots written to {out}")


if __name__ == "__main__":
    main()
