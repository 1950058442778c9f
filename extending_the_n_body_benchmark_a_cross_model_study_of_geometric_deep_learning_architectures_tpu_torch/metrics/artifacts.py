"""Checkpoint evaluation artifacts: counterpart of the JAX package's
``metrics/artifacts.py``, with its file names and JSON schema.

Writes the six macro JSON files the KS tooling reads, the compact
``nbody_macro_metrics.json`` energy record and the per-sim trajectory
``.npy`` dumps, so a port run dir reads like a JAX one.  Schema per macro
file::

    {"ground truth": {"timestamp": ..., "<field>": [...]},
     "predicted":    {"timestamp": ..., "<field>": [...]}}

Trajectories may be tensors (on any device) or arrays, copied to the host.
``plot=True`` draws the macro histograms and the projected trajectories
(``viz/macro_plots.py``, numpy only), and keeps the JAX package's rule that a
plotting error never fails an evaluation: it is printed and the scoring goes
on.
"""

from __future__ import annotations

import json
import os
import traceback
from datetime import datetime
from typing import Dict, Optional

import numpy as np
from .. import _tf32  # noqa: F401  (TF32 off before torch is used)
import torch

from . import ks as KS
from . import macros as M

# file name -> field key
MACRO_FILES = {
    "sticking_distributions.json": "sticking_histogram",
    "collision_distributions.json": "collision_histogram",
    "leaving_distribution.json": "leaving_count",
    "sharp_turn_30_distribution.json": "sharp_turn_count_30",
    "sharp_turn_45_distribution.json": "sharp_turn_count_45",
    "max_com_distance_distribution.json": "com_movement",
    "group_collision_distribution.json": "group_collision_count",
    # the large-N extension, scored in place of the gated group macro (metrics/ks.py)
    "stuck_cluster_distribution.json": "stuck_cluster_size",
}

TITLE_SUFFIXES = ("ground truth", "predicted")


def host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def write_macro_jsons(
    save_dir: str,
    gt_macros: Dict[str, np.ndarray],
    pred_macros: Dict[str, np.ndarray],
    timestamp: Optional[str] = None,
) -> None:
    os.makedirs(save_dir, exist_ok=True)
    ts = timestamp or datetime.now().isoformat()
    for fname, field in MACRO_FILES.items():
        if field not in gt_macros or field not in pred_macros:
            continue  # optional extension macros may be absent
        data = {
            "ground truth": {"timestamp": ts, field: np.asarray(gt_macros[field]).tolist()},
            "predicted": {"timestamp": ts, field: np.asarray(pred_macros[field]).tolist()},
        }
        with open(os.path.join(save_dir, fname), "w") as f:
            json.dump(data, f, indent=4)


def read_macro_jsons(ckpt_dir: str) -> Dict[str, Dict[str, np.ndarray]]:
    """The macro JSONs as ``{field: {'ground truth': arr, 'predicted': arr}}``."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for fname, field in MACRO_FILES.items():
        path = os.path.join(ckpt_dir, fname)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            data = json.load(f)
        out[field] = {
            suffix: np.asarray(data.get(suffix, {}).get(field, []), dtype=np.float64)
            for suffix in TITLE_SUFFIXES
        }
    return out


def write_energy_metrics_json(
    save_dir: str,
    energies: Dict[str, Dict[str, np.ndarray]],
    ks_pvalues: Dict[str, float],
    combined: float,
    filename: str = "nbody_macro_metrics.json",
) -> None:
    """The compact energy and KS record."""
    os.makedirs(save_dir, exist_ok=True)
    payload = {
        "energies": {
            f"{run}_{kind}": np.asarray(energies[run][kind]).tolist()
            for kind in ("total", "potential", "kinetic") for run in ("simulation", "self_feed")
        },
        "ks_pvalues": {
            **{k: (float(v) if v == v else float("nan")) for k, v in ks_pvalues.items()},
            "combined": float(combined) if combined == combined else float("nan"),
        },
    }
    with open(os.path.join(save_dir, filename), "w") as f:
        json.dump(payload, f)


def save_trajectories(save_dir: str, loc_actual, loc_pred, vel_actual, vel_pred) -> str:
    """Per-sim ``.npy`` dumps under ``save_dir/trajectories_data``."""
    traj_dir = os.path.join(save_dir, "trajectories_data")
    os.makedirs(traj_dir, exist_ok=True)
    arrays = {"loc_actual": host(loc_actual), "loc_pred": host(loc_pred),
              "vel_actual": host(vel_actual), "vel_pred": host(vel_pred)}
    for i in range(arrays["loc_actual"].shape[0]):
        for name, arr in arrays.items():
            np.save(os.path.join(traj_dir, f"{name}_sim_{i}.npy"), arr[i])
    return traj_dir


def evaluate_rollout(
    save_dir: str,
    loc_actual,
    vel_actual,
    loc_pred,
    vel_pred,
    save_trajectory_npys: bool = True,
    plot: bool = False,
    extended: bool = False,
    interaction_strength: float = 2.0,
    softening: float = 0.2,
):
    """Macro and KS scoring of one rollout, writing every artifact; returns
    ``(per_macro_pvalues, combined_p, gt_macros, pred_macros)``.  ``plot`` draws
    the figures (see the module's docstring)."""
    loc_actual, vel_actual = host(loc_actual), host(vel_actual)
    loc_pred, vel_pred = host(loc_pred), host(vel_pred)
    gt = M.compute_all_macros(loc_actual, vel_actual)
    pred = M.compute_all_macros(loc_pred, vel_pred)
    write_macro_jsons(save_dir, gt, pred)
    if save_trajectory_npys:
        save_trajectories(save_dir, loc_actual, loc_pred, vel_actual, vel_pred)
    if plot:
        try:
            from ..viz.macro_plots import plot_macro_histograms, plot_trajectories_2d

            plot_macro_histograms(save_dir, gt, pred)
            plot_trajectories_2d(save_dir, loc_actual, loc_pred)
        except Exception:  # a figure never fails an evaluation
            traceback.print_exc()
    if extended:
        from .extended_artifacts import write_all_extended

        write_all_extended(save_dir, loc_actual, vel_actual, loc_pred, vel_pred,
                           G=interaction_strength, softening=softening, plot=plot)
    per, combined = KS.macro_ks_pvalues(gt, pred)
    return per, combined, gt, pred
