"""Secondary rollout artifacts: counterpart of the JAX package's
``metrics/extended_artifacts.py``, with its file names and schema.

* ``feature_distributions.json``
* ``difference_distributions.json``
* ``momentum_statistics.json``
* ``energy_statistics.json``

Schema per file: ``{suffix: {"timestamp": ..., <fields>}}`` with the suffixes
``ground truth`` / ``predicted``; raw value lists are capped at ``max_items``
evenly spaced samples.  ``plot=True`` also draws ``energy_statistics.png``
and the five extended multiplots (``viz/macro_plots.py``, numpy only), as the
JAX package does.
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Dict, Optional

import numpy as np
import torch

from ..core.physics import energies as energy_fn

TITLE_SUFFIXES = ("ground truth", "predicted")


def _cap(arr: np.ndarray, max_items: int) -> list:
    flat = np.asarray(arr).reshape(-1)
    if flat.size > max_items:
        idx = np.linspace(0, flat.size - 1, max_items).astype(int)
        flat = flat[idx]
    return flat.tolist()


def write_feature_distributions(save_dir: str, loc, vel, max_items: int = 100_000) -> None:
    """loc/vel: ``[2, S, T, N, 3]`` (gt, pred)."""
    ts = datetime.now().isoformat()
    data = {}
    for b, suffix in enumerate(TITLE_SUFFIXES):
        data[suffix] = {
            "timestamp": ts,
            "position": _cap(loc[b], max_items),
            "velocity": _cap(vel[b], max_items),
            "force": None,
        }
    with open(os.path.join(save_dir, "feature_distributions.json"), "w") as f:
        f.write(json.dumps(data))  # dumps: the C encoder, the bytes json.dump writes


def write_difference_distributions(save_dir: str, loc, vel, step: int = 1,
                                   max_items: int = 100_000) -> None:
    ts = datetime.now().isoformat()
    data = {}
    for b, suffix in enumerate(TITLE_SUFFIXES):
        data[suffix] = {
            "timestamp": ts,
            "position_difference": _cap(np.diff(loc[b], axis=1, n=step), max_items),
            "velocity_difference": _cap(np.diff(vel[b], axis=1, n=step), max_items),
        }
    with open(os.path.join(save_dir, "difference_distributions.json"), "w") as f:
        f.write(json.dumps(data))


def write_momentum_statistics(save_dir: str, vel) -> Dict:
    """Per-sim time mean of the total momentum's magnitude (unit masses)."""
    ts = datetime.now().isoformat()
    data = {}
    for b, suffix in enumerate(TITLE_SUFFIXES):
        total = np.sum(vel[b], axis=2)  # [S, T, 3]
        scalar = np.sqrt(np.sum(total * total, axis=-1))  # [S, T]
        data[suffix] = {"timestamp": ts, "momentum_statistics": scalar.mean(axis=1).tolist()}
    with open(os.path.join(save_dir, "momentum_statistics.json"), "w") as f:
        json.dump(data, f, indent=4)
    return data


ENERGY_FRAMES = 64  # frames a chunk: the [64, N, N] pair temporaries stay in cache


def compute_per_sim_energies(loc, vel, G: float, softening: float) -> np.ndarray:
    """``[S, T, 3]`` (kinetic, potential, total) per sim and frame, unit masses,
    computed ``ENERGY_FRAMES`` frames at a time (each frame's sums are the
    same as in one call)."""
    loc, vel = np.asarray(loc), np.asarray(vel)
    S, T = loc.shape[:2]
    flat_loc = torch.as_tensor(loc.reshape((S * T,) + loc.shape[2:]))
    flat_vel = torch.as_tensor(vel.reshape((S * T,) + vel.shape[2:]))
    out = []
    for i in range(0, S * T, ENERGY_FRAMES):
        l, v = flat_loc[i:i + ENERGY_FRAMES], flat_vel[i:i + ENERGY_FRAMES]
        mass = torch.ones(l.shape[:-1] + (1,), dtype=l.dtype)
        out.append(torch.stack(energy_fn(l, v, mass, G, softening), dim=-1))  # [frames, 3]
    return torch.cat(out).numpy().reshape(S, T, 3)


def write_energy_statistics(save_dir: str, loc, vel, G: float, softening: float,
                            plot: bool = False, arrays: Optional[Dict] = None) -> Dict:
    """Mean and standard deviation over sims of the energies against time;
    ``arrays``: :func:`compute_per_sim_energies` of each suffix, if the caller
    has them already."""
    ts = datetime.now().isoformat()
    labels = ["Kinetic Energy", "Potential Energy", "Total Energy"]
    if arrays is None:
        arrays = {suffix: compute_per_sim_energies(loc[b], vel[b], G, softening)
                  for b, suffix in enumerate(TITLE_SUFFIXES)}
    data = {}
    for suffix in TITLE_SUFFIXES:
        e = arrays[suffix]  # [S, T, 3]
        times = list(range(e.shape[1]))
        stats = [{"time": times, "mean": e[:, :, i].mean(axis=0).tolist(),
                  "std_dev": e[:, :, i].std(axis=0).tolist(), "label": label}
                 for i, label in enumerate(labels)]
        data[suffix] = {"timestamp": ts, "data": stats}
    with open(os.path.join(save_dir, "energy_statistics.json"), "w") as f:
        json.dump(data, f, indent=4)
    if plot:
        from ..viz.macro_plots import energy_statistics_figure, save_figures

        save_figures(save_dir, [energy_statistics_figure(arrays)])
    return data


def write_all_extended(save_dir: str, loc_actual, vel_actual, loc_pred, vel_pred,
                       G: float = 2.0, softening: float = 0.2, plot: bool = False,
                       max_items: int = 100_000) -> None:
    os.makedirs(save_dir, exist_ok=True)
    loc = np.stack([np.asarray(loc_actual), np.asarray(loc_pred)], axis=0)
    vel = np.stack([np.asarray(vel_actual), np.asarray(vel_pred)], axis=0)
    write_feature_distributions(save_dir, loc, vel, max_items)
    write_difference_distributions(save_dir, loc, vel, max_items=max_items)
    write_momentum_statistics(save_dir, vel)
    # the energies once, for the statistics and the multiplots
    energy_arrays = {sfx: compute_per_sim_energies(loc[b], vel[b], G, softening)
                     for b, sfx in enumerate(TITLE_SUFFIXES)}
    write_energy_statistics(save_dir, loc, vel, G, softening, plot=plot, arrays=energy_arrays)
    if plot:
        from ..viz.macro_plots import plot_extended_multiplots

        plot_extended_multiplots(save_dir, loc, vel, energy_arrays)
