"""Macro histograms, trajectory, p-value and study figures: counterpart of
the JAX package's ``viz/macro_plots.py`` and of the figures its callers draw
(``metrics/extended_artifacts.py``, ``evaluation/ks_checkpoints.py``,
``evaluation/studies.py``), with their file names, figure sizes, panel
grids, titles, labels, bins and scales.

Each ``*_figure(s)`` function builds the figure descriptions
(:class:`.raster.Figure`) from numpy inputs and draws nothing; each
``plot_*`` function builds them, renders them (:mod:`.raster`) and writes the
PNGs, and returns the descriptions it wrote.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import raster
from .raster import Figure, subplots

_MACRO_PLOTS = {
    # field -> (filename, xlabel, bins)
    "sticking_histogram": ("sticking_distribution.png", "Sticking Count", 50),
    "collision_histogram": ("collision_distribution.png", "Collision Count", 50),
    "leaving_count": ("leaving_distribution.png", "Leaving Count", 6),
    "sharp_turn_count_30": ("sharp_turns_distribution_30.png", "Sharp Turns Count", 60),
    "sharp_turn_count_45": ("sharp_turns_distribution_45.png", "Sharp Turns Count", 60),
    "com_movement": ("max_com_distance_distribution.png", "Max CoM Distance", 60),
    "group_collision_count": ("group_collision_distribution_multiplot.png",
                              "Group Collision Count", 50),
}


def save_figures(save_dir: str, figs: Sequence[Figure]) -> List[Figure]:
    """Render and write each figure under ``save_dir``."""
    os.makedirs(save_dir, exist_ok=True)
    for fig in figs:
        raster.save(fig, os.path.join(save_dir, fig.filename))
    return list(figs)


def hist_edges(g: np.ndarray, p: np.ndarray, bins: int) -> np.ndarray:
    """The shared edges of a pair: ``bins`` equal bins over both arrays' finite
    range, ``[0, 1]`` without one, one unit wide when the range is a point."""
    lo = min(np.nanmin(g, initial=np.inf), np.nanmin(p, initial=np.inf))
    hi = max(np.nanmax(g, initial=-np.inf), np.nanmax(p, initial=-np.inf))
    if not np.isfinite(lo) or not np.isfinite(hi):
        lo, hi = 0.0, 1.0
    if lo == hi:
        hi = lo + 1.0
    return np.linspace(lo, hi, bins + 1)


def _hist_pair(panels, g, p, xlabel, bins=60, title_fmt="{xlabel} — {title}") -> None:
    """Shared-bin GT-vs-predicted histogram pair; NaN frames are left out."""
    g, p = np.asarray(g, np.float64).ravel(), np.asarray(p, np.float64).ravel()
    edges = hist_edges(g, p, bins)
    for panel, data, title in zip(panels, (g, p), ("Ground Truth", "Predicted")):
        panel.hist(data[np.isfinite(data)], edges, alpha=0.7, edgecolor="black")
        panel.xlabel, panel.ylabel = xlabel, "Frequency"
        panel.title = title_fmt.format(xlabel=xlabel, title=title)


def macro_histogram_figures(gt: Dict[str, np.ndarray],
                            pred: Dict[str, np.ndarray]) -> List[Figure]:
    """A GT-vs-predicted pair per macro present in both, shared bin edges."""
    figs = []
    for field, (fname, xlabel, bins) in _MACRO_PLOTS.items():
        if field not in gt or field not in pred:
            continue
        fig = subplots(fname, 2, 1, figsize=(10, 12), sharex=True, sharey=True)
        _hist_pair(fig.panels, gt[field], pred[field], xlabel, bins=bins,
                   title_fmt="{xlabel} Distribution — {title}")
        figs.append(fig)
    return figs


def plot_macro_histograms(save_dir: str, gt: Dict[str, np.ndarray],
                          pred: Dict[str, np.ndarray]) -> List[Figure]:
    return save_figures(save_dir, macro_histogram_figures(gt, pred))


def trajectories_2d_figure(loc_actual: np.ndarray, loc_pred: np.ndarray, max_sims: int = 4,
                           filename: str = "trajectories_3D_to_2D.png") -> Figure:
    """x-y projections of each body's track, GT and predicted side by side."""
    n_sims = min(max_sims, loc_actual.shape[0])
    fig = subplots(filename, n_sims, 2, figsize=(12, 5 * n_sims))
    for s in range(n_sims):
        for c, (loc, title) in enumerate([(loc_actual, "ground truth"), (loc_pred, "predicted")]):
            ax = fig.axes(s, c)
            for b in range(loc.shape[2]):
                ax.plot(loc[s, :, b, 0], loc[s, :, b, 1], alpha=0.6, lw=0.8)
            ax.title = f"sim {s} — {title}"
            ax.aspect = "equal"
    return fig


def plot_trajectories_2d(save_dir: str, loc_actual: np.ndarray, loc_pred: np.ndarray,
                         max_sims: int = 4,
                         filename: str = "trajectories_3D_to_2D.png") -> List[Figure]:
    return save_figures(save_dir, [trajectories_2d_figure(
        np.asarray(loc_actual), np.asarray(loc_pred), max_sims, filename)])


def extended_multiplot_figures(loc: np.ndarray, vel: np.ndarray,
                               energies: Optional[Dict[str, np.ndarray]] = None,
                               max_sims: int = 16) -> List[Figure]:
    """The non-macro multiplots: feature, difference and momentum
    distributions, and with ``energies`` (``{suffix: [S, T, 3]}``, kinetic,
    potential, total) the per-sim energy curves and the energy distributions
    across sims.  ``loc``/``vel``: ``[2, S, T, N, 3]`` (gt, pred)."""
    loc, vel = np.asarray(loc), np.asarray(vel)
    fig = subplots("feature_distributions.png", 2, 2, figsize=(14, 10))
    _hist_pair([fig.axes(0, 0), fig.axes(1, 0)], loc[0], loc[1], "Position")
    _hist_pair([fig.axes(0, 1), fig.axes(1, 1)], vel[0], vel[1], "Velocity")
    figs = [fig]

    fig = subplots("difference_distributions.png", 2, 2, figsize=(14, 10))
    _hist_pair([fig.axes(0, 0), fig.axes(1, 0)], np.diff(loc[0], axis=1),
               np.diff(loc[1], axis=1), "Position Difference")
    _hist_pair([fig.axes(0, 1), fig.axes(1, 1)], np.diff(vel[0], axis=1),
               np.diff(vel[1], axis=1), "Velocity Difference")
    figs.append(fig)

    fig = subplots("momentum_statistics_multiplot.png", 2, 1, figsize=(10, 10), sharex=True)
    mom = [np.linalg.norm(vel[b].sum(axis=2), axis=-1).mean(axis=1) for b in (0, 1)]
    _hist_pair(fig.panels, mom[0], mom[1], "Mean Total Momentum", bins=30)
    figs.append(fig)

    if energies is not None:
        suffixes = list(energies)
        fig = subplots("energies_of_all_sims.png", len(suffixes), 1, figsize=(12, 10),
                       sharex=True)
        for ax, sfx in zip(fig.panels, suffixes):
            e = np.asarray(energies[sfx])
            for s in range(min(max_sims, e.shape[0])):
                ax.plot(np.arange(e.shape[1]), e[s, :, 2], alpha=0.5, lw=0.8)
            ax.title, ax.ylabel = f"Total energy per sim — {sfx}", "Energy"
        fig.panels[-1].xlabel = "step"
        figs.append(fig)

        fig = subplots("energy_distributions_across_all_sims.png", 2, 3, figsize=(16, 9))
        for i, label in enumerate(["Kinetic", "Potential", "Total"]):
            means = [np.asarray(energies[s])[:, :, i].mean(axis=1) for s in suffixes]
            _hist_pair([fig.axes(0, i), fig.axes(1, i)], means[0], means[-1],
                       f"{label} Energy", bins=30)
        figs.append(fig)
    return figs


def plot_extended_multiplots(save_dir: str, loc: np.ndarray, vel: np.ndarray,
                             energies: Optional[Dict[str, np.ndarray]] = None,
                             max_sims: int = 16) -> List[Figure]:
    return save_figures(save_dir, extended_multiplot_figures(loc, vel, energies, max_sims))


def pvalue_series_figure(steps, combined, per_metric: Optional[Dict[str, list]] = None,
                         filename: str = "combined_pvalues.png") -> Figure:
    """Combined and per-metric p-value against checkpoint on a log axis, the
    ``p = 0.05`` line; a metric that is NaN throughout is left out."""
    fig = subplots(filename, figsize=(10, 6))
    ax = fig.panels[0]
    ax.plot(steps, np.clip(np.asarray(combined, np.float64), 1e-300, None), "o-",
            label="combined p")
    for k, ys in (per_metric or {}).items():
        ys = np.asarray(ys, dtype=np.float64)
        if np.all(np.isnan(ys)):
            continue
        ax.plot(steps, np.clip(ys, 1e-300, None), ".-", alpha=0.6, label=k)
    ax.yscale = "log"
    ax.axhline(0.05, color="red", ls="--", lw=0.8, label="p = 0.05")
    ax.xlabel, ax.ylabel, ax.legend = "checkpoint", "p-value (Fisher)", True
    return fig


def plot_pvalue_series(save_dir: str, steps, combined,
                       per_metric: Optional[Dict[str, list]] = None,
                       filename: str = "combined_pvalues.png") -> List[Figure]:
    return save_figures(save_dir, [pvalue_series_figure(steps, combined, per_metric, filename)])


# ------------------------------------------- the callers' figures


def energy_statistics_figure(arrays: Dict[str, np.ndarray]) -> Figure:
    """Mean energy against time with a one-standard-deviation band, a panel per
    suffix (``arrays``: ``{suffix: [S, T, 3]}``, ground truth then predicted),
    as ``metrics/extended_artifacts.py`` draws ``energy_statistics.png``."""
    fig = subplots("energy_statistics.png", 2, 1, figsize=(12, 12), sharex=True)
    labels = ("Kinetic Energy", "Potential Energy", "Total Energy")
    for ax, (suffix, e) in zip(fig.panels, arrays.items()):
        e = np.asarray(e)
        for i, (label, color) in enumerate(zip(labels, ["red", "blue", "green"])):
            mean, std = e[:, :, i].mean(axis=0), e[:, :, i].std(axis=0)
            t = np.arange(len(mean))
            ax.plot(t, mean, color=color, label=label)
            ax.fill_between(t, mean - std, mean + std, color=color, alpha=0.2)
        ax.title, ax.legend = suffix.title(), True
    return fig


def multi_model_figure(series: Dict[str, List[Dict]], filename: str) -> Figure:
    """Each run's combined p against checkpoint, log y, the ``p = 0.05`` line
    (``evaluation/ks_checkpoints.py``'s overlay)."""
    fig = subplots(filename, figsize=(11, 6))
    ax = fig.panels[0]
    for label, rows in series.items():
        ax.plot([r["checkpoint"] for r in rows],
                [max(r["combined_pvalue"], 1e-300) for r in rows], "o-", ms=3, label=label)
    ax.axhline(0.05, color="red", ls="--", lw=0.8, label="p = 0.05")
    ax.yscale = "log"
    ax.xlabel, ax.ylabel, ax.legend = "checkpoint", "Fisher-combined p", True
    return fig


def metamacros_figure(stats: Dict[str, Dict[str, List[float]]],
                      combined_floor: Sequence[float]) -> Figure:
    """KL and JS box plots per macro and the combined-p noise-floor histogram
    (``evaluation/studies.py``'s ``baseline_metamacros.png``)."""
    keys = list(stats)
    fig = subplots("baseline_metamacros.png", 3, 1, figsize=(12, 14))
    for ax, metric, title in zip(fig.panels[:2], ("kl", "js"),
                                 ("KL divergence", "JS divergence")):
        ax.boxplot([stats[k][metric] for k in keys], tick_labels=keys)
        ax.title = f"GT-vs-GT {title} per macro (noise floor)"
    floor = np.clip(np.asarray(combined_floor, np.float64), 1e-300, None)
    ax = fig.panels[2]
    ax.hist(floor, np.histogram_bin_edges(floor, bins=20))  # what ax.hist(floor, bins=20) uses
    ax.xlabel, ax.title = "Fisher-combined p (GT vs GT)", "Combined p-value noise floor"
    return fig


def compare_dt_figure(out: Dict, macro_keys: Sequence[str]) -> Figure:
    """Combined and per-macro KS p against dt, log-log, the base dt marked
    (``evaluation/studies.py``'s ``compare_dt.png``)."""
    dts = sorted(out["results"], key=float)
    fig = subplots("compare_dt.png", figsize=(10, 6))
    ax = fig.panels[0]
    x = [float(d) for d in dts]
    ax.plot(x, [max(out["results"][d]["combined"], 1e-300) for d in dts], "o-",
            label="combined")
    for k in macro_keys:
        ax.plot(x, [max(out["results"][d]["per_macro_ks_p"][k], 1e-300) for d in dts], ".-",
                alpha=0.5, label=k)
    ax.axvline(float(out["base_dt"]), color="gray", ls=":", label="base dt")
    ax.xscale = ax.yscale = "log"
    ax.xlabel, ax.ylabel, ax.legend = "dt", "KS p vs base dt", True
    return fig
