"""Statistical self-validation studies: counterpart of the JAX package's
``evaluation/studies.py``.

* :func:`baseline_metamacros`: GT-vs-GT macro comparisons across independent
  batches, scored with KL/JS divergence and KS p-values, the macro noise floor
  a model run is read against.
* :func:`compare_dt`: integrator dt-sensitivity, each macro at several dt
  against the base dt, on the same frame grid.

Every GT batch comes from ``data.gravity_otf.GravityDatasetOtf`` on its
device: on the card, one launch of the integrator K2-leapfrog a batch.  Every
JSON is written with the JAX package's keys, and beside it the JAX package's
figure (``baseline_metamacros.png``: KL and JS box plots per macro and the
combined-p floor; ``compare_dt.png``: KS p against dt), drawn by
``viz/macro_plots.py`` (numpy only).

    python -m <package>.evaluation.studies metamacros|compare_dt [--device cpu] ...
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..data.gravity_otf import GravityDatasetOtf
from ..metrics import macros as M
from ..metrics.artifacts import host
from ..metrics.ks import SCORED_MACROS, combine_scored, ks_p
from ..viz.macro_plots import compare_dt_figure, metamacros_figure, save_figures

# the per-macro floor covers com_movement and stuck_cluster_size too; the
# combined floor is combine_scored's six-macro basis, as a model run is scored
MACRO_KEYS = SCORED_MACROS + ["com_movement", "stuck_cluster_size"]


def _hist_divergences(a: np.ndarray, b: np.ndarray, bins: int = 20):
    """KL and JS divergence between histogram estimates of two samples."""
    lo = min(a.min(), b.min())
    hi = max(a.max(), b.max())
    if lo == hi:
        hi = lo + 1.0
    edges = np.linspace(lo, hi, bins + 1)
    pa, _ = np.histogram(a, bins=edges, density=False)
    pb, _ = np.histogram(b, bins=edges, density=False)
    pa = (pa + 1e-10) / (pa.sum() + 1e-10 * bins)
    pb = (pb + 1e-10) / (pb.sum() + 1e-10 * bins)
    kl = float(np.sum(pa * np.log(pa / pb)))
    m = 0.5 * (pa + pb)
    js = float(0.5 * np.sum(pa * np.log(pa / m)) + 0.5 * np.sum(pb * np.log(pb / m)))
    return kl, js


def _gt_macros(dataset: GravityDatasetOtf) -> Dict[str, np.ndarray]:
    loc, vel, *_ = dataset.get_ground_truth_trajectories()
    return M.compute_all_macros(host(loc), host(vel))


def baseline_metamacros(
    dataset: GravityDatasetOtf,
    num_batches: int = 10,
    save_dir: Optional[str] = None,
) -> Dict:
    """Pairwise GT-vs-GT macro comparisons across ``num_batches`` fresh
    batches: per-macro KL/JS/KS statistics and each pair's combined p."""
    batches = [_gt_macros(dataset) for _ in range(num_batches)]
    stats: Dict[str, Dict[str, List[float]]] = {
        k: {"kl": [], "js": [], "ks_p": []} for k in MACRO_KEYS
    }
    for i in range(num_batches):
        for j in range(i + 1, num_batches):
            for k in MACRO_KEYS:
                kl, js = _hist_divergences(batches[i][k], batches[j][k])
                stats[k]["kl"].append(kl)
                stats[k]["js"].append(js)
                stats[k]["ks_p"].append(ks_p(batches[i][k], batches[j][k]))

    summary = {
        k: {
            "kl_mean": float(np.mean(v["kl"])),
            "js_mean": float(np.mean(v["js"])),
            "ks_p_median": float(np.nanmedian(v["ks_p"])),
            "ks_p_min": float(np.nanmin(v["ks_p"])),
        }
        for k, v in stats.items()
    }
    combined_floor = [
        combine_scored({k: stats[k]["ks_p"][idx] for k in MACRO_KEYS})
        for idx in range(len(stats[MACRO_KEYS[0]]["ks_p"]))
    ]
    out = {"per_macro": summary, "combined_pvalues": combined_floor}
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, "baseline_metamacros.json"), "w") as f:
            json.dump(out, f, indent=2)
        save_figures(save_dir, [metamacros_figure(stats, combined_floor)])
    return out


def compare_dt(
    base_dataset: GravityDatasetOtf,
    dt_values: Sequence[float] = (0.001, 0.002, 0.005, 0.01, 0.02, 0.05),
    save_dir: Optional[str] = None,
) -> Dict:
    """Macro sensitivity to the integrator step: KS of each macro against the
    base dt.  The number of saved frames and the physical time between them
    stay those of the base: a variant's sample_freq is ``frame spacing / dt``
    and its substeps scale to match, so frame-count macros see one sampling
    grid.  A dt that does not divide the frame spacing breaks that grid, and a
    warning says so."""
    base = _gt_macros(base_dataset)
    frame_spacing = base_dataset.sample_freq * base_dataset.dt  # physical time
    num_frames = base_dataset.sim_length // base_dataset.sample_freq

    results = {}
    for dt in dt_values:
        sample_freq = max(int(round(frame_spacing / dt)), 1)
        sim_length = num_frames * sample_freq
        actual_spacing = sample_freq * dt
        spacing_err = abs(actual_spacing - frame_spacing) / frame_spacing
        if spacing_err > 1e-6:
            warnings.warn(
                f"compare_dt: dt={dt} gives frame spacing {actual_spacing:.6g}"
                f" vs base {frame_spacing:.6g} ({spacing_err:.1%} off) — "
                "frame-grid macros are confounded at this dt"
            )
        ds = GravityDatasetOtf(
            dataset_name=base_dataset.dataset_name,
            target=base_dataset.target,
            batch_size=base_dataset.batch_size,
            sim_length=sim_length,
            sample_freq=sample_freq,
            noise_var=base_dataset.noise_var,
            num_nodes=base_dataset.num_nodes,
            vel_norm=base_dataset.vel_norm,
            interaction_strength=base_dataset.interaction_strength,
            dt=dt,
            softening=base_dataset.softening,
            double_precision=base_dataset.double_precision,
            center_of_mass=base_dataset.center_of_mass,
            cache_data=False,
            device=base_dataset.device,
        )
        mac = _gt_macros(ds)
        per = {k: ks_p(base[k], mac[k]) for k in MACRO_KEYS}
        results[dt] = {
            "per_macro_ks_p": per,
            "combined": combine_scored(per),
            "sim_length": sim_length,
            "sample_freq": sample_freq,
            "frame_spacing": actual_spacing,
            "frame_spacing_rel_error": spacing_err,
        }
    out = {"base_dt": base_dataset.dt, "results": {str(k): v for k, v in results.items()}}
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, "compare_dt.json"), "w") as f:
            json.dump(out, f, indent=2)
        save_figures(save_dir, [compare_dt_figure(out, MACRO_KEYS)])
    return out


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="GT-vs-GT metamacro noise floor / dt-sensitivity studies"
    )
    p.add_argument("study", choices=["metamacros", "compare_dt"])
    p.add_argument("--out", default="figures/studies")
    p.add_argument("--num-batches", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--num-atoms", type=int, default=5)
    p.add_argument("--sim-length", type=int, default=5000)
    p.add_argument("--dt-values", type=float, nargs="+", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    ds = GravityDatasetOtf(
        batch_size=args.batch_size,
        num_nodes=args.num_atoms,
        sim_length=args.sim_length,
        cache_data=False,
        device=args.device,
    )
    if args.study == "metamacros":
        out = baseline_metamacros(ds, num_batches=args.num_batches, save_dir=args.out)
        for k, v in out["per_macro"].items():
            print(f"{k}: kl={v['kl_mean']:.3g} js={v['js_mean']:.3g} "
                  f"ks_p_median={v['ks_p_median']:.3g}")
    else:
        kw = {"dt_values": tuple(args.dt_values)} if args.dt_values else {}
        out = compare_dt(ds, save_dir=args.out, **kw)
        for d, r in out["results"].items():
            print(f"dt={d}: combined p = {r['combined']:.3g}")
    print(f"artifacts in {args.out}")
    return out


if __name__ == "__main__":
    main()
