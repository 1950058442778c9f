"""Two-sample KS tests + Fisher combination (the port's own copy of the JAX
package's ``metrics/ks.py``) — port of ``utils/ks_utils.py``
and ``utils/hpo_metrics.py`` (identical numerics, incl. the 1e-300 floor and
200-digit mpmath log-sum with a pure-math fallback)."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

# The six scored macros of the reference's combined KS score
# (``utils/hpo_metrics.py:MACRO_FILES``, ``ks_test_model_checkpoints.py:38-49``).
SCORED_MACROS = [
    "collision_histogram",
    "group_collision_count",
    "leaving_count",
    "sharp_turn_count_30",
    "sharp_turn_count_45",
    "sticking_histogram",
]


def ks_p(a, b) -> float:
    """KS 2-sample p-value with the reference's NaN handling
    (``utils/ks_utils.py:7-17``)."""
    a = np.asarray(a, dtype=np.float64).ravel()
    b = np.asarray(b, dtype=np.float64).ravel()
    if a.size == 0 or b.size == 0:
        return float("nan")
    a = a[~np.isnan(a)]
    b = b[~np.isnan(b)]
    if a.size == 0 or b.size == 0:
        return float("nan")
    from scipy import stats

    _, p = stats.ks_2samp(a, b)
    return float(p)


def fisher_combine(p_values: List[float]) -> float:
    """Fisher's method over valid p-values (``utils/ks_utils.py:20-29``):
    chi2 survival of ``-2 * sum(log p)`` with 2k dof, floored at 1e-300.
    NaN and non-positive p-values are dropped."""
    vals = [p for p in p_values if p == p and p > 0.0]
    if not vals:
        return float("nan")
    try:
        from mpmath import log, mp, workdps

        with workdps(200):  # scoped, not a process-global mp.dps mutation
            chi_stat = float(-2 * mp.fsum([log(mp.mpf(p)) for p in vals]))
    except Exception:  # pragma: no cover
        chi_stat = -2.0 * sum(math.log(p) for p in vals)
    dof = 2 * len(vals)
    try:
        from scipy.stats import chi2

        combined = chi2.sf(chi_stat, dof)
    except Exception:  # pragma: no cover - normal approx (hpo_metrics.py:51-58)
        z = (chi_stat - dof) / math.sqrt(2.0 * dof)
        combined = 0.5 * (1.0 - math.erf(z / math.sqrt(2.0)))
    return float(max(combined, 1e-300))


def macro_ks_pvalues(
    gt: Dict[str, np.ndarray], pred: Dict[str, np.ndarray]
) -> Tuple[Dict[str, float], float]:
    """Per-macro KS p-values (GT vs predicted) + Fisher-combined p.

    Keys follow ``utils/hpo_metrics.py:MACRO_FILES`` (the six scored macros;
    ``com_movement`` is recorded but not part of the reference's combined
    score, so it is excluded from the combination here too).

    Above the group-macro N gate (``NBX_GROUP_MACRO_MAX_N``, PARITY.md) the
    reference's ``group_collision_count`` is NaN and Fisher would combine
    only five distributions; when the first-party ``stuck_cluster_size``
    macro is present it is scored IN ITS PLACE, restoring a six-macro basis
    at the bench shape.  At N≤gate the published six-macro basis is
    untouched (the extension p is recorded but not combined).
    """
    per: Dict[str, float] = {}
    for key in SCORED_MACROS:
        per[key] = ks_p(gt.get(key, []), pred.get(key, []))
    if "stuck_cluster_size" in gt or "stuck_cluster_size" in pred:
        per["stuck_cluster_size"] = ks_p(
            gt.get("stuck_cluster_size", []), pred.get("stuck_cluster_size", [])
        )
    return per, combine_scored(per)


def combine_scored(per: Dict[str, float]) -> float:
    """Fisher-combine a per-macro p-value dict under the published-basis
    rule: the six ``SCORED_MACROS``, with ``stuck_cluster_size``
    substituting for ``group_collision_count`` when the latter is NaN
    (the N>``NBX_GROUP_MACRO_MAX_N`` gate, PARITY.md).  Single source of
    truth for every combined-p consumer (in-run, post-hoc, GT-GT floors)."""
    vals = [per.get(k, float("nan")) for k in SCORED_MACROS]
    group = per.get("group_collision_count", float("nan"))
    ext = per.get("stuck_cluster_size", float("nan"))
    if group != group and ext == ext:
        vals.append(ext)
    return fisher_combine(vals)
