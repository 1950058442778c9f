"""Evaluation around a run: GT-vs-GT floors and dt studies, checkpoint KS
ranking and per-layer statistics.  Counterpart of the JAX package's
``evaluation/``."""

from .ks_checkpoints import (  # noqa: F401
    evaluate_run_checkpoints,
    gt_baseline_pvalues,
    load_checkpoint_pvalues,
)
