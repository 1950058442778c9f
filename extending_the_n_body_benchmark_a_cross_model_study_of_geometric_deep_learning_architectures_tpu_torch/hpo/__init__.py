"""Hyper-parameter optimisation with param-budget matching."""

from .hpo import adjust_width_to_target, run_study, suggest_trial  # noqa: F401
