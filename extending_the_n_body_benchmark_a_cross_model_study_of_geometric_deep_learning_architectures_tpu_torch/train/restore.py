"""Reload a trained run from its run dir: counterpart of the JAX package's
``train/restore.py``, for run dirs of either package."""

from __future__ import annotations

import json
import os
from types import SimpleNamespace
from typing import Optional, Tuple

from ..data.gravity_otf import GravityDatasetOtf
from ..models import create_model
from ..weights import params_from_jax
from .checkpoint import load_checkpoint


def find_dataset_metadata(run_dir: str) -> Optional[dict]:
    for d in os.listdir(run_dir):
        p = os.path.join(run_dir, d, "metadata.json")
        if d.endswith("_dataset") and os.path.exists(p):
            with open(p) as f:
                return json.load(f)
    return None


def load_run(
    run_dir: str,
    checkpoint: str = "model.ckpt",
    n_bodies: Optional[int] = None,
    seed: Optional[int] = None,
    device="cuda",
) -> Tuple[object, GravityDatasetOtf, SimpleNamespace]:
    """``(model, dataset, args)`` of a finished run dir, the model on
    ``device`` with the checkpoint's parameters loaded (the JAX package returns
    the parameters beside the model instead).  ``seed`` seeds the rebuilt
    dataset's simulations; the metadata records none."""
    with open(os.path.join(run_dir, "training_args.json")) as f:
        args = SimpleNamespace(**json.load(f)["args"])
    model = create_model(args.model_type, device=device, **(args.model_kwargs or {}))
    model.load_state_dict(params_from_jax(load_checkpoint(os.path.join(run_dir, checkpoint))["params"]))
    metadata = find_dataset_metadata(run_dir) or {}
    if "partition" in metadata or "cutoff_rate" in metadata:
        # an offline charged-systems run: from_metadata would fall back to
        # default gravity physics, a rollout against the wrong system
        raise ValueError(
            f"{run_dir} was trained on the offline dataset ({metadata.get('dataset_name')!r}); "
            "load_run rebuilds only on-the-fly gravity datasets")
    dataset = GravityDatasetOtf.from_metadata(metadata, n_bodies=n_bodies, cache_data=False,
                                              seed=seed, device=device)
    return model, dataset, args
