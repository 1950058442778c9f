"""Reload a trained run from its run dir: counterpart of the JAX package's
``train/restore.py``, for run dirs of either package."""

from __future__ import annotations

import json
import os
from types import SimpleNamespace
from typing import Optional, Tuple

from .. import _tf32  # noqa: F401  (TF32 off before torch is used)
import torch

from ..data.gravity_otf import GravityDatasetOtf
from ..models import count_params, create_model
from ..utils.config import namespace_to_dict
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
    ``device`` with the checkpoint's parameters loaded in their own dtype, as
    the JAX package keeps them (it returns them beside the model instead).
    ``seed`` seeds the rebuilt dataset's simulations; the metadata records
    none."""
    with open(os.path.join(run_dir, "training_args.json")) as f:
        args = SimpleNamespace(**json.load(f)["args"])
    state = params_from_jax(load_checkpoint(os.path.join(run_dir, checkpoint))["params"],
                            args.model_type)
    model = create_model(args.model_type, device=device, dtype=next(iter(state.values())).dtype,
                         **(args.model_kwargs or {}))
    model.load_state_dict(state)
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


def write_run_files(run_dir: str, args, model, dataset) -> None:
    """A run dir's description of its run, the JAX trainer's files:
    ``training_args.json``, ``model_params.json`` and
    ``<dataset_name>_dataset/metadata.json``."""
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "training_args.json"), "w") as f:
        json.dump({"args": namespace_to_dict(args)}, f, indent=4, default=str)
    with open(os.path.join(run_dir, "model_params.json"), "w") as f:
        attrs = {k: v for k, v in getattr(model, "init_kwargs", {}).items()
                 if isinstance(v, (int, float, str, bool, tuple, list, type(None)))}
        attrs["num_params"] = count_params(model)
        json.dump(attrs, f, indent=4, default=str)
    ds_dir = os.path.join(run_dir, f"{args.dataset_name}_dataset")
    os.makedirs(ds_dir, exist_ok=True)
    with open(os.path.join(ds_dir, "metadata.json"), "w") as f:
        json.dump(dataset.get_serializable_attributes(), f, indent=4)


def make_run_dir(run_dir: str, argv, checkpoint: str) -> str:
    """A run dir around an existing checkpoint, for the evaluation mains: the
    files a run of the training configuration ``argv`` (the ``train``
    command's ``--config`` and dot-overrides) would have written, and
    ``checkpoint`` copied in as ``model.ckpt``.  Nothing is trained, and no
    trajectory is drawn.  Returns ``run_dir``."""
    import shutil

    from ..data.dataloaders import create_dataloader
    from ..utils.config import parse_args

    args, _ = parse_args(list(argv))
    with torch.device("meta"):
        model = create_model(args.model_type, device="meta", **(args.model_kwargs or {}))
    write_run_files(run_dir, args, model, create_dataloader(args, device="cpu").dataset)
    shutil.copyfile(checkpoint, os.path.join(run_dir, "model.ckpt"))
    return run_dir
