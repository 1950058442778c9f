"""Checkpoint save and restore: counterpart of the JAX package's
``train/checkpoint.py``, its pickle backend.

The payload is ``{"params", "opt_state", "step_count", "best_metrics"}`` of
plain dicts, tuples, numbers and numpy arrays, with no torch class in the
pickle: ``params`` in the JAX package's flax layout (``weights.params_to_jax``)
and ``opt_state`` AdamW's ``{"count", "mu", "nu"}`` in the same layout.  The
JAX package's ``load_checkpoint`` and ``restore.load_run`` read it unchanged;
its trainer's resume wants optax's own state classes and does not.  The
``orbax`` backend is not ported: orbax is not installed beside the port.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

from ..weights import read_checkpoint

_NO_ORBAX = ("the orbax checkpoint backend is not ported (orbax is not installed beside the "
             "port); use checkpoint_backend: pickle")


def save_checkpoint(
    path: str,
    params,
    opt_state,
    step_count: int,
    best_metrics: Dict[str, Any] | None = None,
    filename: str = "model.ckpt",
    backend: str = "pickle",
) -> str:
    """Write ``path/filename`` atomically (a tmp file, then ``os.replace``)."""
    if backend != "pickle":
        raise NotImplementedError(_NO_ORBAX)
    os.makedirs(path, exist_ok=True)
    payload = {
        "params": params,
        "opt_state": opt_state,
        "step_count": int(step_count),
        "best_metrics": dict(best_metrics or {}),
    }
    full = os.path.join(path, filename)
    tmp = full + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, full)
    return full


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A pickle checkpoint's payload, the port's or the JAX package's."""
    if os.path.isdir(path):
        raise NotImplementedError(_NO_ORBAX)
    return read_checkpoint(path)
