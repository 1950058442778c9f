"""Checkpoint save and restore: counterpart of the JAX package's
``train/checkpoint.py``, its pickle backend.

The payload is ``{"params", "opt_state", "step_count", "best_metrics"}`` of
plain dicts, tuples, numbers and numpy arrays, with no torch class in the
pickle: ``params`` in the JAX package's flax layout (``weights.params_to_jax``)
and ``opt_state`` in the structure that the JAX package's optax chain has for
the run's flags (:func:`optax_opt_state`), its moments in the same layout.
The JAX package's ``load_checkpoint``, ``restore.load_run`` and its trainer's
resume (``Trainer.load_model_from_checkpoint``, which maps the saved state
onto its own optax state) read it unchanged.  The port reads it back, its
older ``{"count", "mu", "nu"}`` state and the JAX package's checkpoints
through ``weights.read_checkpoint``, without optax.  The ``orbax`` backend is
not ported: orbax is not installed beside the port.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import numpy as np

from ..weights import read_checkpoint

_NO_ORBAX = ("the orbax checkpoint backend is not ported (orbax is not installed beside the "
             "port); use checkpoint_backend: pickle")


class _OptaxTuple(tuple):
    """Stand-in for one of optax's state classes (a ``NamedTuple``): its
    fields in order, pickled as a call of that class, named by ``_GLOBAL``
    (module, name)."""

    _GLOBAL = None

    def __new__(cls, *fields):
        return super().__new__(cls, fields)

    def __reduce__(self):
        return type(self), tuple(self)


def _optax_class(module: str, name: str) -> type:
    return type(name, (_OptaxTuple,), {"_GLOBAL": (module, name)})


# optax 0.2.6's classes, by the modules that define them
ScaleByAdamState = _optax_class("optax._src.transform", "ScaleByAdamState")
ScaleByScheduleState = _optax_class("optax._src.transform", "ScaleByScheduleState")
EmptyState = _optax_class("optax._src.base", "EmptyState")
ApplyIfFiniteState = _optax_class("optax.transforms._conditionality", "ApplyIfFiniteState")


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, writing a stand-in's class as optax's global by
    name.  The C pickler imports a global's module to check it, and optax
    imports jax, which the port does not."""

    def save_global(self, obj, name=None):
        where = getattr(obj, "_GLOBAL", None) if isinstance(obj, type) else None
        if where is None:
            return super().save_global(obj, name)
        module, qualname = where
        if self.proto >= 4:
            self.save(module)
            self.save(qualname)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{module}\n{qualname}\n".encode())
        self.memoize(obj)


def optax_opt_state(optim, mu, nu):
    """``optim``'s (a ``train.optim.NoamAdamW``) state in the structure that the
    JAX package's ``create_optimizer`` (``train/optim.py:28-56``) gives it for
    the same flags, with the moment trees ``mu`` and ``nu``: the chain
    ``(clip?, clip_by_global_norm?, adamw)``, whose adamw part is
    ``(ScaleByAdamState(count, mu, nu), EmptyState(), ScaleByScheduleState(count))``
    and each clip an ``EmptyState()``, wrapped in
    ``ApplyIfFiniteState(notfinite_count, last_finite, total_notfinite, chain)``
    under ``discard_nan_gradients``."""
    count = optim.count
    adamw = (ScaleByAdamState(np.asarray(count, np.int32), mu, nu), EmptyState(),
             ScaleByScheduleState(np.asarray(count, np.int32)))
    clips = (optim.clip_value is not None) + (optim.clip_norm is not None)
    chain = (EmptyState(),) * clips + (adamw,)
    if not optim.discard_nan_gradients:
        return chain
    nf, last, total = optim.skip_counts()
    return ApplyIfFiniteState(np.asarray(nf, np.int32), np.asarray(last, np.bool_),
                              np.asarray(total, np.int32), chain)


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
        _Pickler(f).dump(payload)
    os.replace(tmp, full)
    return full


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A pickle checkpoint's payload, the port's or the JAX package's."""
    if os.path.isdir(path):
        raise NotImplementedError(_NO_ORBAX)
    return read_checkpoint(path)
