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
through ``weights.read_checkpoint``, without optax.

The ``orbax`` backend writes and reads the directory that the JAX package's
``orbax.checkpoint.PyTreeCheckpointer`` does (``<base>.orbax/``), with the
port's own readers and writers of its formats (``ckpt_format/``: OCDBT,
zarr v2, zstd), no orbax or tensorstore: ``_METADATA`` (each leaf's key path,
``key_type`` 1 for a sequence and 2 for a dict, and its value type),
``_CHECKPOINT_METADATA``, the OCDBT store of one zarr v2 array per leaf, and
``meta.json`` with ``step_count`` and ``best_metrics``.  Optax's state
classes are written as dicts keyed by field name and ``EmptyState`` as a
leaf of type ``None``, as orbax writes them.  Loading such a directory gives
the tree that the JAX package's ``load_checkpoint(path)`` gives with no
template: nested dicts, lists and None, each array in its own dtype.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import time
from typing import Any, Dict, List, Tuple

import numpy as np

from ..ckpt_format import ocdbt, zarr2
from ..weights import read_checkpoint

_ORBAX_HANDLER = ("orbax.checkpoint._src.handlers.pytree_checkpoint_handler."
                  "PyTreeCheckpointHandler")


class _OptaxTuple(tuple):
    """Stand-in for one of optax's state classes (a ``NamedTuple``): its
    fields in order, pickled as a call of that class, named by ``_GLOBAL``
    (module, name)."""

    _GLOBAL = None
    _fields: Tuple[str, ...] = ()

    def __new__(cls, *fields):
        return super().__new__(cls, fields)

    def __reduce__(self):
        return type(self), tuple(self)


def _optax_class(module: str, name: str, fields: Tuple[str, ...]) -> type:
    return type(name, (_OptaxTuple,), {"_GLOBAL": (module, name), "_fields": fields})


# optax 0.2.6's classes, by the modules that define them, with their fields
ScaleByAdamState = _optax_class("optax._src.transform", "ScaleByAdamState",
                                ("count", "mu", "nu"))
ScaleByScheduleState = _optax_class("optax._src.transform", "ScaleByScheduleState", ("count",))
EmptyState = _optax_class("optax._src.base", "EmptyState", ())
ApplyIfFiniteState = _optax_class("optax.transforms._conditionality", "ApplyIfFiniteState",
                                  ("notfinite_count", "last_finite", "total_notfinite",
                                   "inner_state"))


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
    """Write ``path/filename`` (pickle, any backend but ``orbax``, as in the
    JAX package) or ``path/<base>.orbax/`` (orbax) atomically: a temporary
    file or directory, then a rename."""
    os.makedirs(path, exist_ok=True)
    if backend == "orbax":
        return _save_orbax(path, params, opt_state, step_count, best_metrics, filename)
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
    """A checkpoint's payload, the port's or the JAX package's: a pickle file,
    or an orbax directory."""
    if os.path.isdir(path):
        return _load_orbax(path)
    return read_checkpoint(path)


# ------------------------------------------------------------------ orbax


def _leaves(node, keys: Tuple[Tuple[str, int], ...] = ()) -> List[Tuple[tuple, Any]]:
    """``(key path, leaf)`` in the order jax flattens the tree: dicts by sorted
    key, optax's states by field (key type 2), tuples and lists by index (key
    type 1); an empty state or None is a leaf ``None``."""
    if isinstance(node, _OptaxTuple):
        if not node:
            return [(keys, None)]
        return [leaf for f, v in zip(node._fields, node) for leaf in _leaves(v, keys + ((f, 2),))]
    if isinstance(node, dict):
        return [leaf for k in sorted(node) for leaf in _leaves(node[k], keys + ((str(k), 2),))]
    if isinstance(node, (tuple, list)):
        return [leaf for i, v in enumerate(node) for leaf in _leaves(v, keys + ((str(i), 1),))]
    return [(keys, None if node is None else np.asarray(node))]


def _save_orbax(path, params, opt_state, step_count, best_metrics, filename) -> str:
    base = filename[: -len(".ckpt")] if filename.endswith(".ckpt") else filename
    full = os.path.abspath(os.path.join(path, base + ".orbax"))
    tmp = f"{full}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    started = time.time_ns()
    tree_meta: Dict[str, Any] = {}
    items: Dict[bytes, bytes] = {}
    for keys, leaf in _leaves({"params": params, "opt_state": opt_state}):
        names = tuple(k for k, _ in keys)
        value = {"value_type": "None" if leaf is None else "np.ndarray",
                 "skip_deserialize": leaf is None}
        tree_meta[str(names)] = {"key_metadata": [{"key": k, "key_type": t} for k, t in keys],
                                 "value_metadata": value}
        if leaf is not None:
            items.update(zarr2.array_items(".".join(names), leaf))
    ocdbt.write_store(tmp, items)
    with open(os.path.join(tmp, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)
    with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": _ORBAX_HANDLER, "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": started, "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step_count": int(step_count), "best_metrics": dict(best_metrics or {})}, f)
    old = f"{full}.old-{os.getpid()}"
    if os.path.exists(full):
        os.replace(full, old)
    os.replace(tmp, full)
    shutil.rmtree(old, ignore_errors=True)
    return full


def _load_orbax(path: str) -> Dict[str, Any]:
    """The layout the JAX package's save writes, or a ValueError naming what
    was found instead."""
    meta_path = os.path.join(path, "_METADATA")
    if os.path.isfile(os.path.join(path, "checkpoint")):
        raise ValueError(f"{path}: an aggregate msgpack file ('checkpoint'); only orbax's "
                         "OCDBT layout, as the JAX package writes it, is read")
    if not os.path.isfile(meta_path):
        raise ValueError(f"{path}: no _METADATA (not an orbax PyTree checkpoint)")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: use_zarr3: true (zarr v3 arrays); only zarr v2 is read")
    if not meta.get("use_ocdbt"):
        raise ValueError(f"{path}: use_ocdbt: {meta.get('use_ocdbt')} (a tensorstore "
                         "directory per array); only the OCDBT store is read")
    store = ocdbt.read_store(path)
    root: Dict[str, Any] = {}
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        kind = entry["value_metadata"]["value_type"]
        if kind == "None":
            value = None
        elif kind in ("np.ndarray", "jax.Array"):
            value = zarr2.read_array(store, ".".join(k["key"] for k in keys))
        else:
            raise ValueError(f"{path}: leaf {[k['key'] for k in keys]} of value type "
                             f"{kind!r}; only arrays and None are read")
        node = root
        for k, nxt in zip(keys, keys[1:]):
            node = node.setdefault(_key(k), {} if nxt["key_type"] == 2 else _Seq())
        node[_key(keys[-1])] = value
    tree = _lists(root)
    info = {"step_count": 0, "best_metrics": {}}
    if os.path.exists(os.path.join(path, "meta.json")):
        with open(os.path.join(path, "meta.json")) as f:
            info = json.load(f)
    return {"params": tree["params"], "opt_state": tree["opt_state"],
            "step_count": int(info["step_count"]),
            "best_metrics": dict(info.get("best_metrics") or {})}


class _Seq(dict):
    """A sequence of the tree while it is read: index -> child."""


def _key(k: Dict[str, Any]):
    if k["key_type"] == 1:
        return int(k["key"])
    if k["key_type"] == 2:
        return k["key"]
    raise ValueError(f"orbax key type {k['key_type']} of {k['key']!r} (1 or 2 are read)")


def _lists(node):
    if isinstance(node, _Seq):
        return [_lists(node[i]) for i in sorted(node)]
    if isinstance(node, dict):
        return {k: _lists(v) for k, v in node.items()}
    return node
