"""Carrying weights across from the JAX package.

The JAX package's checkpoints (its ``train/checkpoint.py``) are pickles of
``{"params", "opt_state", "step_count", "best_metrics"}`` with host numpy
leaves.  ``opt_state`` holds optax classes, so a plain ``pickle.load`` imports
optax and with it JAX.  :func:`read_checkpoint` reads the file with an
unpickler that maps every JAX-side class to a stand-in that keeps what the
pickle gives it (a namedtuple's fields), without importing any of them;
:func:`read_jax_checkpoint` returns its ``params`` tree.

:func:`params_from_jax` maps that flax tree onto the port's ``EGNNMC``
``state_dict``: flax ``Dense`` kernels are ``[in, out]`` (an ``nn.Linear``
weight is ``[out, in]``), and the ``Scan_EGNNBlock_0/*`` leaves carry a
leading layer axis.  :func:`params_to_jax` is its inverse, for the port's
own checkpoints.  :func:`opt_state_from_jax` finds AdamW's state (optax's
``ScaleByAdamState(count, mu, nu)``, or the port's ``{"count", "mu", "nu"}``)
and maps its moments the same way.
"""

from __future__ import annotations

import pickle
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_FOREIGN = ("jax", "jaxlib", "flax", "optax", "chex", "orbax")


class _Kept(tuple):
    """Stand-in for a JAX-side class met in a pickle: a tuple of the positional
    arguments it was rebuilt from (a namedtuple's fields, in order), with any
    pickled state kept as attributes."""

    def __new__(cls, *args, **kwargs):
        return super().__new__(cls, args)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)


class _ParamsUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module.split(".")[0] in _FOREIGN:
            return type(name, (_Kept,), {"__module__": module})
        try:
            return super().find_class(module, name)
        except ModuleNotFoundError:
            if module.startswith("numpy._core"):  # written by numpy 2, read by numpy 1
                return super().find_class(module.replace("numpy._core", "numpy.core", 1), name)
            raise


def read_checkpoint(path: str) -> Dict[str, Any]:
    """The whole payload of a pickle checkpoint, the JAX package's or the
    port's, read without importing jax, flax or optax."""
    with open(path, "rb") as f:
        return _ParamsUnpickler(f).load()


def read_jax_checkpoint(path: str) -> Dict[str, Any]:
    """The ``params`` tree (nested dicts of numpy arrays) of a JAX-package
    pickle checkpoint, read without importing jax, flax or optax."""
    return read_checkpoint(path)["params"]


# the flax names of the JAX EGNNMC's top-level modules, which the maps below
# follow: the embedding, and per target t a head ``MLP_t`` of ``TorchLinear_k``
LINEAR = "TorchLinear_"
EMBEDDING = f"{LINEAR}0"


def head_name(t: int) -> str:
    return f"MLP_{t}"


def linear_name(k: int) -> str:
    return f"{LINEAR}{k}"


def flax_layer_paths(model) -> list:
    """``[(module, [flax path, ...])]``: the port's ``EGNNMC`` modules under the
    paths the JAX package's flax model gives their outputs, its top-level
    layers only (what its ``capture_intermediates`` sees at depth <= 3):
    the embedding (``TorchLinear_0`` and its ``Dense_0``), each head ``MLP_t``
    and its layers ``MLP_t/TorchLinear_k``, and the model's own output ``""``."""
    out = [(model.embedding, [EMBEDDING, f"{EMBEDDING}/Dense_0"])]
    for t, head in enumerate(model.heads):
        out.append((head, [head_name(t)]))
        out += [(lin, [f"{head_name(t)}/{linear_name(k)}"]) for k, lin in enumerate(head.layers)]
    return out + [(model, [""])]


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))  # a writable copy


def _linears(node: Dict[str, Any]) -> list:
    """The ``TorchLinear_k`` children of a flax ``MLP`` node, in order."""
    keys = sorted((k for k in node if k.startswith(LINEAR)),
                  key=lambda k: int(k.rsplit("_", 1)[1]))
    return [node[k]["Dense_0"] for k in keys]


def params_from_jax(params: Dict[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """Map the JAX package's ``EGNNMC`` params tree onto the port's
    ``EGNNMC.state_dict()`` keys."""
    p = params.get("params", params)
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    emb = p[EMBEDDING]["Dense_0"]
    sd["embedding.weight"] = _tensor(emb["kernel"].T)
    sd["embedding.bias"] = _tensor(emb["bias"])

    scan = p["Scan_EGNNBlock_0"]
    for layer in range(scan["edge_w1"].shape[0]):
        pre = f"layers.{layer}."
        for name in ("edge_w1", "edge_b1", "edge_w2", "edge_b2",
                     "coord_w1", "coord_b1", "coord_w2"):
            sd[pre + name] = _tensor(scan[name][layer])
        # _finish creates the velocity gate (MLP_0) before the node model (MLP_1)
        for jax_name, port_name in (("MLP_0", "vel_mlp"), ("MLP_1", "node_mlp")):
            for k, dense in enumerate(_linears(scan[jax_name])):
                sd[f"{pre}{port_name}.layers.{k}.weight"] = _tensor(dense["kernel"][layer].T)
                sd[f"{pre}{port_name}.layers.{k}.bias"] = _tensor(dense["bias"][layer])

    t = 0
    while head_name(t) in p:
        for k, dense in enumerate(_linears(p[head_name(t)])):
            sd[f"heads.{t}.layers.{k}.weight"] = _tensor(dense["kernel"].T)
            sd[f"heads.{t}.layers.{k}.bias"] = _tensor(dense["bias"])
        t += 1
    return sd


def _array(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _dense(weight: torch.Tensor, bias: torch.Tensor) -> Dict[str, Any]:
    return {"Dense_0": {"kernel": _array(weight).T.copy(), "bias": _array(bias)}}


def _mlp(sd, prefix: str) -> Dict[str, Any]:
    """The flax ``MLP`` node of the port's ``MLP`` at ``prefix`` (one layer)."""
    out, k = {}, 0
    while f"{prefix}.layers.{k}.weight" in sd:
        out[linear_name(k)] = _dense(sd[f"{prefix}.layers.{k}.weight"],
                                         sd[f"{prefix}.layers.{k}.bias"])
        k += 1
    return out


def params_to_jax(sd) -> Dict[str, Any]:
    """The port's ``EGNNMC.state_dict()`` (or a dict of tensors on its keys) as
    the JAX package's ``EGNNMC`` params tree of numpy arrays: the inverse of
    :func:`params_from_jax`."""
    p: Dict[str, Any] = {EMBEDDING: _dense(sd["embedding.weight"], sd["embedding.bias"])}
    layers = 0
    while f"layers.{layers}.edge_w1" in sd:
        layers += 1
    per_layer = [{name: _array(sd[f"layers.{i}.{name}"])
                  for name in ("edge_w1", "edge_b1", "edge_w2", "edge_b2",
                               "coord_w1", "coord_b1", "coord_w2")} for i in range(layers)]
    scan: Dict[str, Any] = {name: np.stack([lay[name] for lay in per_layer])
                            for name in per_layer[0]}
    for jax_name, port_name in (("MLP_0", "vel_mlp"), ("MLP_1", "node_mlp")):
        mlps = [_mlp(sd, f"layers.{i}.{port_name}") for i in range(layers)]
        scan[jax_name] = {lin: {"Dense_0": {leaf: np.stack([m[lin]["Dense_0"][leaf] for m in mlps])
                                             for leaf in ("kernel", "bias")}}
                           for lin in mlps[0]}
    p["Scan_EGNNBlock_0"] = scan
    t = 0
    while f"heads.{t}.layers.0.weight" in sd:
        p[head_name(t)] = _mlp(sd, f"heads.{t}")
        t += 1
    return {"params": p}


def _find_adam(node) -> Optional[Tuple[Any, Any, Any]]:
    if isinstance(node, dict):
        if {"count", "mu", "nu"} <= set(node):
            return node["count"], node["mu"], node["nu"]
        children = node.values()
    elif isinstance(node, (tuple, list)):
        if type(node).__name__ == "ScaleByAdamState":
            return tuple(node)
        children = node
    else:
        return None
    for child in children:
        found = _find_adam(child)
        if found is not None:
            return found
    return None


def opt_state_from_jax(opt_state) -> Optional[Tuple[int, "OrderedDict[str, torch.Tensor]",
                                                    "OrderedDict[str, torch.Tensor]"]]:
    """AdamW's state in a checkpoint's ``opt_state``: ``(count, exp_avg,
    exp_avg_sq)`` with the moments on ``EGNNMC.state_dict()`` keys (the map and
    transposes of :func:`params_from_jax`), or None if it holds none.  Reads
    optax's ``ScaleByAdamState(count, mu, nu)`` wherever it sits in the chain
    (under clipping or ``apply_if_finite`` too) and the port's ``{"count",
    "mu", "nu"}``."""
    found = _find_adam(opt_state)
    if found is None:
        return None
    count, mu, nu = found
    return int(np.asarray(count)), params_from_jax(mu), params_from_jax(nu)
