"""Carrying weights across from the JAX package.

The JAX package's checkpoints (its ``train/checkpoint.py``) are pickles of
``{"params", "opt_state", "step_count", "best_metrics"}`` with host numpy
leaves.  ``opt_state`` holds optax classes, so a plain ``pickle.load`` imports
optax and with it JAX.  :func:`read_jax_checkpoint` reads the file with an
unpickler that maps every JAX-side class to an inert stand-in, and returns the
``params`` tree without importing any of them.

:func:`params_from_jax` maps that flax tree onto the port's ``EGNNMC``
``state_dict``: flax ``Dense`` kernels are ``[in, out]`` (an ``nn.Linear``
weight is ``[out, in]``), and the ``Scan_EGNNBlock_0/*`` leaves carry a
leading layer axis.
"""

from __future__ import annotations

import pickle
from collections import OrderedDict
from typing import Any, Dict

import numpy as np
import torch

_FOREIGN = ("jax", "jaxlib", "flax", "optax", "chex", "orbax")


class _Inert:
    """Stand-in for a JAX-side class met in a pickle: takes anything, keeps nothing."""

    def __new__(cls, *args, **kwargs):
        return super().__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _ParamsUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module.split(".")[0] in _FOREIGN:
            return type(name, (_Inert,), {"__module__": module})
        try:
            return super().find_class(module, name)
        except ModuleNotFoundError:
            if module.startswith("numpy._core"):  # written by numpy 2, read by numpy 1
                return super().find_class(module.replace("numpy._core", "numpy.core", 1), name)
            raise


def read_jax_checkpoint(path: str) -> Dict[str, Any]:
    """The ``params`` tree (nested dicts of numpy arrays) of a JAX-package
    pickle checkpoint, read without importing jax, flax or optax."""
    with open(path, "rb") as f:
        payload = _ParamsUnpickler(f).load()
    return payload["params"]


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))  # a writable copy


def _linears(node: Dict[str, Any]) -> list:
    """The ``TorchLinear_k`` children of a flax ``MLP`` node, in order."""
    keys = sorted((k for k in node if k.startswith("TorchLinear_")),
                  key=lambda k: int(k.rsplit("_", 1)[1]))
    return [node[k]["Dense_0"] for k in keys]


def params_from_jax(params: Dict[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """Map the JAX package's ``EGNNMC`` params tree onto the port's
    ``EGNNMC.state_dict()`` keys."""
    p = params.get("params", params)
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    emb = p["TorchLinear_0"]["Dense_0"]
    sd["embedding.weight"] = _tensor(emb["kernel"].T)
    sd["embedding.bias"] = _tensor(emb["bias"])

    scan = p["Scan_EGNNBlock_0"]
    for layer in range(scan["edge_w1"].shape[0]):
        pre = f"layers.{layer}."
        for name in ("edge_w1", "edge_b1", "edge_w2", "edge_b2",
                     "coord_w1", "coord_b1", "coord_w2"):
            sd[pre + name] = _tensor(scan[name][layer])
        # _finish creates the velocity gate (MLP_0) before the node model (MLP_1)
        for flax_name, port_name in (("MLP_0", "vel_mlp"), ("MLP_1", "node_mlp")):
            for k, dense in enumerate(_linears(scan[flax_name])):
                sd[f"{pre}{port_name}.layers.{k}.weight"] = _tensor(dense["kernel"][layer].T)
                sd[f"{pre}{port_name}.layers.{k}.bias"] = _tensor(dense["bias"][layer])

    t = 0
    while f"MLP_{t}" in p:
        for k, dense in enumerate(_linears(p[f"MLP_{t}"])):
            sd[f"heads.{t}.layers.{k}.weight"] = _tensor(dense["kernel"].T)
            sd[f"heads.{t}.layers.{k}.bias"] = _tensor(dense["bias"])
        t += 1
    return sd
