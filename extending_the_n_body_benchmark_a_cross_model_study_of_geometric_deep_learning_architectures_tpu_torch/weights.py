"""Carrying weights across from the JAX package.

The JAX package's checkpoints (its ``train/checkpoint.py``) are pickles of
``{"params", "opt_state", "step_count", "best_metrics"}`` with host numpy
leaves.  ``opt_state`` holds optax classes, so a plain ``pickle.load`` imports
optax and with it JAX.  :func:`read_checkpoint` reads the file with an
unpickler that maps every JAX-side class to a stand-in that keeps what the
pickle gives it (a namedtuple's fields), without importing any of them;
:func:`read_jax_checkpoint` returns its ``params`` tree.

:func:`params_from_jax` maps that flax tree onto the port's model's
``state_dict``, for every family, EGNN-MC, PONITA, SEGNN, SEConv,
EquiformerV2, GraphTransformer, PaiNN, CGENN and GMN:
flax ``Dense`` kernels are ``[in, out]`` (an ``nn.Linear`` weight is ``[out,
in]``), EGNN-MC's ``Scan_EGNNBlock_0/*`` leaves carry a leading layer axis,
PONITA's tree has, beside ``params``, the ``calib`` collection (three
statistics a convolution, which its convolutions keep as buffers), and the
leaves of SEGNN's ``mp_scan`` and SEConv's ``Scan_SEConvLayer_0`` carry a
leading layer axis; their tensor products' ``w_{a}_{b}_{c}`` and ``b_{c}``
keep flax's names and shapes.  EquiformerV2's, GraphTransformer's,
PaiNN's, CGENN's and GMN's modules carry their flax names, so a key maps to
its path by one rule (``_flax_leaf``): ``TorchLinear`` and bare ``Dense``
kernels transposed (GMN's bias-free ``Dense_0`` too), an ``MLP``'s
``layers.k`` its ``TorchLinear_k``, LayerNorm ``scale`` as ``weight``,
embeddings' ``embedding`` as ``weight``, every other leaf
(GraphTransformer's attention kernels in flax's shapes, PaiNN's ``[in,
out]`` ``EquivariantLinear`` weights, CGENN's ``weight``, ``bias``, ``a``
and ``b`` of its ``MVLinear_k``, ``MVSiLU_k``, ``_Normalization_0``,
``MVLayerNorm_k`` and geometric products) under its own name; the port's
``blocks.k`` are EquiformerV2's ``Scan_TransBlock_0``, PaiNN's
``Scan_PaiNNBlock_0``, CGENN's ``Scan_EGCL_0`` and GMN's
``Scan_GMNLayer_0``, split from (and stacked on) their leading axis, and
GraphTransformer's ``_EncoderLayer_k``.
:func:`params_to_jax` is its inverse, for the port's own checkpoints.
:func:`opt_state_from_jax` finds AdamW's state (optax's
``ScaleByAdamState(count, mu, nu)``, or the port's older ``{"count", "mu",
"nu"}``) and maps its moments the same way, the ``calib`` entries left out:
they are not parameters; :func:`skip_counts_from_jax` finds
``apply_if_finite``'s counters.

The family of a tree is the one a caller names (``model_type``) or, when it
names none, the one whose top-level module the tree holds (EGNN-MC's
``Scan_EGNNBlock_0``, PONITA's ``_ConvNextBlock_0``, SEGNN's ``mp_scan``,
SEConv's ``Scan_SEConvLayer_0``, EquiformerV2's ``Scan_TransBlock_0``,
GraphTransformer's ``_EncoderLayer_0``, PaiNN's ``Scan_PaiNNBlock_0``,
CGENN's ``Scan_EGCL_0``, GMN's ``Scan_GMNLayer_0``); a family the port does
not build, or a tree of none, raises.
"""

from __future__ import annotations

import pickle
from collections import OrderedDict
from collections.abc import Mapping
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .models.cgenn import CGENN
from .models.equiformer_v2 import EquiformerV2, SO2Conv
from .models.gmn import GMN
from .models.graph_transformer import GraphTransformer
from .models.painn import PaiNN
from .models.ponita import CALIB_STATS, PONITA
from .models.segnn import SEGNN, SEConv

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


FAMILIES = ("egnn_mc", "ponita", "segnn", "seconv", "equiformer_v2", "graph_transformer",
            "painn", "cgenn", "gmn")
# the top-level module that marks each family's flax tree, and state_dict key
_JAX_MARKER = {"egnn_mc": "Scan_EGNNBlock_0", "ponita": "_ConvNextBlock_0",
               "segnn": "mp_scan", "seconv": "Scan_SEConvLayer_0",
               "equiformer_v2": "Scan_TransBlock_0", "graph_transformer": "_EncoderLayer_0",
               "painn": "Scan_PaiNNBlock_0", "cgenn": "Scan_EGCL_0", "gmn": "Scan_GMNLayer_0"}
_PORT_MARKER = {"egnn_mc": "layers.0.edge_w1", "ponita": "blocks.0.conv.spatial.kernel",
                "segnn": "layers.0.message1.tp.b_0", "seconv": "layers.0.conv.b_0",
                "equiformer_v2": "blocks.0.SO2Attention_0.alpha_dot",
                "graph_transformer": "blocks.0.MultiHeadDotProductAttention_0.query.kernel",
                "painn": "blocks.0._Interaction_0.MLP_0.layers.0.weight",
                "cgenn": "blocks.0.CEMLP_0.MVLinear_0.weight",
                "gmn": "blocks.0.MLP_0.layers.0.weight"}
# the families whose modules carry their flax names: the flax module of the
# port's ``blocks.k``, and whether it is scanned (the layers stacked on a
# leading axis of one module's leaves)
_NAMED_BLOCKS = {"equiformer_v2": ("Scan_TransBlock_0", True),
                 "graph_transformer": ("_EncoderLayer_{}", False),
                 "painn": ("Scan_PaiNNBlock_0", True), "cgenn": ("Scan_EGCL_0", True),
                 "gmn": ("Scan_GMNLayer_0", True)}

_TP, _GATE = "SteerableTensorProduct_", "SteerableTPSwishGate_"
# (port module, flax path, scanned) of every module with parameters of the
# steerable families; a scanned module's leaves carry a leading layer axis,
# and its port name takes the layer's index.  Modules of an option that is
# off (SEGNN's instance norm, SEConv's nonlinear message) are absent from
# both trees
_STEERABLE_MODULES = {
    "segnn": [
        ("embedding", ("embedding",), False),
        ("layers.{}.message1.tp", ("mp_scan", f"{_GATE}0", f"{_TP}0"), True),
        ("layers.{}.message2.tp", ("mp_scan", f"{_GATE}1", f"{_TP}0"), True),
        ("layers.{}.update1.tp", ("mp_scan", f"{_GATE}2", f"{_TP}0"), True),
        ("layers.{}.update2", ("mp_scan", f"{_TP}0"), True),
        ("layers.{}.norm", ("mp_scan", "SteerableInstanceNorm_0"), True),
        ("pre_pool1.tp", ("pre_pool1", f"{_TP}0"), False),
        ("pre_pool2", ("pre_pool2",), False),
    ],
    "seconv": [
        ("embedding", (f"{_TP}0",), False),
        ("layers.{}.message.tp", ("Scan_SEConvLayer_0", f"{_GATE}0", f"{_TP}0"), True),
        ("layers.{}.conv", ("Scan_SEConvLayer_0", f"{_TP}0"), True),
        ("pre_pool1.tp", (f"{_GATE}0", f"{_TP}0"), False),
        ("pre_pool2", (f"{_TP}1",), False),
    ],
}


def _family(model_type: Optional[str], found: Optional[str], what: str) -> str:
    """The family to map ``what`` as: ``model_type`` if given (it must be
    ported, and ``what`` must be of it), else the family ``what`` was found
    to be."""
    if model_type is not None and model_type not in FAMILIES:
        raise NotImplementedError(
            f"model family {model_type!r} is not ported yet (ROADMAP.md, queue 1 item 6): "
            f"the port maps the weights of {FAMILIES}")
    if found is None:
        raise ValueError(f"{what} is of no ported family {FAMILIES}"
                         + (f" (model_type {model_type!r})" if model_type else ""))
    if model_type is not None and model_type != found:
        raise ValueError(f"{what} is a {found} tree, not {model_type}")
    return found


def jax_family(params: Dict[str, Any]) -> Optional[str]:
    """The ported family whose top-level module a flax params tree holds, or None."""
    p = params.get("params", params)
    return next((f for f, marker in _JAX_MARKER.items() if marker in p), None)


def port_family(sd) -> Optional[str]:
    """The ported family whose keys a port ``state_dict`` holds, or None."""
    return next((f for f, marker in _PORT_MARKER.items() if marker in sd), None)


def _ponita_rows(blocks: int, readouts: int) -> list:
    """``(port key, flax path, transposed)`` of every leaf PONITA's params tree
    may hold (``layer_scale`` only where it is enabled), in the port's
    ``state_dict`` order; the flax paths start at the ``params`` collection."""
    def linear(port: str, flax: tuple) -> list:  # a TorchLinear: an nn.Linear here
        return [(f"{port}.weight", flax + ("Dense_0", "kernel"), True),
                (f"{port}.bias", flax + ("Dense_0", "bias"), False)]

    rows = []
    for i in range(2):
        for j in range(2):
            rows += linear(f"basis_nets.{i}.layers.{j}", (f"_BasisNet_{i}", f"TorchLinear_{j}"))
    rows.append(("embedding.kernel", ("Dense_0", "kernel"), False))
    for k in range(blocks):
        blk, fblk = f"blocks.{k}", (f"_ConvNextBlock_{k}",)
        conv = fblk + ("_FiberBundleConv_0",)
        rows += [(f"{blk}.conv.spatial.kernel", conv + ("Dense_0", "kernel"), False),
                 (f"{blk}.conv.fiber.kernel", conv + ("Dense_1", "kernel"), False),
                 (f"{blk}.conv.bias", conv + ("bias",), False),
                 (f"{blk}.norm.weight", fblk + ("LayerNorm_0", "scale"), False),
                 (f"{blk}.norm.bias", fblk + ("LayerNorm_0", "bias"), False)]
        rows += linear(f"{blk}.mlp_in", fblk + (f"{LINEAR}0",))
        rows += linear(f"{blk}.mlp_out", fblk + (f"{LINEAR}1",))
        rows.append((f"{blk}.layer_scale", fblk + ("layer_scale",), False))
    for k in range(readouts):
        rows += linear(f"readouts.{k}", (linear_name(k),))
    return rows


def _ponita_calib_rows(blocks: int) -> list:
    """``(port buffer key, path in the calib collection)`` of each convolution's
    statistics."""
    return [(f"blocks.{k}.conv.{stat}", (f"_ConvNextBlock_{k}", "_FiberBundleConv_0", stat))
            for k in range(blocks) for stat in CALIB_STATS]


def _count(keys, fmt: str) -> int:
    n = 0
    while fmt.format(n) in keys:
        n += 1
    return n


def flax_layer_paths(model) -> list:
    """``[(module, [flax path, ...])]``: the port model's modules under the
    paths the JAX package's flax model gives their outputs, its top-level
    layers only (what its ``capture_intermediates`` sees at depth <= 3), and
    the model's own output ``""``.  EGNN-MC: the embedding (``TorchLinear_0``
    and its ``Dense_0``), each head ``MLP_t`` and its layers
    ``MLP_t/TorchLinear_k``.  PONITA: ``Dense_0``, ``_BasisNet_k`` and their
    ``TorchLinear_j``, each ``_ConvNextBlock_k`` and its
    ``_FiberBundleConv_0``, ``LayerNorm_0``, ``TorchLinear_0`` and
    ``TorchLinear_1``, each readout ``TorchLinear_k`` and its ``Dense_0``.
    SEGNN: ``embedding``, ``pre_pool1`` with its ``SteerableTensorProduct_0``
    and ``GateActivation_0``, ``pre_pool2``; SEConv the same modules under
    its names (the scanned layers are not seen).  EquiformerV2: each
    top-level module under its own name (a ``TorchLinear_k`` also as
    ``TorchLinear_k/Dense_0``) and each of its children, the activation as
    its flax class's first instance; the scanned blocks and an ``SO2Conv``
    that returns its extra channels beside its output (a tuple) are not
    seen.  GraphTransformer, PaiNN, CGENN and GMN: every module at most two
    flax modules deep under its flax path (GraphTransformer's encoder layers
    as ``_EncoderLayer_k``, their dropouts among them; a top-level
    ``TorchLinear_k`` also as ``TorchLinear_k/Dense_0``); the scanned blocks
    of PaiNN, CGENN and GMN are not seen."""
    named = {GraphTransformer: "graph_transformer", PaiNN: "painn", CGENN: "cgenn", GMN: "gmn"}
    if type(model) in named:
        return _named_layer_paths(model, named[type(model)])
    if isinstance(model, EquiformerV2):
        out = []
        for name, child in model.named_children():
            if name == "blocks":
                continue
            out.append((child, [name, f"{name}/Dense_0"] if name.startswith(LINEAR) else [name]))
            for sub, grand in child.named_children():
                if isinstance(grand, SO2Conv) and grand.extra:
                    continue
                flax = f"{type(grand).__name__}_0" if sub == "act" else sub
                out.append((grand, [f"{name}/{flax}"]))
        return out + [(model, [""])]
    if isinstance(model, (SEGNN, SEConv)):
        segnn = isinstance(model, SEGNN)
        emb, pool1, pool2 = (("embedding", "pre_pool1", "pre_pool2") if segnn
                             else (f"{_TP}0", f"{_GATE}0", f"{_TP}1"))
        return [(model.embedding, [emb]), (model.pre_pool1.tp, [f"{pool1}/{_TP}0"]),
                (model.pre_pool1.gate, [f"{pool1}/GateActivation_0"]),
                (model.pre_pool1, [pool1]), (model.pre_pool2, [pool2]), (model, [""])]
    if isinstance(model, PONITA):
        out = [(model.embedding, ["Dense_0"])]
        for i, net in enumerate(model.basis_nets):
            out.append((net, [f"_BasisNet_{i}"]))
            out += [(lin, [f"_BasisNet_{i}/{linear_name(j)}"]) for j, lin in enumerate(net.layers)]
        for k, blk in enumerate(model.blocks):
            name = f"_ConvNextBlock_{k}"
            out += [(blk, [name]), (blk.conv, [f"{name}/_FiberBundleConv_0"]),
                    (blk.norm, [f"{name}/LayerNorm_0"]),
                    (blk.mlp_in, [f"{name}/{linear_name(0)}"]),
                    (blk.mlp_out, [f"{name}/{linear_name(1)}"])]
        for k, lin in enumerate(model.readouts):
            out.append((lin, [linear_name(k), f"{linear_name(k)}/Dense_0"]))
        return out + [(model, [""])]
    out = [(model.embedding, [EMBEDDING, f"{EMBEDDING}/Dense_0"])]
    for t, head in enumerate(model.heads):
        out.append((head, [head_name(t)]))
        out += [(lin, [f"{head_name(t)}/{linear_name(k)}"]) for k, lin in enumerate(head.layers)]
    return out + [(model, [""])]


def _named_layer_paths(model, family: str) -> list:
    out = []
    for name, module in model.named_modules():
        if not name or isinstance(module, torch.nn.ModuleList):
            continue
        flax, layer = _flax_modules(name.split("."), family)
        if layer is not None or len(flax) > 2:
            continue
        path = "/".join(flax)
        top_linear = len(flax) == 1 and path.startswith(LINEAR)
        out.append((module, [path, f"{path}/Dense_0"] if top_linear else [path]))
    return out + [(model, [""])]


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))  # a writable copy


def _linears(node: Dict[str, Any]) -> list:
    """The ``TorchLinear_k`` children of a flax ``MLP`` node, in order."""
    keys = sorted((k for k in node if k.startswith(LINEAR)),
                  key=lambda k: int(k.rsplit("_", 1)[1]))
    return [node[k]["Dense_0"] for k in keys]


def _leaf(tree, path: tuple):
    for k in path:
        if not isinstance(tree, Mapping) or k not in tree:
            return None
        tree = tree[k]
    return tree


def params_from_jax(params: Dict[str, Any], model_type: Optional[str] = None,
                    calib: bool = True) -> "OrderedDict[str, torch.Tensor]":
    """Map a JAX package params tree (EGNN-MC's or PONITA's, see the module's
    note on families) onto the port model's ``state_dict()`` keys.  PONITA's
    ``calib`` statistics go to its convolutions' buffers (ones where the tree
    has none); ``calib=False`` leaves them out."""
    family = _family(model_type, jax_family(params), "the params tree")
    if family == "ponita":
        return _ponita_from_jax(params, calib)
    if family in _NAMED_BLOCKS:
        return _named_from_jax(params, family)
    if family in _STEERABLE_MODULES:
        return _steerable_from_jax(params, family)
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


def _ponita_from_jax(params: Dict[str, Any], calib: bool) -> "OrderedDict[str, torch.Tensor]":
    p = params.get("params", params)
    blocks = _count(p, "_ConvNextBlock_{}")
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for key, path, transposed in _ponita_rows(blocks, _count(p, LINEAR + "{}")):
        leaf = _leaf(p, path)
        if leaf is not None:
            sd[key] = _tensor(leaf.T if transposed else leaf)
    if calib:
        stats = params.get("calib", {}) if "params" in params else {}
        for key, path in _ponita_calib_rows(blocks):
            leaf = _leaf(stats, path)  # a sown value: a 1-tuple of a 0-d array
            sd[key] = _tensor(np.asarray(leaf[0]) if leaf is not None else np.float32(1.0))
    return sd


def _steerable_from_jax(params: Dict[str, Any], family: str) -> "OrderedDict[str, torch.Tensor]":
    p = params.get("params", params)
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for port, path, scanned in _STEERABLE_MODULES[family]:
        node = _leaf(p, path)
        for name, leaf in (node or {}).items():
            if scanned:
                for i in range(leaf.shape[0]):
                    sd[f"{port.format(i)}.{name}"] = _tensor(leaf[i])
            else:
                sd[f"{port}.{name}"] = _tensor(leaf)
    return sd


def _flax_leaf(mods: list, leaf: str) -> Tuple[list, str, bool]:
    """The rule between a port key and a flax path for the families whose
    modules carry their flax names: ``(modules, leaf, transposed)`` of the
    flax path, from the port key's modules (an ``MLP``'s ``layers.k`` read as
    its ``TorchLinear_k``) and leaf name.  A ``TorchLinear_k`` holds its
    ``Dense_0`` (``kernel`` the transposed ``weight``), a bare ``Dense_k`` its
    ``kernel``, a ``LayerNorm_k`` its ``scale``, an embedding its
    ``embedding``; every other leaf keeps its name."""
    parent = mods[-1] if mods else ""
    if parent.startswith(LINEAR):
        return mods + ["Dense_0"], {"weight": "kernel"}.get(leaf, leaf), leaf == "weight"
    if parent.startswith("Dense_"):
        return mods, "kernel", True
    if parent.startswith("LayerNorm_"):
        return mods, {"weight": "scale"}.get(leaf, leaf), False
    if parent == "Embed_0" or parent.endswith("embedding"):
        return mods, "embedding", False
    return mods, leaf, False


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _port_leaf(mods: list, name: str) -> Tuple[list, str, bool]:
    """The inverse of :func:`_flax_leaf`: ``(modules, leaf, transposed)`` of
    the port key whose flax path is ``mods`` and ``name``, the first of the
    few keys that can map there (a ``TorchLinear``'s owner of ``Dense_0``,
    then the path's own modules; ``weight``, ``bias``, then the name)."""
    owners = [mods[:-1]] if mods[-1:] == ["Dense_0"] else []
    for own in owners + [mods]:
        for leaf in ("weight", "bias", name):
            flax_mods, flax_leaf, transposed = _flax_leaf(own, leaf)
            if flax_mods == mods and flax_leaf == name:
                return own, leaf, transposed
    raise KeyError(f"no port key maps to {'/'.join(mods + [name])}")


def _flax_modules(parts: list, family: str) -> Tuple[list, Optional[int]]:
    """The flax modules of a port module path (``parts``) of a family whose
    modules carry their flax names: ``blocks.k`` read as the family's block
    module, an ``MLP``'s ``layers.k`` as its ``TorchLinear_k``; and ``k``
    where the block is scanned (None elsewhere)."""
    block, scanned = _NAMED_BLOCKS[family]
    layer = None
    if parts[:1] == ["blocks"]:
        layer, parts = int(parts[1]), [block.format(parts[1])] + parts[2:]
    mods, it = [], iter(parts)
    for comp in it:
        mods.append(f"{LINEAR}{next(it)}" if comp == "layers" else comp)
    return mods, layer if scanned else None


def _named_to_flax(key: str, family: str) -> Tuple[list, Optional[int], bool]:
    """``(flax path, layer, transposed)`` of a port key of a family whose
    modules carry their flax names: the modules by :func:`_flax_modules`,
    the leaf by :func:`_flax_leaf`."""
    parts = key.split(".")
    mods, layer = _flax_modules(parts[:-1], family)
    mods, leaf, transposed = _flax_leaf(mods, parts[-1])
    return mods + [leaf], layer, transposed


def _flax_to_named(path: tuple, family: str) -> Tuple[str, bool, bool]:
    """The inverse of :func:`_named_to_flax`: ``(port key, scanned,
    transposed)`` of a flax path, the key holding ``{}`` where a scanned
    leaf's layer goes."""
    block, scanned = _NAMED_BLOCKS[family]
    mods, leaf, transposed = _port_leaf(list(path[:-1]), path[-1])
    first, out = (mods or [""])[0], []
    if scanned and first == block:
        out, mods = ["blocks", "{}"], mods[1:]
    elif not scanned and first.startswith(block.format("")):
        out, mods = ["blocks", first[len(block.format("")):]], mods[1:]
    for j, comp in enumerate(mods):
        if comp.startswith(LINEAR) and j and mods[j - 1].startswith("MLP_"):
            out += ["layers", comp[len(LINEAR):]]  # an MLP's k-th linear
        else:
            out.append(comp)
    return ".".join(out + [leaf]), out[:2] == ["blocks", "{}"], transposed


def _named_from_jax(params: Dict[str, Any], family: str) -> "OrderedDict[str, torch.Tensor]":
    p = params.get("params", params)
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for path, leaf in _flat(p):
        key, scanned, transposed = _flax_to_named(path, family)
        arr = np.asarray(leaf)
        for i, a in (enumerate(arr) if scanned else [(None, arr)]):
            sd[key.format(i)] = _tensor(a.T if transposed else a)
    return sd


def _named_to_jax(sd, family: str) -> Dict[str, Any]:
    """A ``state_dict`` (a model's or one module's) of a family whose modules
    carry their flax names as the flax tree: each key's path by
    :func:`_named_to_flax`, a scanned block's layers stacked on a leading
    axis."""
    p: Dict[str, Any] = {}
    stacked: Dict[tuple, list] = {}
    for key, t in sd.items():
        path, layer, transposed = _named_to_flax(key, family)
        a = _array(t)
        a = a.T.copy() if transposed else a
        if layer is None:
            node = p
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = a
        else:
            stacked.setdefault(tuple(path), []).append((layer, a))
    for path, items in stacked.items():
        node = p
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.stack([a for _, a in sorted(items, key=lambda i: i[0])])
    return {"params": p}


def _leaf_names(sd, prefix: str) -> list:
    """The names of the leaves directly under module ``prefix`` of ``sd``."""
    start = prefix + "."
    return [k[len(start):] for k in sd if k.startswith(start) and "." not in k[len(start):]]


def _steerable_to_jax(sd, family: str) -> Dict[str, Any]:
    p: Dict[str, Any] = {}
    for port, path, scanned in _STEERABLE_MODULES[family]:
        prefixes = [port]
        if scanned:
            prefixes = []
            while _leaf_names(sd, port.format(len(prefixes))):
                prefixes.append(port.format(len(prefixes)))
        names = _leaf_names(sd, prefixes[0]) if prefixes else []
        if not names:
            continue
        node = p
        for k in path:
            node = node.setdefault(k, {})
        for name in names:
            arrays = [_array(sd[f"{prefix}.{name}"]) for prefix in prefixes]
            node[name] = np.stack(arrays) if scanned else arrays[0]
    return {"params": p}


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


def _ponita_to_jax(sd) -> Dict[str, Any]:
    blocks = _count(sd, "blocks.{}.conv.spatial.kernel")
    p: Dict[str, Any] = {}
    for key, path, transposed in _ponita_rows(blocks, _count(sd, "readouts.{}.weight")):
        if key in sd:
            node = p
            for k in path[:-1]:
                node = node.setdefault(k, {})
            a = _array(sd[key])
            node[path[-1]] = a.T.copy() if transposed else a
    stats: Dict[str, Any] = {}
    for key, path in _ponita_calib_rows(blocks):
        node = stats
        for k in path[:-1]:
            node = node.setdefault(k, {})
        value = _array(sd[key]) if key in sd else 1.0
        node[path[-1]] = (np.asarray(value, dtype=np.float32),)  # as flax sows it
    return {"calib": stats, "params": p}


def params_to_jax(sd, model_type: Optional[str] = None) -> Dict[str, Any]:
    """The port model's ``state_dict()`` (or a dict of tensors on its keys) as
    the JAX package's params tree of numpy arrays: the inverse of
    :func:`params_from_jax`.  PONITA's tree gets its ``calib`` collection, each
    statistic a 1-tuple of a 0-d float32 array as flax sows it: the model's
    last calibration, or ones where ``sd`` holds none."""
    family = _family(model_type, port_family(sd), "the state_dict")
    if family == "ponita":
        return _ponita_to_jax(sd)
    if family in _NAMED_BLOCKS:
        return _named_to_jax(sd, family)
    if family in _STEERABLE_MODULES:
        return _steerable_to_jax(sd, family)
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


def _find_state(node, match):
    """The first node of a state tree (dicts, tuples, lists) that ``match``
    accepts, depth first, or None."""
    if match(node):
        return node
    if isinstance(node, dict):
        children = node.values()
    elif isinstance(node, (tuple, list)):
        children = node
    else:
        return None
    for child in children:
        found = _find_state(child, match)
        if found is not None:
            return found
    return None


def _find_adam(node) -> Optional[Tuple[Any, Any, Any]]:
    """``(count, mu, nu)`` of the first ``ScaleByAdamState`` (or the port's
    older ``{"count", "mu", "nu"}``) in a state tree, or None."""
    found = _find_state(node, lambda n: (isinstance(n, dict) and {"count", "mu", "nu"} <= set(n))
                        or type(n).__name__ == "ScaleByAdamState")
    if found is None:
        return None
    return (found["count"], found["mu"], found["nu"]) if isinstance(found, dict) else tuple(found)


def skip_counts_from_jax(opt_state) -> Optional[Tuple[int, bool, int]]:
    """``optax.apply_if_finite``'s counters in a checkpoint's ``opt_state``,
    ``(notfinite_count, last_finite, total_notfinite)`` of its
    ``ApplyIfFiniteState``, or None if it holds none."""
    found = _find_state(opt_state, lambda n: type(n).__name__ == "ApplyIfFiniteState")
    if found is None:
        return None
    nf, last, total = found[:3]
    return int(np.asarray(nf)), bool(np.asarray(last)), int(np.asarray(total))


def opt_state_from_jax(opt_state, model_type: Optional[str] = None) -> Optional[
        Tuple[int, "OrderedDict[str, torch.Tensor]", "OrderedDict[str, torch.Tensor]"]]:
    """AdamW's state in a checkpoint's ``opt_state``: ``(count, exp_avg,
    exp_avg_sq)`` with the moments on the port model's parameter keys (the map
    and transposes of :func:`params_from_jax`, PONITA's ``calib`` entries left
    out), or None if it holds none.  Reads optax's ``ScaleByAdamState(count,
    mu, nu)`` wherever it sits in the chain (under clipping or
    ``apply_if_finite`` too) and the port's ``{"count", "mu", "nu"}``."""
    found = _find_adam(opt_state)
    if found is None:
        return None
    count, mu, nu = found
    return (int(np.asarray(count)), params_from_jax(mu, model_type, calib=False),
            params_from_jax(nu, model_type, calib=False))
