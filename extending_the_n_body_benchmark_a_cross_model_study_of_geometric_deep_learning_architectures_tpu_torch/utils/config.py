"""Config: sections, ``--section.key value`` overrides and one flat namespace.

Counterpart of the JAX package's ``utils/config.py``, without its two
dependencies, which are not installed beside the port:

* the defaults are :data:`DEFAULT_CONFIG`, the port's own copy of the JAX
  package's ``default_config.yaml`` (the tests hold the two equal);
* ``--config`` reads JSON, and YAML where PyYAML imports;
* the section checks that pydantic runs there are :data:`SCHEMA` and
  :func:`_coerce_field`: each known key gets its type (an int where a float is
  wanted becomes a float, as pydantic's lax mode does), unknown keys are
  dropped, and a value of the wrong type raises;
* the run dir's resolved ``config.yaml`` is written by a small emitter of a
  YAML subset (block mappings, flow lists, plain scalars) that PyYAML reads
  back to the same dict, so the JAX package's tools read a port run.

``parse_args(argv)`` gives the JAX package's flat namespace for the same argv.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import re
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Tuple

_LOADER = {
    "batch_size": 64,
    "num_neighbors": None,
    "double_precision": False,
    "gravity_dataset": {
        "center_of_mass": False,
        "dataset_name": "nbody_small",
        "num_atoms": 5,
        "sample_freq": 10,
        "target": "pos_dt+vel",
    },
}

#: the JAX package's ``default_config.yaml``, its anchors expanded
DEFAULT_CONFIG: Dict[str, Any] = {
    "main": {"model_type": "egnn_mc", "dataloader_type": "egnn_mc_nbody",
             "trainer_type": "trainer_nbody"},
    "models": {
        "graph_transformer": {"hidden_features": 96, "num_layers": 4, "num_heads": 4},
        "egnn_mc": {"num_layers": 6, "hidden_node_dim": 128, "hidden_edge_dim": 128,
                    "hidden_coord_dim": 128, "node_input_dim": 2, "edge_attr_dim": 4,
                    "activation": "silu", "coords_weight": 1.0, "recurrent": True,
                    "norm_diff": True, "tanh": True},
        "painn": {"hidden_features": 192, "num_layers": 6, "num_rbf": 64, "cutoff": 10.0,
                  "use_velocity_input": True, "include_velocity_norm": True},
        "segnn": {"hidden_features": 96, "lmax_attr": 1, "lmax_h": 1, "num_layers": 20},
        "ponita": {"hidden_features": 128, "num_layers": 8},
        "cgenn": {"hidden_features": 96, "num_layers": 4},
        "equiformer_v2": {"num_layers": 4, "sphere_channels": 64, "attn_hidden_channels": 64,
                          "num_heads": 4, "attn_alpha_channels": 8, "attn_value_channels": 4,
                          "ffn_hidden_channels": 64, "lmax": 2, "mmax": 1, "edge_channels": 64,
                          "num_distance_basis": 64, "max_neighbors": 5,
                          "use_atom_edge_embedding": True, "share_atom_edge_embedding": False,
                          "weight_init": "normal"},
    },
    "dataloaders": {
        "egnn_mc_nbody": _LOADER,
        "painn_nbody": {**_LOADER, "num_neighbors": 4},
        "graph_transformer_nbody": _LOADER,
        "segnn_nbody": {**_LOADER, "num_neighbors": 4},
        "ponita_nbody": {**_LOADER, "num_neighbors": 4},
        "cgenn_nbody": _LOADER,
        "equiformer_v2_nbody": _LOADER,
        "segnn_nbody_offline": {
            "batch_size": 64,
            "offline_dataset": {"dataset_name": "5_0_0", "data_directory": "datasets_offline/data",
                                "frame_0": 30, "frame_T": 40, "cutoff_rate": 0.0},
        },
    },
    "trainers": {
        "trainer_nbody": {
            "com_loss": False, "precision_mode": "single", "matmul_precision": "float32",
            "self_feed_matmul_precision": "float32", "save_checkpoint_params": True,
            "energy_loss": False, "momentum_loss": False, "momentum_loss_weight": 0.0001,
            "learning_rate": 0.5, "learning_rate_factor": 1.0,
            "learning_rate_warmup_steps": 1000, "run_name": None, "save_model_every": 10,
            "steps_per_epoch": 1000, "test_macros_every": 10, "train_steps": None,
        },
    },
}

# Each section's keys: (type, default); "?" allows None.  The JAX package's
# pydantic models, field for field and in their order.
SCHEMA: Dict[str, Dict[str, Tuple[str, Any]]] = {
    "gravity_dataset": {
        "dataset_name": ("str", "nbody_small"), "target": ("str", "pos_dt+vel"),
        "num_atoms": ("int", 5), "sample_freq": ("int", 10), "sim_length": ("int", 10000),
        "noise_var": ("float", 0.0), "interaction_strength": ("float", 2.0),
        "dt": ("float", 0.01), "softening": ("float", 0.2), "vel_norm": ("float", 1e-16),
        "center_of_mass": ("bool", False),
    },
    "offline_dataset": {
        "dataset_name": ("str", "5_0_0"), "data_directory": ("str", "datasets_offline/data"),
        "max_samples": ("int", 1000), "frame_0": ("int", 30), "frame_T": ("int", 40),
        "cutoff_rate": ("float", 0.0), "target": ("str", "pos_dt+vel"),
    },
    "dataloader": {
        "batch_size": ("int", 64), "num_neighbors": ("int?", None),
        "double_precision": ("bool", False), "use_cached": ("bool", True),
        "cache_data": ("bool", True), "seed": ("int?", None),
    },
    "validation": {
        "do_validation": ("bool", False), "split_ratio": ("float", 0.8),
        "validation_frequency": ("int", 1),
    },
    "trainer": {
        "com_loss": ("bool", False), "energy_loss": ("bool", False),
        "momentum_loss": ("bool", False), "momentum_loss_weight": ("float", 0.0001),
        "position_loss_weight": ("float", 1.0), "velocity_loss_weight": ("float", 1.0),
        "force_loss_weight": ("float", 1.0), "per_atom_loss": ("bool", False),
        "precision_mode": ("str", "single"), "learning_rate": ("float", 0.5),
        "learning_rate_factor": ("float", 1.0), "learning_rate_warmup_steps": ("int", 1000),
        "model_path": ("str?", None), "run_name": ("str?", None),
        "save_model_every": ("int", 10), "steps_per_epoch": ("int", 1000),
        "test_macros_every": ("int", 10), "train_steps": ("int?", None), "seed": ("int?", None),
        "clip_gradients_norm": ("float?", None), "clip_gradients_value": ("float?", None),
        "discard_nan_gradients": ("bool", False), "abort_on_nan_activations": ("bool", False),
        "debug_layer_stats_every": ("int?", None), "data_parallel": ("bool", True),
        "self_feed_limit_steps": ("int?", None), "save_trajectory_npys": ("bool", True),
        "plot_macros": ("bool", True), "checkpoint_backend": ("str", "pickle"),
        "matmul_precision": ("str?", None), "self_feed_matmul_precision": ("str?", None),
        "self_feed_train_mode": ("bool", True), "save_checkpoint_params": ("bool", False),
        "profile_epochs": ("int?", None),
    },
}

_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}


def _coerce_field(name: str, value: Any, kind: str) -> Any:
    """``value`` as a field of type ``kind``, as pydantic's lax mode takes it."""
    if kind.endswith("?"):
        if value is None:
            return None
        kind = kind[:-1]
    bad = ValueError(f"config field {name!r}: {value!r} is not a valid {kind}")
    if kind == "str":
        if not isinstance(value, str):
            raise bad
        return value
    if kind == "bool":
        if isinstance(value, bool):
            return value
        if isinstance(value, int) and value in (0, 1):
            return bool(value)
        if isinstance(value, str) and value.lower() in _TRUE | _FALSE:
            return value.lower() in _TRUE
        raise bad
    if kind == "int":
        if isinstance(value, float) and value.is_integer():
            return int(value)
        try:
            if isinstance(value, (int, str)):
                return int(value)
        except ValueError:
            pass
        raise bad
    try:  # float
        if isinstance(value, (int, float, str)):
            return float(value)
    except ValueError:
        pass
    raise bad


def _section(raw: Optional[Dict[str, Any]], kind: str) -> Dict[str, Any]:
    """A section's checked fields in schema order, with the defaults filled in
    and unknown keys dropped."""
    raw = raw or {}
    return {name: _coerce_field(name, raw[name], ftype) if name in raw else copy.deepcopy(default)
            for name, (ftype, default) in SCHEMA[kind].items()}


def _read_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        text = f.read()
    if path.endswith(".json"):
        return json.loads(text) or {}
    try:
        import yaml
    except ImportError:
        try:
            return json.loads(text) or {}  # JSON is YAML too
        except json.JSONDecodeError:
            raise SystemExit(f"{path}: reading YAML needs PyYAML, which is not installed here; "
                             "give the config as JSON") from None
    return yaml.safe_load(text) or {}


def load_config(path: Optional[str] = None) -> Dict[str, Any]:
    """The config at ``path`` (JSON, or YAML where PyYAML imports), or a copy of
    :data:`DEFAULT_CONFIG` when ``path`` is None."""
    return copy.deepcopy(DEFAULT_CONFIG) if path is None else _read_config(path)


def _set_dot(cfg: Dict[str, Any], dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = _coerce(value)


def _coerce(v: Any) -> Any:
    """A command-line token as a bool, None, int, float or string.  Tokens
    with an underscore stay strings (``int('5_0_0') == 500``)."""
    if not isinstance(v, str):
        return v
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none"):
        return None
    if "_" not in v:
        for cast in (int, float):
            try:
                return cast(v)
            except ValueError:
                pass
    return v


def parse_args(argv: Optional[List[str]] = None) -> Tuple[SimpleNamespace, Dict[str, Any]]:
    """``(flat namespace, resolved config dict)`` of ``[--config PATH]
    [--section.key value ...]``.  ``--model.X``, ``--dataloader.X`` and
    ``--trainer.X`` go into the selected model's, dataloader's and trainer's
    section."""
    parser = argparse.ArgumentParser(add_help=True)
    parser.add_argument("--config", default=None)
    known, unknown = parser.parse_known_args(argv)
    if known.config is None:
        cfg = load_config()
    else:
        cfg = _read_config(known.config) if os.path.exists(known.config) else {}
    cfg.setdefault("main", {})

    overrides: List[Tuple[str, Any]] = []
    i = 0
    while i < len(unknown):
        tok = unknown[i]
        if not tok.startswith("--"):
            raise SystemExit(f"Unexpected argument: {tok}")
        key = tok[2:]
        if "=" in key:
            key, val = key.split("=", 1)
            i += 1
        else:
            if i + 1 >= len(unknown):
                raise SystemExit(f"Missing value for --{key}")
            val = unknown[i + 1]
            i += 2
        overrides.append((key, val))

    # first the main.* overrides, which select the sections
    explicit = set()
    for key, val in overrides:
        if key.startswith("main."):
            _set_dot(cfg, key, val)
            explicit.add(key.split(".", 1)[1])
        elif key in ("model_type", "dataloader_type", "trainer_type"):
            _set_dot(cfg, f"main.{key}", val)
            explicit.add(key)
    main = cfg.get("main", {})
    # switching the model re-derives the dataloader unless it is pinned
    if "model_type" in explicit and "dataloader_type" not in explicit:
        main["dataloader_type"] = f"{main['model_type']}_nbody"
    model_type = main.get("model_type", "egnn_mc")
    dataloader_type = main.get("dataloader_type", f"{model_type}_nbody")
    trainer_type = main.get("trainer_type", "trainer_nbody")

    for key, val in overrides:
        if key.startswith("main.") or key in ("model_type", "dataloader_type", "trainer_type"):
            continue
        if key.startswith("model."):
            _set_dot(cfg, f"models.{model_type}.{key[len('model.'):]}", val)
        elif key.startswith("dataloader."):
            _set_dot(cfg, f"dataloaders.{dataloader_type}.{key[len('dataloader.'):]}", val)
        elif key.startswith("trainer."):
            _set_dot(cfg, f"trainers.{trainer_type}.{key[len('trainer.'):]}", val)
        else:
            _set_dot(cfg, key, val)
    return flatten_args(cfg), cfg


def flatten_args(cfg: Dict[str, Any]) -> SimpleNamespace:
    """The selected sections as one flat namespace, field names as the JAX
    package's."""
    cfg = copy.deepcopy(cfg)
    main = cfg.get("main", {})
    model_type = main.get("model_type", "egnn_mc")
    dataloader_type = main.get("dataloader_type", f"{model_type}_nbody")
    trainer_type = main.get("trainer_type", "trainer_nbody")

    model_kwargs = dict(cfg.get("models", {}).get(model_type, {}) or {})
    model_kwargs.pop("class_path", None)

    dl_raw = dict(cfg.get("dataloaders", {}).get(dataloader_type, {}) or {})
    dl_raw.pop("class_path", None)
    dl_raw.pop("model_path", None)
    dl = _section(dl_raw, "dataloader")
    grav = _section(dl_raw.get("gravity_dataset"), "gravity_dataset")
    off = _section(dl_raw.get("offline_dataset"), "offline_dataset")

    tr_raw = dict(cfg.get("trainers", {}).get(trainer_type, {}) or {})
    tr_raw.pop("class_path", None)
    tr = _section(tr_raw, "trainer")
    val = _section(tr_raw.get("validation"), "validation")

    ns = SimpleNamespace(
        model_type=model_type,
        dataloader_type=dataloader_type,
        trainer_type=trainer_type,
        model_kwargs=model_kwargs,
        batch_size=dl["batch_size"],
        num_neighbors=dl["num_neighbors"],
        double_precision=dl["double_precision"],
        use_cached=dl["use_cached"],
        cache_data=dl["cache_data"],
        data_seed=dl["seed"],
        **{k: grav[k] for k in ("dataset_name", "target", "num_atoms", "sample_freq",
                                "sim_length", "noise_var", "interaction_strength", "dt",
                                "softening", "vel_norm", "center_of_mass")},
        **{k: off[k] for k in ("data_directory", "max_samples", "frame_0", "frame_T",
                               "cutoff_rate")},
    )
    if dataloader_type.endswith("_offline"):
        # the offline section owns dataset_name / target for offline runs
        ns.dataset_name = off["dataset_name"]
        ns.target = off["target"]
    for k, v in tr.items():
        setattr(ns, k, v)
    ns.do_validation = val["do_validation"]
    ns.validation_frequency = val["validation_frequency"]
    return ns


# ------------------------------------------------------------ YAML emitter

_PLAIN_KEY = re.compile(r"^[A-Za-z_][A-Za-z0-9_.-]*$")


def _scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        mant, _, exp = text.partition("e")
        if "." not in mant:  # YAML 1.1 reads a float only with a dot
            mant += ".0"
        return mant + ("e" + exp if exp else "")
    if isinstance(v, str):
        return json.dumps(v)  # a double-quoted YAML scalar
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_scalar(x) for x in v) + "]"
    if isinstance(v, dict) and not v:
        return "{}"
    raise TypeError(f"cannot write {type(v).__name__} into the YAML config")


def _key(k: Any) -> str:
    k = str(k)
    return k if _PLAIN_KEY.match(k) and k.lower() not in ("true", "false", "null", "yes",
                                                        "no", "on", "off") else json.dumps(k)


def to_yaml(cfg: Dict[str, Any], indent: int = 0) -> str:
    """``cfg`` (nested dicts of scalars and lists of scalars) in block YAML."""
    lines = []
    pad = "  " * indent
    for k, v in cfg.items():
        if isinstance(v, dict) and v:
            lines.append(f"{pad}{_key(k)}:")
            lines.append(to_yaml(v, indent + 1))
        else:
            lines.append(f"{pad}{_key(k)}: {_scalar(v)}")
    return "\n".join(lines)


def save_config(cfg: Dict[str, Any], run_dir: str) -> None:
    """The resolved config into ``run_dir/config.yaml``."""
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "config.yaml"), "w") as f:
        f.write(to_yaml(cfg) + "\n")


def namespace_to_dict(ns: SimpleNamespace) -> Dict[str, Any]:
    return dict(vars(ns))
