"""Model registry: ``create_model(model_type, **overrides)``.

Counterpart of the JAX package's ``models/__init__.py``; the port knows
``egnn_mc``, ``ponita``, ``segnn`` and ``seconv``, with the JAX package's
defaults for them.  Every model is an ``nn.Module`` with the dense interface
``model(scene, mask) -> [B, N, 3k]``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .egnn_mc import EGNNMC
from .ponita import PONITA
from .segnn import SEGNN, SEConv

MODEL_REGISTRY: Dict[str, Any] = {"egnn_mc": EGNNMC, "ponita": PONITA, "segnn": SEGNN,
                                  "seconv": SEConv}

MODEL_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "egnn_mc": dict(
        num_layers=6,
        hidden_node_dim=128,
        hidden_edge_dim=128,
        hidden_coord_dim=128,
        node_input_dim=2,
        edge_attr_dim=4,
        activation="silu",
        coords_weight=1.0,
        recurrent=True,
        norm_diff=True,
        tanh=True,
    ),
    "ponita": dict(hidden_features=128, num_layers=8),
    "segnn": dict(hidden_features=96, lmax_attr=1, lmax_h=1, num_layers=20),
    "seconv": dict(hidden_features=96, lmax_attr=1, lmax_h=1, num_layers=8),
}


def create_model(model_type: str, device="cuda", dtype=torch.float32, **overrides):
    """Instantiate a registered model on ``device``; ``None`` overrides mean
    "use the default"."""
    if model_type not in MODEL_REGISTRY:
        raise ValueError(f"Unknown model_type '{model_type}'. Known: {sorted(MODEL_REGISTRY)}")
    kwargs = dict(MODEL_DEFAULTS.get(model_type, {}))
    kwargs.update({k: v for k, v in overrides.items() if v is not None})
    return MODEL_REGISTRY[model_type](**kwargs).to(device=device, dtype=dtype)


def has_edge_stage(model) -> bool:
    """Whether ``model`` has an edge stage whose form ``edge_impl`` chooses
    (EGNN-MC's kernel or dense forms); PONITA, SEGNN and SEConv have none."""
    return hasattr(model, "edge_impl")


def count_params(model) -> int:
    """The JAX package's parameter count: every leaf of the model's params tree,
    which is every entry of the ``state_dict`` -- the parameters and, for
    PONITA, the ``calib`` statistics (3 a layer) that its tree carries beside
    them.  SEGNN's Clebsch-Gordan tensors are constants outside the
    ``state_dict``."""
    return sum(t.numel() for t in model.state_dict().values())
