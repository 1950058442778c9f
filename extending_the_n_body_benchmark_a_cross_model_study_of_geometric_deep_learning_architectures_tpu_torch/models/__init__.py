"""Model registry: ``create_model(model_type, **overrides)``.

Counterpart of the JAX package's ``models/__init__.py``; this slice knows
``egnn_mc`` only, with the JAX package's defaults for it.  Every model is an
``nn.Module`` with the dense interface ``model(scene, mask) -> [B, N, 3k]``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .egnn_mc import EGNNMC

MODEL_REGISTRY: Dict[str, Any] = {"egnn_mc": EGNNMC}

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
}


def create_model(model_type: str, device="cuda", dtype=torch.float32, **overrides):
    """Instantiate a registered model on ``device``; ``None`` overrides mean
    "use the default"."""
    if model_type not in MODEL_REGISTRY:
        raise ValueError(f"Unknown model_type '{model_type}'. Known: {sorted(MODEL_REGISTRY)}")
    kwargs = dict(MODEL_DEFAULTS.get(model_type, {}))
    kwargs.update({k: v for k, v in overrides.items() if v is not None})
    return MODEL_REGISTRY[model_type](**kwargs).to(device=device, dtype=dtype)
