"""Model registry: ``create_model(model_type, **overrides)``.

Counterpart of the JAX package's ``models/__init__.py``; the port knows
``egnn_mc``, ``painn``, ``graph_transformer``, ``ponita``, ``segnn``,
``seconv``, ``cgenn``, ``gmn`` and ``equiformer_v2`` (every family the JAX
package registers), with the JAX package's defaults for them.
Every model is an ``nn.Module`` with the dense interface ``model(scene, mask)
-> [B, N, 3k]``; a model with live dropout (GraphTransformer and
EquiformerV2 in training mode) also takes ``generator=``, a
``torch.Generator`` that draws its masks (:func:`needs_generator`).
"""

from __future__ import annotations

from typing import Any, Dict

from .. import _tf32  # noqa: F401  (TF32 off before torch is used)
import torch

from .cgenn import CGENN
from .egnn_mc import EGNNMC
from .equiformer_v2 import EquiformerV2
from .gmn import GMN
from .graph_transformer import GraphTransformer
from .painn import PaiNN
from .ponita import PONITA
from .segnn import SEGNN, SEConv

MODEL_REGISTRY: Dict[str, Any] = {"egnn_mc": EGNNMC, "painn": PaiNN,
                                  "graph_transformer": GraphTransformer, "ponita": PONITA,
                                  "segnn": SEGNN, "seconv": SEConv, "cgenn": CGENN,
                                  "gmn": GMN, "equiformer_v2": EquiformerV2}

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
    "painn": dict(
        hidden_features=192,
        num_layers=6,
        num_rbf=64,
        cutoff=10.0,
        use_velocity_input=True,
        include_velocity_norm=True,
    ),
    "graph_transformer": dict(hidden_features=96, num_layers=4, num_heads=4),
    "ponita": dict(hidden_features=128, num_layers=8),
    "segnn": dict(hidden_features=96, lmax_attr=1, lmax_h=1, num_layers=20),
    "seconv": dict(hidden_features=96, lmax_attr=1, lmax_h=1, num_layers=8),
    "cgenn": dict(hidden_features=96, num_layers=4),
    "gmn": dict(hidden_features=64, num_layers=4, n_isolated=5, n_stick=0, n_hinge=0),
    "equiformer_v2": dict(
        num_layers=4,
        sphere_channels=64,
        attn_hidden_channels=64,
        num_heads=4,
        attn_alpha_channels=8,
        attn_value_channels=4,
        ffn_hidden_channels=64,
        edge_channels=64,
        num_distance_basis=64,
        max_neighbors=5,
        max_radius=4096.0,
        use_atom_edge_embedding=True,
        share_atom_edge_embedding=False,
        weight_init="normal",
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


def has_edge_stage(model) -> bool:
    """Whether ``model`` has an edge stage whose form ``edge_impl`` chooses
    (EGNN-MC's kernel or dense forms); no other family has one."""
    return hasattr(model, "edge_impl")


def needs_generator(model) -> bool:
    """Whether ``model`` draws dropout masks in its forward now (and so takes
    ``generator=``): GraphTransformer or EquiformerV2 in training mode with a
    rate above 0."""
    return bool(getattr(model, "draws_dropout", False))


def generator_kwargs(model, seed, device) -> Dict[str, Any]:
    """``{"generator": a torch.Generator on device seeded with seed}`` for a
    model that draws dropout masks now, else ``{}``; ``seed`` None is 0, as
    the JAX package's rollout takes ``PRNGKey(0)`` without a key."""
    if not needs_generator(model):
        return {}
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(0 if seed is None else int(seed))
    return {"generator": gen}


def count_params(model) -> int:
    """The JAX package's parameter count: every leaf of the model's params tree,
    which is every entry of the ``state_dict`` -- the parameters and, for
    PONITA, the ``calib`` statistics (3 a layer) that its tree carries beside
    them.  SEGNN's Clebsch-Gordan tensors and EquiformerV2's Wigner tensor,
    grid matrices and index tables are constants outside the ``state_dict``."""
    return sum(t.numel() for t in model.state_dict().values())
