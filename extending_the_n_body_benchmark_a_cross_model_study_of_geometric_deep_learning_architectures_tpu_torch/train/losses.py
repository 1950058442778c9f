"""Training losses: counterpart of the JAX package's ``train/losses.py``.

All losses take ``(pred [B,N,3k], scene, y [B,N,3k])`` and return a scalar
tensor; an MSE means over every element.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

from .. import _tf32  # noqa: F401  (TF32 off before torch is used)
import torch

from ..core.physics import energies
from ..core.scene import Scene
from ..core.targets import decode_next_state


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return torch.mean(d * d)


def target_common_loss(
    pred: torch.Tensor,
    scene: Scene,
    y: torch.Tensor,
    targets: Sequence[str],
    weights: Dict[str, float],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted MSE of each 3-wide target slice.  A target starting with
    ``pos`` (``pos_com`` too) takes the position weight, ``vel``/``vel_dt``
    the velocity weight, anything else the force weight."""
    total = 0.0
    terms: Dict[str, torch.Tensor] = {}
    for i, t in enumerate(targets):
        sl = mse(pred[..., 3 * i : 3 * (i + 1)], y[..., 3 * i : 3 * (i + 1)])
        if t.startswith("pos"):
            w, name = weights.get("position", 1.0), "Position loss"
        elif t in ("vel", "vel_dt"):
            w, name = weights.get("velocity", 1.0), "Velocity loss"
        else:
            w, name = weights.get("force", 1.0), "Force loss"
        terms[name] = w * sl
        total = total + w * sl
    return total, terms


def centre_of_mass_loss(pred, scene: Scene, y, weight: float = 1.0,
                        target: str = "pos_dt+vel"):
    """MSE between the predicted and the true next centres of mass, with the
    next positions decoded per the target spec."""
    pos_pred, _ = decode_next_state(pred, scene.pos, scene.vel, target)
    pos_true, _ = decode_next_state(y, scene.pos, scene.vel, target)
    return weight * mse(torch.mean(pos_pred, dim=1), torch.mean(pos_true, dim=1))


def momentum_loss(pred, scene: Scene, y, weight: float = 0.0001,
                  target: str = "pos_dt+vel"):
    """MSE between the predicted total momentum and the current one, per sim."""
    _, vel_pred = decode_next_state(pred, scene.pos, scene.vel, target)
    mom_cur = torch.sum(scene.mass * scene.vel, dim=1)  # [B, 3]
    mom_pred = torch.sum(scene.mass * vel_pred, dim=1)
    return weight * mse(mom_pred, mom_cur)


def energy_loss(pred, scene: Scene, y, G: float, softening: float,
                weight: float = 1.0, target: str = "pos_dt+vel"):
    """MSE between the total energies of the predicted and the target next states."""
    pos_pred, vel_pred = decode_next_state(pred, scene.pos, scene.vel, target)
    pos_true, vel_true = decode_next_state(y, scene.pos, scene.vel, target)
    _, _, te_pred = energies(pos_pred, vel_pred, scene.mass, G, softening)
    _, _, te_true = energies(pos_true, vel_true, scene.mass, G, softening)
    return weight * mse(te_pred, te_true)


def build_loss_fn(args) -> Callable:
    """The loss stack of a flat config namespace: ``loss_fn(pred, scene, y) ->
    (total, terms)``.  Refuses at build time what it cannot compute."""
    targets = args.target.split("+")
    weights = {
        "position": getattr(args, "position_loss_weight", 1.0),
        "velocity": getattr(args, "velocity_loss_weight", 1.0),
        "force": getattr(args, "force_loss_weight", 1.0),
    }
    use_com = getattr(args, "com_loss", False)
    use_energy = getattr(args, "energy_loss", False)
    use_momentum = getattr(args, "momentum_loss", False)
    momentum_w = getattr(args, "momentum_loss_weight", 0.0001)
    G = getattr(args, "interaction_strength", 2.0)
    soft = getattr(args, "softening", 0.2)

    # momentum / energy read pred[..., 3:6] as a velocity
    if (use_energy or use_momentum) and len(targets) < 2:
        raise ValueError(
            f"energy_loss/momentum_loss need a velocity component in the "
            f"prediction (target={args.target!r} has only {targets})"
        )
    if use_com and args.target == "force":
        raise ValueError("com_loss is undefined for target='force' "
                         "(the prediction encodes no position state)")
    target_spec = args.target

    def loss_fn(pred, scene, y):
        total, terms = target_common_loss(pred, scene, y, targets, weights)
        terms["Total target loss"] = total
        if use_com:
            l = centre_of_mass_loss(pred, scene, y, target=target_spec)
            terms["Centre of mass loss"] = l
            total = total + l
        if use_energy:
            l = energy_loss(pred, scene, y, G, soft, target=target_spec)
            terms["Energy loss"] = l
            total = total + l
        if use_momentum:
            l = momentum_loss(pred, scene, y, momentum_w, target=target_spec)
            terms["Momentum loss"] = l
            total = total + l
        return total, terms

    return loss_fn


def dynamic_weighted_loss_init(device="cuda", dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Initial EMA state: both running losses start at 1 (in torch's default
    float dtype unless ``dtype`` is given)."""
    one = torch.tensor(1.0, device=device, dtype=dtype)
    return one, one.clone()


def dynamic_weighted_loss(
    pred: torch.Tensor,
    y: torch.Tensor,
    state: Tuple[torch.Tensor, torch.Tensor],
    alpha: float = 0.99,
):
    """EMA-balanced position / velocity MSE with explicit state: each term is
    weighted by the other's share of the running loss, so the slower term gets
    more weight.  Returns ``(loss, new_state)``."""
    run_pos, run_vel = state
    loss_pos = mse(pred[..., :3], y[..., :3])
    loss_vel = mse(pred[..., 3:6], y[..., 3:6])
    new_pos = alpha * run_pos + (1 - alpha) * loss_pos.detach()
    new_vel = alpha * run_vel + (1 - alpha) * loss_vel.detach()
    total_run = new_pos + new_vel
    loss = (new_vel / total_run) * loss_pos + (new_pos / total_run) * loss_vel
    return loss, (new_pos, new_vel)


def percentage_errors(pred, y, targets: List[str]) -> Dict[str, torch.Tensor]:
    """Per-target relative L2 error, in percent."""
    out = {}
    for i, t in enumerate(targets):
        err = pred[..., 3 * i : 3 * (i + 1)] - y[..., 3 * i : 3 * (i + 1)]
        err_l2 = torch.linalg.vector_norm(err, dim=-1)
        tgt_l2 = torch.linalg.vector_norm(y[..., 3 * i : 3 * (i + 1)], dim=-1)
        out[f"{t}_perc_error"] = torch.mean(err_l2 / (tgt_l2 + 1e-12)) * 100.0
    return out
