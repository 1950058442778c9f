"""Target-spec semantics shared by rollout (and, later, the losses).

Counterpart of the JAX package's ``core/targets.py``: the six target specs and
the one decode every consumer agrees on.
"""

from __future__ import annotations

from typing import Optional, Tuple

from .. import _tf32  # noqa: F401  (TF32 off before torch is used)
import torch

TARGETS = ("pos", "force", "pos_dt+vel_dt", "pos_dt+vel", "pos+vel", "pos_com+vel")

#: targets that encode a (next_pos, next_vel) pair and can close a self-feed loop
SELF_FEEDABLE = tuple(t for t in TARGETS if t not in ("pos", "force"))


def decode_next_state(
    arr: torch.Tensor, pos: torch.Tensor, vel: torch.Tensor, target: str
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Decode ``arr [..., N, 3|6]`` into the absolute next ``(pos, vel)`` it
    encodes under ``target``; ``pos``/``vel`` are the current state.

    ``next_vel`` is None for a 3-dim array; ``force`` encodes no next state.
    """
    if target == "force":
        raise ValueError("target 'force' does not encode a next state")
    p = arr[..., :3]
    if target.startswith("pos_dt"):
        next_pos = pos + p
    elif target.startswith("pos_com"):
        # relative to the input frame's unweighted centre of mass
        next_pos = p + torch.mean(pos, dim=-2, keepdim=True)
    else:
        next_pos = p
    if arr.shape[-1] < 6:
        return next_pos, None
    v = arr[..., 3:6]
    next_vel = vel + v if target.endswith("vel_dt") else v
    return next_pos, next_vel
