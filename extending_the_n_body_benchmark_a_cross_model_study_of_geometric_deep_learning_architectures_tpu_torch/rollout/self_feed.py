"""Self-feed rollout: the model eats its own predictions.

Counterpart of the JAX package's ``rollout/self_feed.py``.  There the whole
rollout is one jitted ``lax.scan``; here it is a plain Python loop over steps
whose every step is a handful of asynchronous launches, so the host does not
wait on the device inside the loop.  Semantics kept:

* ``num_steps`` saved frames, i.e. ``num_steps - 1`` model calls;
* the first call sees the ground-truth frame-0 force, every later call zeros
  (the force is never predicted);
* a sim whose next state has ``|pos| > 1e9`` or a non-finite value freezes:
  its state stops updating, and ``survived [B]`` counts its unfrozen steps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core import graph as G
from ..core.scene import Scene
from ..core.targets import decode_next_state

EXPLOSION_THRESHOLD = 1e9


def make_rollout_fn(
    model,
    num_steps: int,
    num_neighbors: Optional[int] = None,
    target: str = "pos_dt+vel",
    explosion_threshold: float = EXPLOSION_THRESHOLD,
):
    """Build ``fn(scene0) -> (loc, vel, survived)``.

    ``loc, vel [B, num_steps, N, 3]`` (frame 0 = ``scene0``), ``survived [B]``
    int32.  ``num_neighbors=None`` means fully connected.
    """
    if target in ("pos", "force"):
        raise ValueError(
            f"target {target!r} is not self-feedable: the model predicts no "
            "velocity channel to close the loop with"
        )

    @torch.no_grad()
    def rollout(scene0: Scene):
        B, n = scene0.pos.shape[:2]
        k = num_neighbors if (num_neighbors and 0 < num_neighbors < n) else n - 1
        loc = torch.empty((B, num_steps, n, 3), dtype=scene0.dtype, device=scene0.device)
        vel = torch.empty_like(loc)
        loc[:, 0] = scene0.pos
        vel[:, 0] = scene0.vel
        frozen = torch.zeros(B, dtype=torch.bool, device=scene0.device)
        survived = torch.zeros(B, dtype=torch.int32, device=scene0.device)
        pos, v, force = scene0.pos, scene0.vel, scene0.force
        zero_force = torch.zeros_like(scene0.pos)
        for t in range(1, num_steps):
            mask = G.knn_mask(pos, k)
            out = model(Scene(pos=pos, vel=v, force=force, mass=scene0.mass), mask)
            new_pos, new_vel = decode_next_state(out, pos, v, target)
            bad = torch.any(
                (torch.abs(new_pos) > explosion_threshold)
                | ~torch.isfinite(new_pos)
                | ~torch.isfinite(new_vel),
                dim=(1, 2),
            )
            frozen = frozen | bad
            keep = frozen[:, None, None]
            pos = torch.where(keep, pos, new_pos)
            v = torch.where(keep, v, new_vel)
            force = zero_force
            survived += (~frozen).to(torch.int32)
            loc[:, t] = pos
            vel[:, t] = v
        return loc, vel, survived

    return rollout


def run_self_feed(
    model,
    dataset,
    num_steps: Optional[int] = None,
    num_neighbors: Optional[int] = None,
    batch_size: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Checkpoint evaluation against fresh ground truth: draw GT trajectories,
    seed the model with frame 0 and roll forward.

    Returns ``(loc_actual, vel_actual, loc_pred, vel_pred, steps_survived)``
    with ``[B, T, N, 3]`` tensors and the minimum over sims of ``survived``.
    """
    loc_gt, vel_gt, force_gt, mass = dataset.get_ground_truth_trajectories(batch_size)
    T = int(loc_gt.shape[1])
    if num_steps is not None and 0 < num_steps < T:
        T = num_steps
        loc_gt, vel_gt = loc_gt[:, :T], vel_gt[:, :T]
    scene0 = Scene(pos=loc_gt[:, 0], vel=vel_gt[:, 0], force=force_gt[:, 0], mass=mass)
    fn = make_rollout_fn(model, T, num_neighbors=num_neighbors, target=dataset.target)
    loc_pred, vel_pred, survived = fn(scene0)
    return loc_gt, vel_gt, loc_pred, vel_pred, int(survived.min())
