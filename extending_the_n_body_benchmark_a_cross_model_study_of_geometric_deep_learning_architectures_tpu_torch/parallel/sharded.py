"""Multi-GPU datagen, rollout and training over the ``(sim, body)`` mesh:
counterpart of the JAX package's ``parallel/sharded.py``.

There ``jit`` with ``NamedSharding`` places the arrays and XLA inserts the
collectives; here every rank holds its rows and the collectives are written
out (``mesh.py``):

* :func:`sharded_datagen` -- every rank draws the whole batch's initial
  states from the same generator and integrates only its sims (on the card,
  one K2-leapfrog launch, a thread-block cluster a sim, which sums each sim
  alike at any batch size), so its rows are bitwise the single-process
  batch's on the card (on the CPU the plain integrator's sums follow the
  batch's shape: a few ulps);
* :func:`make_sharded_rollout_fn` -- each rank rolls out its sims through
  ``rollout.self_feed.make_rollout_fn`` (kernel K1 on the card), then the
  trajectories and ``survived`` are gathered (``all_gather``);
* :func:`make_body_ring_rollout_fn` -- the bodies of each sim over the
  ``body`` axis through ``EGNNMC(body_ring=True)`` (``ring_egnn.py``); a sim
  whose next state diverges on any body shard freezes on all of them;
* :func:`make_sharded_train_step` -- each rank's loss is the mean over its
  sims, and one ``all_reduce`` averages the gradients (with the metric
  vector and the non-finite flag), which equals the global batch's gradient
  since every loss term of ``train/losses.py`` is a mean over sims; the
  clipping, the skip of a non-finite update and AdamW + Noam then run on
  the same numbers on every rank.  With ``shard_bodies`` (the JAX package's
  ``shard_bodies=True``, which GSPMD partitions there) each rank holds its
  sims' block of bodies: EGNN-MC computes its receivers' rows against every
  sender, and every other family trains on its sims gathered whole (see
  the function).
"""

from __future__ import annotations

from typing import List, Optional

import torch

import torch.distributed as dist

from ..core import graph as G
from ..core.physics import GravityParams, sample_initial_conditions, simulate
from ..core.scene import Scene
from ..core.targets import decode_next_state
from .mesh import (BODY_AXIS, SIM_AXIS, all_gather_rows, all_gather_rows_grad, axis_group,
                   axis_rows, axis_size, local_rows, psum)


def shard_scene(scene: Scene, mesh, shard_bodies: bool = False) -> Scene:
    """This rank's rows of a scene: its sims and, with ``shard_bodies``, its bodies."""
    return Scene(*(local_rows(x, mesh, shard_bodies)
                   for x in (scene.pos, scene.vel, scene.force, scene.mass, scene.charge)))


def sharded_datagen(generator: torch.Generator, mesh, batch_size: int, n_bodies: int,
                    T: int = 10000, sample_freq: int = 10,
                    params: GravityParams = GravityParams(), dtype=torch.float32,
                    device="cuda"):
    """This rank's sims of a GT batch: ``loc, vel, force [B/S, T // sample_freq,
    N, 3]`` and ``mass [B/S, N, 1]``, the rows of
    ``core.physics.sample_trajectory_batch(batch_size, ...)`` from the same
    generator state (the initial states and observation noise drawn for the
    whole batch; the frames bitwise on the card)."""
    pos, vel, mass = sample_initial_conditions(batch_size, n_bodies, 3, dtype, device, generator)
    rows = axis_rows(batch_size, mesh, SIM_AXIS)
    loc_s, vel_s, force_s = simulate(pos[rows], vel[rows], mass[rows], T, sample_freq,
                                     params._replace(noise_var=0.0))
    if params.noise_var:
        for arr in (loc_s, vel_s, force_s):
            noise = torch.randn((batch_size, *arr.shape[1:]), dtype=arr.dtype,
                                device=arr.device, generator=generator)
            arr += noise[rows] * params.noise_var
    return loc_s, vel_s, force_s, mass[rows]


def make_sharded_rollout_fn(model, num_steps: int, mesh, num_neighbors: Optional[int] = None,
                            target: str = "pos_dt+vel"):
    """``fn(scene0, rng=None) -> (loc, vel, survived)`` for the whole batch: each
    rank rolls out its sims of ``scene0`` (the whole batch, which every rank
    holds), and the ``sim`` group gathers them back."""
    from ..rollout.self_feed import make_rollout_fn

    inner = make_rollout_fn(model, num_steps, num_neighbors, target)
    group = axis_group(mesh, SIM_AXIS)

    def rollout(scene0: Scene, rng=None):
        parts = inner(shard_scene(scene0, mesh), rng)
        return tuple(all_gather_rows(t, group) for t in parts)

    return rollout


def make_body_ring_rollout_fn(model, num_steps: int, mesh, target: str = "pos_dt+vel",
                              explosion_threshold: float = 1e9):
    """Self-feed rollout with the bodies over the mesh's ``body`` axis (and the
    sims over ``sim``): ``fn(scene0) -> (loc, vel, survived)`` for this rank's
    block, ``loc, vel [B/S, num_steps, N/D, 3]`` and ``survived [B/S]``.
    ``scene0`` is the whole batch, which every rank holds.

    ``model`` is an ``EGNNMC(body_ring=True)``; every ``[B, N, N, *]`` edge
    tensor is a ``[B/S, N/D, N/D, *]`` block.  Semantics are
    ``rollout.self_feed.make_rollout_fn``'s: the first call sees the frame-0
    force, every later call zeros; a sim whose next state passes
    ``explosion_threshold`` or is not finite on any body shard (a ``psum``
    over ``body``) freezes on all of them, and ``survived`` counts its
    unfrozen steps."""
    body = axis_group(mesh, BODY_AXIS)
    d = axis_size(mesh, BODY_AXIS)

    @torch.no_grad()
    def rollout(scene0: Scene):
        s = shard_scene(scene0, mesh, shard_bodies=True)
        B, n = s.pos.shape[:2]
        loc = torch.empty((B, num_steps, n, 3), dtype=s.pos.dtype, device=s.pos.device)
        vel = torch.empty_like(loc)
        loc[:, 0], vel[:, 0] = s.pos, s.vel
        frozen = torch.zeros(B, dtype=torch.bool, device=s.pos.device)
        survived = torch.zeros(B, dtype=torch.int32, device=s.pos.device)
        pos, v, force = s.pos, s.vel, s.force
        zero_force = torch.zeros_like(s.pos)
        for t in range(1, num_steps):
            out = model(Scene(pos=pos, vel=v, force=force, mass=s.mass), None, ring=body)
            new_pos, new_vel = decode_next_state(out, pos, v, target)
            bad = torch.any((torch.abs(new_pos) > explosion_threshold)
                            | ~torch.isfinite(new_pos) | ~torch.isfinite(new_vel), dim=(1, 2))
            if d > 1:
                bad = psum(bad.to(torch.int32), body) > 0
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


def average_step(params: List[torch.nn.Parameter], vec: torch.Tensor,
                 ok: Optional[torch.Tensor], group, grad_divisor: Optional[int] = None):
    """One ``all_reduce`` over ``group`` of every gradient, the step's metric
    vector and its non-finite flag: the gradients (in place) and the vector
    become their means over the ranks, ``ok`` true only where every rank's
    prediction was finite.  ``grad_divisor`` divides the summed gradients in
    place of the group's size (the body-sharded step's sims: each rank's
    gradient is its receivers' share, summed over ``body``).  Returns
    ``(vec, ok)``."""
    grads = [p.grad for p in params if p.grad is not None]
    dtype = grads[0].dtype
    if any(g.dtype != dtype for g in grads):
        raise ValueError("the gradients of a data-parallel step must share one dtype")
    parts = [g.reshape(-1) for g in grads] + [vec.to(dtype)]
    if ok is not None:
        parts.append((~ok).to(dtype).reshape(1))
    flat = psum(torch.cat(parts), group)
    k = torch.distributed.get_world_size(group)
    kg = k if grad_divisor is None else grad_divisor
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].view_as(g) / kg)
        at += g.numel()
    vec_mean = (flat[at:at + vec.numel()] / k).to(vec.dtype)
    return vec_mean, (None if ok is None else flat[-1] == 0)


def _whole_sims(mesh):
    """``fn(x)``: a ``[B/S, N/D, ...]`` tensor (or a scene of them) gathered over
    ``body`` to its sims' every body (no gradient); None stays None."""
    body = axis_group(mesh, BODY_AXIS)

    def whole(x):
        if isinstance(x, Scene):
            return Scene(*(whole(t) for t in (x.pos, x.vel, x.force, x.mass, x.charge)))
        return None if x is None else all_gather_rows(x, body, dim=1)

    return whole


def _receiver_rows(model, num_neighbors: int, mesh):
    """EGNN-MC's body-sharded forward for ``make_train_step(..., forward=)``:
    ``(scene, y) -> (pred, scene, y)`` of the whole sims from this rank's
    rows.  The mask is this rank's rows of ``knn_mask`` of the gathered
    positions (``knn_mask(..., rows)``: each row's distances and top-k are
    the whole mask's); the model runs its receiver
    rows (``[B/S, N/D, N, *]`` edge tensors) against every sender, the
    senders' ``hB`` and coordinates gathered under autograd (their gradient
    summed over ``body``); the prediction is gathered so that the loss is the
    whole sims', its gradient each rank's own rows."""
    from ..models.egnn_mc import Senders

    body = axis_group(mesh, BODY_AXIS)
    whole = _whole_sims(mesh)

    def gather(t):
        return all_gather_rows_grad(t, body, dim=1)

    def forward(scene: Scene, y: torch.Tensor):
        every = whole(scene)
        rows = axis_rows(every.pos.shape[1], mesh, BODY_AXIS)
        mask = G.knn_mask(every.pos, num_neighbors, rows)
        pred = model(scene, mask, edge_impl="dense", senders=Senders(every, gather))
        return all_gather_rows_grad(pred, body, dim=1, sum_grads=False), every, whole(y)

    return forward


def make_sharded_train_step(model, optim, loss_fn, targets, num_neighbors: int, mesh,
                            dtype: torch.dtype, shard_bodies: bool = False, **kwargs):
    """``train.trainer.make_train_step`` over the mesh: ``(step, metric_names)``,
    where ``step(scene, y, mask=None)`` takes this rank's rows and returns the
    global batch's metric vector.  The gradients (with the metric vector and
    the non-finite flag) are averaged over the ``sim`` axis.

    ``shard_bodies``: the rows are this rank's sims' block of bodies, ``[B/S,
    N/D, *]``, and the step is the JAX package's ``shard_bodies=True`` one:
    the dense model on ``knn_mask(pos, num_neighbors)`` of the whole sims,
    the loss on the whole sims, no data mask.

    * EGNN-MC (dense edge stage, no ``body_ring``) runs its receiver rows
      against every sender (:func:`_receiver_rows`): no rank holds a ``[B,
      N, N, *]`` tensor, only ``[B/S, N/D, N, *]`` rows (the mask's too).
      Every ``body`` rank of a sim
      holds the same loss and a share of the gradient, so one ``all_reduce``
      over the mesh sums the gradients over ``body`` and divides by the
      ``sim`` size (the metric vector and the flag by the mesh's size).
    * Every other family gathers its sims whole over ``body`` and runs the
      data-parallel step on them, averaged over the whole mesh (each ``body``
      rank of a sim computes the same gradient).  This shards no memory: a
      rank holds its sims' every edge.  A model with live dropout must get
      generators in the same state on the ``body`` ranks of a sim.
    """
    from ..models import has_edge_stage
    from ..train.trainer import make_train_step

    if not shard_bodies:
        return make_train_step(model, optim, loss_fn, targets, num_neighbors, dtype,
                               group=axis_group(mesh, SIM_AXIS), **kwargs)
    if has_edge_stage(model):
        inner, names = make_train_step(
            model, optim, loss_fn, targets, num_neighbors, dtype, group=dist.group.WORLD,
            forward=_receiver_rows(model, num_neighbors, mesh),
            grad_divisor=axis_size(mesh, SIM_AXIS), **kwargs)
    else:
        gathered, names = make_train_step(model, optim, loss_fn, targets, num_neighbors,
                                          dtype, group=dist.group.WORLD, **kwargs)
        whole = _whole_sims(mesh)

        def inner(scene, y):
            return gathered(whole(scene), whole(y))

    def step(scene: Scene, y: torch.Tensor, mask: Optional[torch.Tensor] = None):
        if mask is not None:
            raise ValueError("the body-sharded step trains on the kNN mask of the whole sims "
                             "(no data mask), as the JAX package's shard_bodies step does")
        return inner(scene, y)

    return step, names
