"""Process groups, the ``(sim, body)`` device mesh, row slicing and the
collectives of the multi-GPU paths.

Counterpart of the JAX package's ``parallel/mesh.py``.  There one process
drives every chip and XLA inserts the collectives; here each rank is a
process (launched by ``torchrun``, or spawned), a
``torch.distributed.device_mesh.DeviceMesh`` with dims ``("sim", "body")``
takes the place of ``jax.sharding.Mesh``, and the collectives are explicit:

* ``sim`` -- the batch of independent simulations (data parallel);
* ``body`` -- the bodies of a simulation, for the ring of ``ring.py`` and
  ``ring_egnn.py``.

The training step through the body-sharded paths differentiates two of
them: :func:`ring_shift_grad` (the ring's pass; its backward the reverse
pass) and :func:`all_gather_rows_grad` (the senders' rows gathered; its
backward a reduce-scatter, or the rank's own slice).  Both are written over
the collectives here, so under gloo they too hand the backend host copies
(``torch.distributed.nn``'s gather runs ``all_to_all`` in its backward off
NCCL, and takes the card's tensors).

``scene_sharding`` and ``replicate`` have no torch object: a rank holds its
rows (:func:`local_rows`), and a tensor every rank holds whole is broadcast
from the group's first rank (:func:`replicate`).

**Backends.**  NCCL takes the card's tensors; gloo moves host memory, so under
gloo every collective here hands it host copies of CUDA tensors and copies
the result back.  The backend of the group decides, never a failure.  Ranks
that outnumber the visible cards are allowed only under gloo (several ranks
then share a card); under NCCL they raise before any work.
"""

from __future__ import annotations

import os
import warnings
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

SIM_AXIS = "sim"
BODY_AXIS = "body"

# the launcher's variables, in the order they are read: torchrun's, SLURM's, Open MPI's
_RANK_VARS = ("RANK", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK")
_WORLD_VARS = ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE")
_LOCAL_RANK_VARS = ("LOCAL_RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK")


def _env_int(names: Sequence[str]) -> Optional[int]:
    for name in names:
        value = os.environ.get(name, "").strip()
        if value:
            return int(value)
    return None


def launcher_env() -> bool:
    """True when a launcher's variables ask for more than one process
    (``WORLD_SIZE``, ``SLURM_NTASKS`` or ``OMPI_COMM_WORLD_SIZE`` above 1, or a
    ``MASTER_ADDR``): the markers :func:`initialize_distributed` reads."""
    return bool(os.environ.get("MASTER_ADDR")) or any(
        os.environ.get(name, "").strip() not in ("", "0", "1") for name in _WORLD_VARS)


def local_rank() -> int:
    """This process's rank on its host (0 without a launcher)."""
    value = _env_int(_LOCAL_RANK_VARS)
    return 0 if value is None else value


def check_cards(backend: str) -> None:
    """Under NCCL a rank needs a card of its own: raise when this rank's local
    index has none.  Gloo ranks may share a card."""
    if backend == "nccl" and local_rank() >= torch.cuda.device_count():
        raise ValueError(
            f"local rank {local_rank()} under NCCL, but {torch.cuda.device_count()} card(s) are "
            "visible: NCCL puts one rank on a card (ranks may share a card only under gloo)")


def initialize_distributed(**kwargs) -> bool:
    """``torch.distributed.init_process_group`` from the launcher's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; SLURM's and
    Open MPI's rank and size where torchrun's are absent).  Keyword arguments
    (``backend=``, ``timeout=``, ``init_method=``, ...) pass through; the
    backend defaults to NCCL where a card is visible, else gloo.  True when a
    group is up (also one set up before).

    A single-process run goes on alone (a warning, False) where the init
    fails; a failed init under a multi-process marker (a world size above 1 in
    the arguments or the environment, an ``init_method`` or a ``MASTER_ADDR``)
    raises, or training would silently go on with one process's share."""
    if dist.is_initialized():
        return True
    multi = (int(kwargs.get("world_size", 0) or 0) > 1 or bool(kwargs.get("init_method"))
             or launcher_env())
    backend = kwargs.setdefault("backend", "nccl" if torch.cuda.is_available() else "gloo")
    rank, world = _env_int(_RANK_VARS), _env_int(_WORLD_VARS)
    if world is not None and rank is not None:
        kwargs.setdefault("world_size", world)
        kwargs.setdefault("rank", rank)
    check_cards(backend)
    try:
        dist.init_process_group(**kwargs)
    except (RuntimeError, ValueError, KeyError, OSError) as e:
        if multi:
            raise
        warnings.warn(f"torch.distributed.init_process_group skipped: {e!r}")
        return False
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    return True


def make_mesh(n_devices: Optional[int] = None, body_parallel: int = 1):
    """A ``DeviceMesh`` of shape ``(world // body_parallel, body_parallel)`` over
    every rank, dims ``("sim", "body")``.  Raises when no group is up, when
    ``n_devices`` is not the number of ranks up, or when the world does not
    divide by ``body_parallel``."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise ValueError("no process group is up: call initialize_distributed() first "
                         "(or launch with torchrun)")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"requested a {n_devices}-rank mesh but {world} rank(s) are up: "
                         "a mesh spans every rank of the group")
    if body_parallel < 1 or world % body_parallel:
        raise ValueError(f"{world} ranks not divisible by body_parallel={body_parallel}")
    backend = dist.get_backend()
    check_cards(backend)
    return init_device_mesh("cuda" if backend == "nccl" else "cpu",
                            (world // body_parallel, body_parallel),
                            mesh_dim_names=(SIM_AXIS, BODY_AXIS))


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_group(mesh, axis: str):
    return mesh.get_group(mesh_dim=axis)


def axis_rows(n: int, mesh, axis: str) -> slice:
    """This rank's share of ``n`` rows split over ``axis``."""
    size, r = axis_size(mesh, axis), mesh.get_local_rank(mesh_dim=axis)
    if n % size:
        raise ValueError(f"{n} rows do not split over the {axis!r} axis of {size} ranks")
    k = n // size
    return slice(r * k, (r + 1) * k)


def local_rows(x: Optional[torch.Tensor], mesh, shard_bodies: bool = False):
    """This rank's rows of a ``[B, N, ...]`` tensor: its sims over ``sim`` and,
    with ``shard_bodies``, its bodies over ``body`` (the JAX package's
    ``scene_sharding``).  None stays None."""
    if x is None:
        return None
    x = x[axis_rows(x.shape[0], mesh, SIM_AXIS)]
    if shard_bodies:
        x = x[:, axis_rows(x.shape[1], mesh, BODY_AXIS)]
    return x


# ------------------------------------------------------------- collectives

def on_host(group=None) -> bool:
    """True when ``group``'s backend moves host memory (gloo)."""
    return dist.get_backend(group) == "gloo"


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """A contiguous buffer of ``t`` that the group's backend takes and the
    collective may overwrite: a host copy under gloo, a copy on the card
    under NCCL."""
    if on_host(group) and t.device.type != "cpu":
        return t.detach().to("cpu", copy=True).contiguous()
    return t.detach().clone().contiguous()


def psum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the group's ranks (``all_reduce``; the JAX
    package's ``lax.psum``), on ``t``'s device."""
    buf = _wire(t, group)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device)


def ring_shift(tensors: Sequence[torch.Tensor], group=None,
               reverse: bool = False) -> List[torch.Tensor]:
    """Each rank sends ``tensors`` to the next rank of the group and receives
    the previous rank's (``batch_isend_irecv``; the JAX package's
    ``lax.ppermute`` with ``j -> j + 1``); ``reverse`` sends to the previous
    rank and receives the next one's.  A group of one returns them as they
    are."""
    size = dist.get_world_size(group)
    if size == 1:
        return list(tensors)
    r, step = dist.get_rank(group), -1 if reverse else 1

    def peer(k: int) -> int:
        return dist.get_global_rank(group, k % size) if group is not None else k % size

    nxt, prv = peer(r + step), peer(r - step)
    sends = [_wire(t, group) for t in tensors]
    recvs = [torch.empty_like(s) for s in sends]
    ops = ([dist.P2POp(dist.isend, s, nxt, group) for s in sends]
           + [dist.P2POp(dist.irecv, b, prv, group) for b in recvs])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [b.to(t.device) for b, t in zip(recvs, tensors)]


def all_gather_rows(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The group's shards of ``t`` concatenated along ``dim`` in rank order
    (``all_gather``): a sharded tensor gathered back, on ``t``'s device."""
    size = dist.get_world_size(group)
    if size == 1:
        return t
    buf = _wire(t, group)
    parts = [torch.empty_like(buf) for _ in range(size)]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


# ------------------------------------------------ collectives under autograd

class _RingShift(torch.autograd.Function):
    """:func:`ring_shift` whose backward is the reverse shift: each received
    tensor's gradient goes back to the rank that sent it."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(ring_shift(tensors, group))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ring_shift(grads, ctx.group, reverse=True))


def ring_shift_grad(tensors: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """:func:`ring_shift` under autograd (the JAX package's ``lax.ppermute``,
    which JAX transposes to the reverse permutation)."""
    if dist.get_world_size(group) == 1:
        return list(tensors)
    return list(_RingShift.apply(group, *tensors))


class _GatherRows(torch.autograd.Function):
    """:func:`all_gather_rows` whose backward hands each rank the gradient of
    its own rows: summed over the group's copies first (a reduce-scatter, as
    a :func:`psum` and a slice), or, where every rank's copy is consumed
    alike, the rank's slice of its own."""

    @staticmethod
    def forward(ctx, t, group, dim, sum_grads):
        ctx.group, ctx.dim, ctx.rows, ctx.sum_grads = group, dim, t.shape[dim], sum_grads
        return all_gather_rows(t, group, dim)

    @staticmethod
    def backward(ctx, grad):
        if ctx.sum_grads:
            grad = psum(grad, ctx.group)
        start = dist.get_rank(ctx.group) * ctx.rows
        return grad.narrow(ctx.dim, start, ctx.rows).contiguous(), None, None, None


def all_gather_rows_grad(t: torch.Tensor, group=None, dim: int = 0,
                         sum_grads: bool = True) -> torch.Tensor:
    """:func:`all_gather_rows` under autograd.  ``sum_grads``: each rank's copy
    feeds a different part of the result (the senders' state that each rank's
    receivers read), so the rows' gradient is the sum over the ranks; without
    it every rank computes the same function of the gathered tensor (a loss
    on the whole sim), and the rows' gradient is the rank's own slice."""
    if dist.get_world_size(group) == 1:
        return t
    return _GatherRows.apply(t, group, dim, sum_grads)


def replicate(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Overwrite ``tensors`` in place with the group's first rank's
    (``broadcast``), so that every rank holds the same values."""
    src = dist.get_global_rank(group, 0) if group is not None else 0
    for t in tensors:
        buf = _wire(t, group)
        dist.broadcast(buf, src=src, group=group)
        with torch.no_grad():
            t.copy_(buf)


def broadcast_object(obj, group=None):
    """The group's first rank's ``obj`` (a picklable Python value), on every rank."""
    src = dist.get_global_rank(group, 0) if group is not None else 0
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]
