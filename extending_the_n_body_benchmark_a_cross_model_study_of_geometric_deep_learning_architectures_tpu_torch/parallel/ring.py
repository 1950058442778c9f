"""The body-sharded ring force: counterpart of the JAX package's
``parallel/ring.py``.

Each rank of the ``body`` group holds a block of ``N/D`` bodies (positions
and masses).  At each of ``D`` ring steps it adds the acceleration of the
*visiting* source block on its *resident* receivers, then passes the visitor
to the next rank (:func:`.mesh.ring_shift`, the JAX package's
``lax.ppermute``); after ``D`` steps every receiver has summed over all N
sources, and the pairwise block a rank holds is ``[N/D, N/D]``.  The last
step's pass is skipped: its result would be discarded.

The kernel is the guarded softened one of the JAX package's
``core.physics.compute_acceleration``: a pair at ``r2 == 0`` (the diagonal
of a block visiting itself, or coincident bodies) contributes nothing.  It
is plain PyTorch on every device, as the JAX package's ring is plain JAX.
"""

from __future__ import annotations

from .. import _tf32  # noqa: F401  (TF32 off before torch is used)
import torch

from ..core.physics import GravityParams
from .mesh import BODY_AXIS, axis_group, ring_shift


def _block_acceleration(dst_pos: torch.Tensor, src_pos: torch.Tensor, src_mass: torch.Tensor,
                        G: float, softening: float) -> torch.Tensor:
    """Acceleration of the ``dst`` receivers due to the ``src`` sources:
    ``dst_pos [..., Nd, 3]``, ``src_pos [..., Ns, 3]``, ``src_mass [..., Ns, 1]``."""
    rel = src_pos[..., None, :, :] - dst_pos[..., :, None, :]  # [..., Nd, Ns, 3]
    r2 = torch.sum(rel * rel, dim=-1)
    inv_r3 = torch.where(r2 > 0.0, (r2 + softening**2) ** -1.5, torch.zeros_like(r2))
    w = inv_r3 * src_mass[..., None, :, 0]  # [..., Nd, Ns]
    return G * torch.einsum("...ds,...dsk->...dk", w, rel)


def ring_acceleration(pos: torch.Tensor, mass: torch.Tensor, params: GravityParams,
                      group=None) -> torch.Tensor:
    """The acceleration of this rank's block ``pos [..., N/D, 3]`` (masses
    ``[..., N/D, 1]``) due to all N bodies of the group's blocks."""
    G, soft = params.interaction_strength, params.softening
    size = torch.distributed.get_world_size(group)
    acc = torch.zeros_like(pos)
    src_pos, src_mass = pos, mass
    for step in range(size):
        acc = acc + _block_acceleration(pos, src_pos, src_mass, G, soft)
        if step < size - 1:
            src_pos, src_mass = ring_shift([src_pos, src_mass], group)
    return acc


def make_ring_acceleration(mesh, params: GravityParams):
    """``fn(pos, mass) -> acc`` over ``mesh``'s ``body`` axis: this rank's block
    of a single system ``[N/D, 3]`` or of a batch ``[B, N/D, 3]`` in, its
    acceleration out."""
    group = axis_group(mesh, BODY_AXIS)
    return lambda pos, mass: ring_acceleration(pos, mass, params, group)
