"""The body-sharded ring edge stage of EGNN-MC: counterpart of the JAX
package's ``parallel/ring_egnn.py``.

Each rank of the ``body`` group holds a block of ``N/D`` bodies (``hA``,
``hB``, the initial positions, velocities, masses and the layer's
coordinates: O(N) state).  At each of ``D`` ring steps it adds the masked
message and coordinate sums of the *visiting* sender block onto its
*resident* receivers, then passes the visitors on
(:func:`.mesh.ring_shift_grad`); every edge tensor it holds is a ``[B, N/D,
N/D, *]`` block.  Under autograd the backward passes the visitors'
gradients home the other way round the ring, so the stage trains, as the
JAX package's does (JAX transposes its ``lax.ppermute``).  After ``D``
steps the sums cover all N senders; the self pairs are left out at step 0
(when each rank is visited by its own block), and the means divide by the
fully connected count ``N - 1``.  Fully connected graphs only, as in the
JAX package.  The last step's pass is skipped: its result would be
discarded.

The per-edge math is the dense stage's (featurisation from the initial
positions, the edge MLP with silu, the coordinate head), written as
``_block_sums`` (``ring_egnn.py:39-84``) writes it, with its rounding
points: the geometry and both running sums in float32, ``scal`` cast to
the compute dtype (``hA``'s) before its product, the messages summed after
the multiply by the float32 keep mask (which promotes a bf16 message to
float32 first, in both frameworks), and ``trans`` from the weight cast to
float32.  A float64 model (the tests') computes those float32 parts in
float64, where the JAX package's ring stays at float32 (its dense stage
does not).  Plain PyTorch on every device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.graph import safe_sqrt
from .mesh import ring_shift_grad


def geometry_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32, or float64 for a float64 model."""
    return torch.promote_types(torch.float32, dtype)


def _block_sums(hA, hB_v, nd_i, nd_v, wg, W2, b2, Wc1, bc1, wc2, keep, tanh: bool,
                norm_diff: bool):
    """Masked ``(agg, trans)`` sums of the visiting sender block onto the
    resident receivers.

    ``hA [B, NI, He]``, ``hB_v [B, NJ, He]``; ``nd_i``, ``nd_v [B, N*, 10]``
    (lanes 0-2 the initial position, 3-5 velocity, 6 mass, 7-9 the layer's
    coordinates) in the geometry dtype; ``keep [NI, NJ]`` in it too.
    """
    dtype = hA.dtype
    p0i, p0v = nd_i[..., 0:3], nd_v[..., 0:3]
    vi, vv = nd_i[..., 3:6], nd_v[..., 3:6]
    mi, mv = nd_i[..., 6:7], nd_v[..., 6:7]
    ci, cv = nd_i[..., 7:10], nd_v[..., 7:10]

    # the dataloader's edge attributes, from the initial positions
    cd0 = p0i[:, :, None, :] - p0v[:, None, :, :]  # [B, NI, NJ, 3]
    d2_0 = torch.sum(cd0 * cd0, dim=-1, keepdim=True)
    dist0 = torch.clamp(torch.sqrt(torch.clamp(d2_0, min=0.0)), min=1e-12)
    dir0 = cd0 / dist0
    proj_i = torch.sum(vi[:, :, None, :] * dir0, dim=-1, keepdim=True)
    proj_j = torch.sum(vv[:, None, :, :] * dir0, dim=-1, keepdim=True)
    mass_prod = mi[:, :, None, :] * mv[:, None, :, :]

    # coord2radial on the layer's coordinates
    cd = ci[:, :, None, :] - cv[:, None, :, :]
    radial = torch.sum(cd * cd, dim=-1, keepdim=True)
    if norm_diff:
        # the dense stage's safe_sqrt: the same values under the clamp at 1, and
        # a zero derivative at the self pairs' radial 0, where sqrt's is infinite
        cd = cd / torch.clamp(safe_sqrt(radial), min=1.0)

    scal = torch.cat([radial, mass_prod, proj_i, proj_j, d2_0], dim=-1).to(dtype)
    m1 = F.silu(hA[:, :, None, :] + hB_v[:, None, :, :] + scal @ wg)
    m2 = F.silu(m1 @ W2 + b2)

    keep4 = keep[None, :, :, None]
    agg_sum = torch.sum(m2 * keep4, dim=2)  # [B, NI, He]

    w = F.silu(m2 @ Wc1 + bc1) @ wc2[:, None]
    if tanh:
        w = torch.tanh(w)
    trans = torch.clamp(w.to(cd.dtype) * cd, -100.0, 100.0)
    trans_sum = torch.sum(trans * keep4, dim=2)  # [B, NI, 3]
    return agg_sum, trans_sum


def ring_edge_stage(hA, hB, pos0, vel, mass, coord, wg, W2, b2, Wc1, bc1, wc2,
                    tanh: bool = True, norm_diff: bool = True, group=None):
    """Fully connected masked means ``(agg [B, N/D, He], trans [B, N/D, 3])``
    over all N senders, in ``D`` ring steps over ``group`` (the ``body`` axis's).

    ``hA``, ``hB [B, N/D, He]`` this rank's receiver and sender projections;
    ``pos0``, ``vel``, ``coord [B, N/D, 3]``, ``mass [B, N/D, 1]``; ``wg [5,
    He]`` the geometric rows of the first edge product; ``wc2 [Hc]``.  ``agg``
    comes back in ``hA``'s dtype, ``trans`` in the geometry dtype."""
    size = torch.distributed.get_world_size(group)
    n_local = hA.shape[1]
    gd = geometry_dtype(hA.dtype)
    nodes = torch.cat([pos0.to(gd), vel.to(gd), mass.to(gd), coord.to(gd)], dim=-1)
    ones = torch.ones((n_local, n_local), dtype=gd, device=hA.device)
    keep0 = ones - torch.eye(n_local, dtype=gd, device=hA.device)
    acc_agg = torch.zeros(hA.shape, dtype=gd, device=hA.device)
    acc_tr = torch.zeros(coord.shape, dtype=gd, device=hA.device)
    hB_v, nd_v = hB, nodes
    for step in range(size):
        a_sum, t_sum = _block_sums(hA, hB_v, nodes, nd_v, wg, W2, b2, Wc1, bc1, wc2,
                                   keep0 if step == 0 else ones, tanh, norm_diff)
        acc_agg = acc_agg + a_sum.to(gd)
        acc_tr = acc_tr + t_sum
        if step < size - 1:
            hB_v, nd_v = ring_shift_grad([hB_v, nd_v], group)
    inv = 1.0 / (n_local * size - 1)  # fully connected: N - 1 senders
    return (acc_agg * inv).to(hA.dtype), acc_tr * inv
