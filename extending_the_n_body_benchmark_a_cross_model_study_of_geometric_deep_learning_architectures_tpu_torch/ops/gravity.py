"""Softened pairwise gravity: kernel K2 (``csrc/gravity.cu``) and its plain version.

``acceleration`` is the wrapper the integrator calls.  On a CPU tensor it
computes :func:`acceleration_plain`; on a CUDA tensor it launches the f32
kernel and counts the launch in ``acceleration.launches``.  The kernel
replaces the JAX package's Pallas ``pallas_acceleration``
(``ops/pallas/gravity.py:69``); see the source note in ``csrc/gravity.cu``.
"""

from __future__ import annotations

import torch

from . import _build


def acceleration_plain(pos: torch.Tensor, mass: torch.Tensor, G, softening) -> torch.Tensor:
    """``a_i = G * sum_j (r_j - r_i) * m_j / (|r_j - r_i|^2 + eps^2)^{3/2}``.

    ``pos [..., N, 3]``, ``mass [..., N, 1]`` -> ``[..., N, 3]``.  A pair with
    ``r2 == 0`` (only possible with zero softening) contributes nothing.
    """
    rel = pos[..., None, :, :] - pos[..., :, None, :]  # rel[..., i, j] = r_j - r_i
    r2 = torch.sum(rel * rel, dim=-1) + softening**2
    good = r2 > 0
    inv_r3 = torch.where(good, torch.where(good, r2, torch.ones_like(r2)) ** -1.5,
                         torch.zeros_like(r2))
    w = inv_r3 * mass[..., None, :, 0]
    return G * torch.sum(rel * w[..., None], dim=-2)


def acceleration(pos: torch.Tensor, mass: torch.Tensor, G, softening) -> torch.Tensor:
    """Kernel K2 on a CUDA tensor, the plain version on a CPU tensor."""
    if not _build.wants_kernel(pos):
        return acceleration_plain(pos, mass, G, softening)
    if pos.dtype != torch.float32 or mass.dtype != torch.float32:
        raise TypeError(f"the gravity kernel takes float32, got {pos.dtype}/{mass.dtype}")
    if pos.shape[-1] != 3 or mass.shape[:-1] != pos.shape[:-1] or mass.shape[-1] != 1:
        raise ValueError(f"want pos [..., N, 3] and mass [..., N, 1], got {pos.shape} {mass.shape}")
    if mass.device != pos.device:
        raise ValueError("pos and mass lie on different devices")
    lead, n = pos.shape[:-2], pos.shape[-2]
    p = pos.reshape(-1, n, 3).contiguous()
    m = mass.reshape(-1, n, 1).contiguous()
    out = torch.empty_like(p)
    err = _build.kernels().nbody_gravity_f32(
        p.data_ptr(), m.data_ptr(), out.data_ptr(), p.shape[0], n,
        float(G), float(softening), _build.stream_ptr(p),
    )
    _build.check(err, "nbody_gravity_f32")
    acceleration.launches += 1
    return out.reshape(*lead, n, 3)


acceleration.launches = 0
