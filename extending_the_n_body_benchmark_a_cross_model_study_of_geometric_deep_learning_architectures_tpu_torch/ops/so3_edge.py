"""Edge-aligned SO(3) frames and batched Wigner-D matrices for EquiformerV2.

Counterpart of the JAX package's ``ops/so3_edge.py``, the port's own copy:

* :func:`edge_align_rotation` builds, for every edge, the rotation that turns
  it onto the z axis, with a deterministic helper axis (the model is
  invariant to that gauge up to rounding);
* :func:`wigner_blocks` gives D^1 as a basis-permuted copy of R and D^2 as a
  quadratic form in R through a constant ``[5, 5, 9, 9]`` tensor, solved once
  on the host against :func:`..ops.steerable.wigner_D_numpy`;
* the index helpers of the restricted (``|m| <= mmax``) layout and the S2
  grid matrices.

The host-side numpy code (the quadratic tensor, the grid, the index tables) is
the JAX package's line for line, so on one machine both give the same arrays
bit for bit; :func:`on_device` makes each one a tensor once per device and
dtype, never inside a forward.  Coefficient layout (lmax 2): l-primary, e3nn
real basis per l (m = -l..l; the l=1 components are (y, z, x) of the physical
vector).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

import numpy as np
from .. import _tf32  # noqa: F401  (TF32 off before torch is used)
import torch

from .steerable import _sh_numpy, wigner_D_numpy

# physical (x, y, z) -> basis (y, z, x) row selection for l=1
_YZX = np.array([1, 2, 0])


@functools.lru_cache(maxsize=None)
def _wigner2_quadratic_tensor() -> np.ndarray:
    """Solve T with ``D2(R)[a,b] = sum_pq T[a,b,p,q] vecR[p] vecR[q]``."""
    rng = np.random.default_rng(7)
    rows = []
    targets = []
    for _ in range(60):
        A = rng.normal(size=(3, 3))
        Q, r = np.linalg.qr(A)
        R = Q * np.sign(np.diag(r))
        if np.linalg.det(R) < 0:
            R[:, 0] *= -1
        v = R.reshape(9)
        rows.append(np.outer(v, v).reshape(81))
        targets.append(wigner_D_numpy(2, R).reshape(25))
    M = np.stack(rows)  # [60, 81]
    Y = np.stack(targets)  # [60, 25]
    T, *_ = np.linalg.lstsq(M, Y, rcond=None)  # [81, 25]
    T = T.T.reshape(5, 5, 9, 9)
    # verify on a held-out rotation
    A = rng.normal(size=(3, 3))
    Q, r = np.linalg.qr(A)
    R = Q * np.sign(np.diag(r))
    if np.linalg.det(R) < 0:
        R[:, 0] *= -1
    v = R.reshape(9)
    err = np.abs(np.einsum("abpq,p,q->ab", T, v, v) - wigner_D_numpy(2, R)).max()
    assert err < 1e-8, f"Wigner-2 quadratic fit failed: {err}"
    return T


_DEVICE_CACHE: Dict[Tuple, torch.Tensor] = {}


def on_device(key: Tuple, make: Callable[[], np.ndarray], like: torch.Tensor,
              dtype=None) -> torch.Tensor:
    """The host array ``make()`` as a tensor on ``like``'s device, in
    ``dtype`` (``like``'s by default), made once per ``key``, device and
    dtype."""
    dtype = like.dtype if dtype is None else dtype
    full = (key, like.device, dtype)
    if full not in _DEVICE_CACHE:
        _DEVICE_CACHE[full] = torch.as_tensor(np.asarray(make()), dtype=dtype,
                                              device=like.device)
    return _DEVICE_CACHE[full]


def index_on_device(key: Tuple, make: Callable[[], np.ndarray], like: torch.Tensor):
    """An integer index table on ``like``'s device (int64), made once."""
    return on_device(key, make, like, torch.int64)


def edge_align_rotation(edge_vec: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rotation ``R`` with ``R @ unit(edge_vec) = z_hat`` for every edge.

    edge_vec ``[..., 3]`` -> ``[..., 3, 3]``.  Azimuth gauge: the coordinate
    axis least aligned with the edge (the first one on ties).  The edge
    vector is detached, as the JAX package stops its gradient; a zero vector
    (the dense diagonal's) gives a finite matrix of zeros.
    """
    v = edge_vec.detach()
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    e = v / torch.where(n > eps, n, torch.ones_like(n))
    # pick the helper axis with the smallest |e_k|
    helper = torch.nn.functional.one_hot(torch.argmin(torch.abs(e), dim=-1), 3).to(e.dtype)
    b1 = torch.linalg.cross(e, helper, dim=-1)
    b1 = b1 / torch.sqrt(torch.sum(b1 * b1, dim=-1, keepdim=True) + eps)
    b2 = torch.linalg.cross(e, b1, dim=-1)
    # rows (b1, b2, e): R @ e = (0, 0, 1)
    return torch.stack([b1, b2, e], dim=-2)


def wigner_blocks(R: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(D0, D1, D2) for a batch of rotation matrices ``R [..., 3, 3]``.  D2
    is ``vec(R) (x) vec(R)`` times the quadratic tensor reshaped ``[25, 81]``:
    an explicit order, not left to ``torch.einsum``."""
    batch = R.shape[:-2]
    d0 = torch.ones(batch + (1, 1), dtype=R.dtype, device=R.device)
    idx = index_on_device(("yzx",), lambda: _YZX, R)
    d1 = R.index_select(-2, idx).index_select(-1, idx)
    T = on_device(("wigner2",), lambda: _wigner2_quadratic_tensor().reshape(25, 81), R)
    vec = R.reshape(batch + (9,))
    outer = (vec[..., :, None] * vec[..., None, :]).reshape(batch + (81,))
    d2 = (outer @ T.T).reshape(batch + (5, 5))
    return d0, d1, d2


def wigner_full(R: torch.Tensor, lmax: int = 2) -> torch.Tensor:
    """Block-diagonal D over l=0..lmax in l-primary layout: ``[..., K, K]``
    with ``K = (lmax+1)^2``, built by concatenation (no in-place writes)."""
    blocks = wigner_blocks(R)[: lmax + 1]
    batch = R.shape[:-2]
    K = (lmax + 1) ** 2
    rows, start = [], 0
    for d in blocks:
        w = d.shape[-1]
        parts = []
        if start:
            parts.append(R.new_zeros(batch + (w, start)))
        parts.append(d)
        if K - start - w:
            parts.append(R.new_zeros(batch + (w, K - start - w)))
        rows.append(torch.cat(parts, dim=-1))
        start += w
    return torch.cat(rows, dim=-2)


# ---------------------------------------------------------------- layouts

def lprimary_pairs(lmax: int):
    return [(l, m) for l in range(lmax + 1) for m in range(-l, l + 1)]


@functools.lru_cache(maxsize=None)
def restricted_indices(lmax: int, mmax: int) -> np.ndarray:
    """l-primary indices of coefficients with ``|m| <= mmax``."""
    return np.array(
        [i for i, (l, m) in enumerate(lprimary_pairs(lmax)) if abs(m) <= mmax]
    )


@functools.lru_cache(maxsize=None)
def m_order_indices(lmax: int, mmax: int):
    """Index arrays (into the restricted layout) for the SO(2) blocks:
    ``(m0, [(minus_m, plus_m) for m in 1..mmax])``."""
    pairs = [(l, m) for (l, m) in lprimary_pairs(lmax) if abs(m) <= mmax]
    index = {p: i for i, p in enumerate(pairs)}
    m0 = np.array([index[(l, 0)] for l in range(lmax + 1)])
    blocks = []
    for m in range(1, mmax + 1):
        minus = np.array([index[(l, -m)] for l in range(m, lmax + 1)])
        plus = np.array([index[(l, m)] for l in range(m, lmax + 1)])
        blocks.append((minus, plus))
    return m0, blocks


@functools.lru_cache(maxsize=None)
def l_expand_index(lmax: int, mmax: int | None = None) -> np.ndarray:
    """Map each (restricted) coefficient to its degree l, to expand per-l
    weights across m."""
    pairs = lprimary_pairs(lmax)
    if mmax is not None:
        pairs = [(l, m) for (l, m) in pairs if abs(m) <= mmax]
    return np.array([l for (l, m) in pairs])


@functools.lru_cache(maxsize=None)
def m_order(lmax: int, mmax: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(order, inverse)``: ``order`` lists the restricted rows m-major (the
    m=0 rows, then each m's -m rows and +m rows), ``inverse`` puts rows in
    that order back into the restricted layout."""
    m0, blocks = m_order_indices(lmax, mmax)
    order = np.concatenate([m0] + [np.concatenate([mi, pl]) for mi, pl in blocks])
    return order, np.argsort(order)


# ---------------------------------------------------------------- S2 grid

@functools.lru_cache(maxsize=None)
def s2_grid_mats(lmax: int, mmax: int, resolution: int = 18):
    """(to_grid [G, K_r], from_grid [K_r, G]) for the restricted basis.

    Grid: Gauss-Legendre colatitudes x uniform azimuths; to_grid evaluates
    component-normalised real SH (e3nn basis) at the grid points; from_grid
    is the quadrature-weighted adjoint (exact for band-limited signals).
    """
    nlat = resolution
    nlon = 2 * resolution
    x_gl, w_gl = np.polynomial.legendre.leggauss(nlat)  # cos(theta) nodes
    theta = np.arccos(x_gl)
    phi = np.linspace(0, 2 * np.pi, nlon, endpoint=False)
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    pts = np.stack(
        [np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp), np.cos(tt)], axis=-1
    ).reshape(-1, 3)
    w = np.repeat(w_gl, nlon) * (2 * np.pi / nlon)  # total 4*pi

    idx = restricted_indices(lmax, mmax)
    comps = np.concatenate([_sh_numpy(l, pts) for l in range(lmax + 1)], axis=-1)
    comps = comps * np.sqrt(4 * np.pi)  # integral -> component normalization
    A = comps[:, idx]  # [G, K_r]
    from_grid = (A * w[:, None]).T / (4 * np.pi)  # adjoint with quadrature
    return A, from_grid
