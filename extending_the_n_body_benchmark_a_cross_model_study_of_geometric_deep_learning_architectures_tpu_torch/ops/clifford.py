"""Clifford algebra Cl(3) tables for CGENN: host-side NumPy constants.

The port's own copy of the JAX package's ``ops/clifford.py``, in the same
float64 NumPy operations in the same order, so every table is the same bit
for bit.  The 8 blades in shortlex order are ``[1, e1, e2, e3, e12, e13, e23,
e123]`` with grades ``[0, 1, 1, 1, 2, 2, 2, 3]``; the geometric product is
``einsum('...i,ijk,...k->...j', a, C, b)`` over the ``[8, 8, 8]`` table
:func:`cayley_table`.  The model turns these into non-persistent buffers
once, at construction, never inside a forward.
"""

from __future__ import annotations

import functools
import itertools
from typing import List, Sequence, Tuple

import numpy as np

DIM = 3
N_BLADES = 8
GRADES = np.array([0, 1, 1, 1, 2, 2, 2, 3])
SUBSPACES = np.array([1, 3, 3, 1])  # C(3, g)
GRADE_SLICES = [slice(0, 1), slice(1, 4), slice(4, 7), slice(7, 8)]
BETA_SIGNS = ((-1) ** (GRADES * (GRADES - 1) // 2)).astype(np.float64)


def _blade_bitmaps() -> List[int]:
    bitmaps = []
    for r in range(DIM + 1):
        for combo in itertools.combinations(range(DIM), r):
            bm = 0
            for i in combo:
                bm |= 1 << i
            bitmaps.append(bm)
    return bitmaps


_BITMAPS = _blade_bitmaps()
_BITMAP_TO_INDEX = {bm: i for i, bm in enumerate(_BITMAPS)}


def _reorder_sign(a: int, b: int) -> int:
    """Sign from reordering the basis vectors of blade ``a`` past blade ``b``
    (the Euclidean part)."""
    a >>= 1
    s = 0
    while a:
        s += bin(a & b).count("1")
        a >>= 1
    return 1 if s % 2 == 0 else -1


def cayley_table(signature: Sequence[float]) -> np.ndarray:
    """Geometric multiplication table ``C[i, j, k] = (e_i e_k)_j``: left blade
    ``i``, output blade ``j``, right blade ``k``.  ``signature`` holds the
    squared norms of the 3 generators (CGENN passes the eigenvalues of its
    frozen metric)."""
    sig = np.asarray(signature, dtype=np.float64)
    C = np.zeros((N_BLADES, N_BLADES, N_BLADES))
    for i, bm_a in enumerate(_BITMAPS):
        for k, bm_b in enumerate(_BITMAPS):
            sign = _reorder_sign(bm_a, bm_b)
            common = bm_a & bm_b
            val = float(sign)
            g = 0
            while common:
                if common & 1:
                    val *= sig[g]
                g += 1
                common >>= 1
            j = _BITMAP_TO_INDEX[bm_a ^ bm_b]
            C[i, j, k] += val
    return C


@functools.lru_cache(maxsize=None)
def geometric_product_paths() -> np.ndarray:
    """Bool ``[4, 4, 4]`` of the (left, out, right) grade triples with a
    nonzero product path (20 of the 64)."""
    C = cayley_table((1.0, 1.0, 1.0))
    paths = np.zeros((4, 4, 4), dtype=bool)
    for g_l in range(4):
        for g_o in range(4):
            for g_r in range(4):
                block = C[GRADE_SLICES[g_l], GRADE_SLICES[g_o], GRADE_SLICES[g_r]]
                paths[g_l, g_o, g_r] = bool(np.abs(block).sum() > 0)
    return paths


def reference_metric(seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The frozen metric ``0.5 I + 1e-4 rand(3, 3)``, symmetrised:
    ``(eigenvalues, P, P_inv)`` of ``m + m.T`` by ``eigh`` (ascending
    eigenvalues), precomputed since the metric never trains."""
    rng = np.random.default_rng(seed)
    m = 0.5 * np.eye(3) + 1e-4 * rng.random((3, 3))
    sym = m + m.T
    w, P = np.linalg.eigh(sym)
    return w, P, np.linalg.inv(P)


def path_index() -> np.ndarray:
    """Int ``[8, 8, 8]``: for each blade triple (left, out, right), the
    position of its grade triple among :func:`geometric_product_paths`'
    nonzero entries in row-major order (``np.argwhere``'s), or the path count
    (20) where the triple has no path.  Gathering a ``[C, 21]`` weight (the
    path weights and a zero) with it gives the path weights scattered onto
    the grade grid and repeated onto the blades."""
    paths = geometric_product_paths()
    slot = np.full((4, 4, 4), int(paths.sum()), dtype=np.int64)
    for p, (a, b, c) in enumerate(np.argwhere(paths)):
        slot[a, b, c] = p
    g = GRADES
    return slot[g[:, None, None], g[None, :, None], g[None, None, :]]
