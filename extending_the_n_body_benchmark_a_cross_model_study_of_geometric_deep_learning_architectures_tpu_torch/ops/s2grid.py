"""Approximately uniform orientation grids on the sphere, for PONITA.

The port's own copy of the JAX package's ``ops/s2grid.py``, in the same
float64 NumPy operations in the same order, so the grid is the same bit for
bit: a Fibonacci-sphere start, then 200 projected gradient steps on the
pairwise Coulomb energy.  Host side, cached per size; the model turns it into
a device tensor once per device and dtype.
"""

from __future__ import annotations

import functools

import numpy as np


def fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    phi = np.pi * (3.0 - np.sqrt(5.0)) * i
    z = 1.0 - 2.0 * (i + 0.5) / n
    r = np.sqrt(np.clip(1.0 - z * z, 0.0, 1.0))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=-1)


@functools.lru_cache(maxsize=None)
def uniform_grid_s2(n: int, steps: int = 200, step_size: float = 0.01) -> np.ndarray:
    """``[n, 3]`` float64 unit vectors minimising the pairwise Coulomb energy."""
    if n <= 0:
        raise ValueError("num_ori must be positive")
    if n == 1:
        return np.array([[0.0, 0.0, 1.0]])
    x = fibonacci_sphere(n)
    for _ in range(steps):
        diff = x[:, None, :] - x[None, :, :]
        d2 = np.sum(diff * diff, axis=-1) + np.eye(n)
        force = np.sum(diff / (d2[..., None] ** 1.5), axis=1)  # Coulomb: diff / d^3
        force -= np.sum(force * x, axis=-1, keepdims=True) * x  # onto the tangent plane
        x = x + step_size * force
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
    return x
