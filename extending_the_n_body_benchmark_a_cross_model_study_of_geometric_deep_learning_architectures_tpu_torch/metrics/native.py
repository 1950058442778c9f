"""ctypes bridge to the native macro kernels (``native/macro_kernels.cpp``).

The port's own copy of the JAX package's ``metrics/native.py``.
``get_lib()`` lazily builds (into ``<pkg>/_build/``) and loads the library;
every wrapper takes the same arrays as its NumPy twin in :mod:`.macros` and
returns identical counts.  ``compute_all_macros`` in :mod:`.macros` prefers
these when available (disable with ``NBX_DISABLE_NATIVE=1``).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_lib = None
_tried = False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("NBX_DISABLE_NATIVE"):
        return None
    from ..native.build import ensure_built

    path = ensure_built()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        # an unloadable library degrades to NumPy rather than crashing
        # every compute_all_macros call
        return None
    dp = ctypes.POINTER(ctypes.c_double)
    i64 = ctypes.c_int64
    lib.count_stickings_collisions.argtypes = [
        dp, i64, i64, i64, ctypes.c_int, ctypes.c_double, dp, dp
    ]
    lib.count_leaving.argtypes = [dp, i64, i64, i64, ctypes.c_double, dp]
    lib.max_com_distance.argtypes = [dp, i64, i64, i64, dp]
    lib.count_sharp_turns.argtypes = [dp, i64, i64, i64, ctypes.c_double, dp]
    lib.count_group_collisions.argtypes = [
        dp, i64, i64, i64, ctypes.c_int, ctypes.c_double, dp
    ]
    lib.stuck_cluster_sizes.argtypes = [
        dp, i64, i64, i64, ctypes.c_int, ctypes.c_double, dp
    ]
    _lib = lib
    return _lib


def _prep(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _numpy_twin(name: str):
    """Drop-in fallback when the native library is unavailable — the
    wrappers advertise identical behaviour to their :mod:`.macros` twins,
    so a missing compiler must not turn into an AttributeError on None."""
    from . import macros

    return getattr(macros, name)


def count_stickings_and_collisions(
    loc: np.ndarray, time_threshold: int = 3, distance_threshold: float = 0.5
) -> Tuple[np.ndarray, np.ndarray]:
    lib = get_lib()
    if lib is None:
        return _numpy_twin("count_stickings_and_collisions")(
            loc, time_threshold, distance_threshold
        )
    loc = _prep(loc)
    S, T, N, _ = loc.shape
    stick = np.zeros(S)
    coll = np.zeros(S)
    lib.count_stickings_collisions(
        _ptr(loc), S, T, N, time_threshold, distance_threshold, _ptr(stick), _ptr(coll)
    )
    return stick, coll


def count_balls_leaving_defined_area(
    loc: np.ndarray, distance_threshold: float = 15.0
) -> np.ndarray:
    lib = get_lib()
    if lib is None:
        return _numpy_twin("count_balls_leaving_defined_area")(loc, distance_threshold)
    loc = _prep(loc)
    S, T, N, _ = loc.shape
    out = np.zeros(S)
    lib.count_leaving(_ptr(loc), S, T, N, distance_threshold, _ptr(out))
    return out


def max_com_distance(loc: np.ndarray) -> np.ndarray:
    lib = get_lib()
    if lib is None:
        return _numpy_twin("max_com_distance")(loc)
    loc = _prep(loc)
    S, T, N, _ = loc.shape
    out = np.zeros(S)
    lib.max_com_distance(_ptr(loc), S, T, N, _ptr(out))
    return out


def count_sharp_turns(vel: np.ndarray, angle_threshold: float = 30.0) -> np.ndarray:
    lib = get_lib()
    if lib is None:
        return _numpy_twin("count_sharp_turns")(vel, angle_threshold)
    vel = _prep(vel)
    S, T, N, _ = vel.shape
    out = np.zeros(S)
    lib.count_sharp_turns(_ptr(vel), S, T, N, angle_threshold, _ptr(out))
    return out


def count_group_collisions(
    loc: np.ndarray, time_threshold: int = 2, distance_threshold: float = 2.0
) -> np.ndarray:
    lib = get_lib()
    if lib is None:
        return _numpy_twin("count_group_collisions")(
            loc, time_threshold, distance_threshold
        )
    loc = _prep(loc)
    S, T, N, _ = loc.shape
    out = np.zeros(S)
    lib.count_group_collisions(
        _ptr(loc), S, T, N, time_threshold, distance_threshold, _ptr(out)
    )
    return out


def stuck_cluster_sizes(
    loc: np.ndarray, time_threshold: int = 2, distance_threshold: float = 2.0
) -> np.ndarray:
    lib = get_lib()
    if lib is None:
        return _numpy_twin("stuck_cluster_sizes")(
            loc, time_threshold, distance_threshold
        )
    loc = _prep(loc)
    S, T, N, _ = loc.shape
    out = np.zeros(S)
    lib.stuck_cluster_sizes(
        _ptr(loc), S, T, N, time_threshold, distance_threshold, _ptr(out)
    )
    return out
