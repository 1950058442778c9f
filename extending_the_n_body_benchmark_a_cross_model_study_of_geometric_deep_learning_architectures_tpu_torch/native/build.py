"""Build the native macro-kernel library (g++, no external build deps).

``python -m <pkg>.native.build`` compiles ``macro_kernels.cpp`` into the
port's build directory ``<pkg>/_build/`` (listed in ``.gitignore``), never
next to the sources.  The file name carries a hash of the source and flags,
and a finished library is moved into place atomically.  :func:`ensure_built`
builds lazily on first use; ``metrics/native.py`` falls back to the NumPy
versions when no compiler is available.
"""

from __future__ import annotations

import glob
import hashlib
import os
import subprocess
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "macro_kernels.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libmacros-{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile unless the hashed library exists; return its path.  Raises on failure."""
    lib = library_path()
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.tmp.{os.getpid()}"
    try:
        res = subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"native build failed:\n{res.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    for stale in glob.glob(os.path.join(BUILD_DIR, "libmacros-*.so")):
        if stale != lib:
            try:
                os.remove(stale)
            except OSError:
                pass
    if verbose:
        print(f"built {lib}")
    return lib


def ensure_built() -> Optional[str]:
    """Build if missing; return the library path or None on failure."""
    try:
        return build()
    except Exception:
        return None


if __name__ == "__main__":
    build(verbose=True)
