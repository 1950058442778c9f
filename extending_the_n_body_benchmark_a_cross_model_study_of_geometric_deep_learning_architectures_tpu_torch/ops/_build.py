"""Build and load the port's CUDA kernels: the one place that runs ``nvcc``.

Every ``csrc/*.cu`` source is compiled for Hopper (``sm_90a``) into ONE shared
library with a plain C interface, loaded with ``ctypes``.  The sources are
compiled to objects by one ``nvcc`` each, all started together, and then
linked; this takes seconds, where ``torch.utils.cpp_extension.load`` (which
compiles against PyTorch's headers) takes minutes.

The build happens at first use, from the sources in the package only, into
``<package>/_build/`` (listed in ``.gitignore``).  The library's file name
carries a hash of the sources, the headers they include (``csrc/*.cuh``,
``csrc/*.h``) and the flags, so an edited source or header rebuilds, and a
finished library is moved into place atomically: concurrent builders never
load a half-written file.

``wants_kernel(t)`` is the single dispatch rule of every kernel wrapper: a
tensor on the CPU takes the plain PyTorch version, a tensor on the card
launches the kernel, and nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_LIB_STEM = "libnbody_kernels"

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
_sm_counts: dict = {}  # device index -> multi_processor_count
#: ``nvcc``'s output of the last build in this process (``-Xptxas -v``
#: reports each kernel's registers, shared memory and spills)
build_log = ""


def wants_kernel(t: torch.Tensor) -> bool:
    """True when ``t`` asks for the kernel: it lies on a CUDA device.

    A CPU tensor takes the plain version; any other device is refused."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {t.device}")
    return True


def sources() -> list:
    """The ``.cu`` files compiled into the library, one ``nvcc`` each."""
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def headers() -> list:
    """The headers under ``csrc/`` that the sources may include."""
    return sorted(p for ext in ("*.cuh", "*.h") for p in glob.glob(os.path.join(CSRC_DIR, ext)))


def source_hash(paths, flags) -> str:
    h = hashlib.sha256()
    for p in paths:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def library_path(flags=NVCC_FLAGS, stem: str = _LIB_STEM) -> str:
    digest = source_hash(sources() + headers(), flags)
    return os.path.join(BUILD_DIR, f"{stem}-{digest}.so")


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(cuda_home, "bin", "nvcc")
        if os.path.exists(cand):
            nvcc = cand
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build(extra_flags=(), stem: str = _LIB_STEM) -> str:
    """Compile ``csrc/*.cu`` into the hashed library unless it exists; return its path.

    ``extra_flags`` and ``stem`` make a library of another build beside the
    normal one (``edge_phases.py``'s instrumented kernels)."""
    global build_log
    flags = (*NVCC_FLAGS, *extra_flags)
    out = library_path(flags, stem)
    if os.path.exists(out):
        return out
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR)
    try:
        procs = []
        for src in sources():
            obj = os.path.join(work, os.path.basename(src) + ".o")
            cmd = [nvcc, *flags, "-c", src, "-o", obj]
            procs.append((obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], False
        for obj, p in procs:
            text, _ = p.communicate()
            logs.append(text)
            failed |= p.returncode != 0
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
        tmp = os.path.join(work, "lib.so")
        res = subprocess.run(
            [nvcc, "-shared", *(o for o, _ in procs), "-o", tmp],
            capture_output=True, text=True,
        )
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + res.stdout + res.stderr)
        os.replace(tmp, out)
        build_log = "\n".join(logs)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for stale in glob.glob(os.path.join(BUILD_DIR, f"{stem}-*.so")):
        if stale != out:
            try:
                os.remove(stale)
            except OSError:
                pass
    return out


def bind(lib: ctypes.CDLL) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nbody_gravity_f32.argtypes = [vp, vp, vp, ci, ci, cf, cf, vp]
    lib.nbody_edge_silu_f32.argtypes = [vp, vp, ci, vp]
    lib.nbody_leapfrog_f32.argtypes = [vp] * 6 + [ci] * 4 + [cf] * 4 + [ci] * 3 + [vp]
    edge = (lib.nbody_egnn_messages_f32, lib.nbody_egnn_messages_bf16)
    stream = (lib.nbody_egnn_stream_f32, lib.nbody_egnn_stream_bf16)
    for fn in edge:
        fn.argtypes = [vp] * 12 + [ci] * 6 + [vp]
    for fn in stream:
        fn.argtypes = [vp] * 15 + [ci] * 8 + [vp]
    for fn in (lib.nbody_gravity_f32, lib.nbody_leapfrog_f32, lib.nbody_edge_silu_f32, *edge,
               *stream):
        fn.restype = ctypes.c_int


def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built at first use.  Raises when there is no
    card: a kernel wrapper never returns the plain result in its place."""
    global _lib
    if _lib is not None:
        return _lib
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA kernel was requested but CUDA is not available; "
            "there is no fallback to the plain version"
        )
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            bind(lib)
            _lib = lib
    return _lib


def sm_count(t: torch.Tensor) -> int:
    """The number of SMs of the card ``t`` lies on, read once per card: the
    persistent edge kernels launch one block per SM."""
    index = t.device.index if t.device.index is not None else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_counts[index]


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
