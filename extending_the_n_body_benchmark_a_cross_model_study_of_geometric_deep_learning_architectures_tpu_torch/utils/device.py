"""Device selection and a bounded health probe of the card: counterpart of
the JAX package's ``utils/device.py``.

``"auto"`` (or None) is the first CUDA card and raises when there is none: no
entry point of the port moves to the CPU unless asked.  An integer selects a
card, ``"cpu"`` or -1 the host, and any other string is a torch device name.
"""

from __future__ import annotations

import subprocess
import sys
import time
from typing import Optional, Union

import torch


def get_device(device_id: Union[int, str, None] = "auto") -> torch.device:
    """Resolve a device spec to a ``torch.device``."""
    if device_id in (-1, "cpu"):
        return torch.device("cpu")
    if isinstance(device_id, str) and device_id.isdigit():
        device_id = int(device_id)
    if device_id in (None, "auto") or isinstance(device_id, int):
        n = torch.cuda.device_count()
        index = 0 if device_id in (None, "auto") else device_id
        if not 0 <= index < n:
            raise RuntimeError(f"CUDA device {index} requested, {n} visible; pass 'cpu' "
                               "to run on the host")
        return torch.device("cuda", index)
    return torch.device(str(device_id))


def backend_healthy(probe_timeout_s: float = 90.0,
                    platform: Optional[str] = None) -> bool:
    """Whether the card (or ``platform``, a torch device type such as ``"cpu"``)
    runs one small operation, bounded in time.

    The probe runs in a subprocess with a hard timeout: a sick CUDA stack can hang
    the first CUDA call for minutes, and a failed initialisation stays with
    the process that met it."""
    dev = platform or "cuda"
    code = ("import torch; "
            f"assert {dev!r} != 'cuda' or torch.cuda.is_available(); "
            f"x = torch.ones(8, 8, device={dev!r}); y = (x @ x).sum().item(); "
            "assert y == 512.0; print('OK')")
    try:
        out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             timeout=probe_timeout_s)
    except subprocess.TimeoutExpired:
        return False
    return out.returncode == 0


def wait_for_backend(max_wait_s: float = 3600.0,
                     probe_timeout_s: float = 90.0,
                     poll_s: float = 60.0,
                     platform: Optional[str] = None,
                     verbose: bool = False) -> bool:
    """Probe until the card answers, or ``max_wait_s`` elapses; True as soon
    as a probe succeeds."""
    deadline = time.time() + max_wait_s
    while True:
        if backend_healthy(probe_timeout_s=probe_timeout_s, platform=platform):
            return True
        if time.time() >= deadline:
            return False
        if verbose:
            print(f"device unavailable; retrying in {poll_s:.0f}s", file=sys.stderr)
        time.sleep(min(poll_s, max(0.0, deadline - time.time())))


def describe_devices() -> str:
    """One line per visible card: ``[index] cuda:<name>``."""
    return "\n".join(f"[{i}] cuda:{torch.cuda.get_device_name(i)}"
                     for i in range(torch.cuda.device_count()))
