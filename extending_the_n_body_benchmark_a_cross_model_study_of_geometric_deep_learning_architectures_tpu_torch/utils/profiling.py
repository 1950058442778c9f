"""Profiling: ``torch.profiler`` traces and steady-state timing.
Counterpart of the JAX package's ``utils/profiling.py``.

:func:`trace` writes a ``torch.profiler`` trace of the enclosed block into
``log_dir`` (a ``*.pt.trace.json`` that TensorBoard's profiler plugin or
Perfetto opens); :func:`time_fn` times a callable in steady state, with CUDA
events when it works on the card.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block (the host, and
    the card when there is one) into ``log_dir``; yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


def _on_card(values) -> bool:
    return any(isinstance(v, torch.Tensor) and v.is_cuda for v in values)


def time_fn(
    fn: Callable,
    *args,
    warmup: int = 1,
    iters: int = 5,
) -> dict:
    """Steady-state timing of ``fn(*args)``: ``warmup`` untimed calls, then
    ``iters`` timed ones.  A call that takes or returns a CUDA tensor is timed
    on the card's clock (CUDA events around it, waited on); any other by the
    host's.  Returns seconds: ``mean_s``, ``median_s``, ``min_s``, ``max_s``,
    and ``iters``."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    card = _on_card(args) or _on_card(outs)
    times = []
    for _ in range(iters):
        if card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    return {
        "mean_s": sum(times) / len(times),
        "median_s": statistics.median(times),
        "min_s": min(times),
        "max_s": max(times),
        "iters": iters,
    }
