"""Spawn gloo ranks on one host: the tests' ranks on the CPU, and the smoke's
ranks that share one card.

``spawn_ranks(fn, world_size, args)`` starts ``world_size`` processes, each
of which joins a gloo group at
``tcp://localhost:<free port>`` with a timeout, runs ``fn(rank, *args)`` with
its output sent to ``<workdir>/rank<r>.log``, saves the returned value with
``torch.save`` and leaves the group.  The parent waits at most ``timeout``
seconds for all of them, kills what is left, and returns the ranks' values
in rank order.  A rank that fails, or one still running at the deadline,
fails the call with the tail of every rank's log.  ``fn`` must be importable
by name from the children (a module-level function), and a script that
calls ``spawn_ranks`` guards its main code with ``if __name__ ==
"__main__"``.

The processes come from multiprocessing's ``forkserver``: a fresh server
process, started at the first call, imports torch (and its distributed
package) once and forks each rank from that state, so a rank starts in a
fraction of a second where a ``spawn``ed one imports torch anew.  The caller, which may hold CUDA and
threads, is never forked; the server stops when the caller exits.
"""

from __future__ import annotations

import multiprocessing
import multiprocessing.forkserver
import os
import shutil
import socket
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

from .. import _tf32  # noqa: F401  (TF32 off before torch is used)
import torch

LOG_TAIL_BYTES = 4000


def free_port() -> int:
    """A TCP port on the loopback interface that is free at the moment."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world_size: int, port: int, workdir: str, timeout: float,
               threads: int, args) -> None:
    import datetime

    import torch.distributed as dist

    log = open(os.path.join(workdir, f"rank{rank}.log"), "w", buffering=1)
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    sys.stdout = sys.stderr = log
    try:
        torch.set_num_threads(threads)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    except BaseException:
        traceback.print_exc()
        log.flush()
        os._exit(1)
    log.flush()
    os._exit(0)


def _tail(path: str) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - LOG_TAIL_BYTES))
            return f.read().decode(errors="replace")
    except OSError:
        return "(no log)"


def _context():
    ctx = multiprocessing.get_context("forkserver")
    # read at the server's start; torch.optim imports torch.distributed.tensor and
    # torch._dynamo at an optimizer's first construction (~1 s), which a rank that
    # trains would pay
    ctx.set_forkserver_preload(["torch", "torch.distributed", "torch.distributed.tensor",
                                "torch._dynamo"])
    return ctx


def start_server() -> None:
    """Start the fork server now, so that its imports overlap the caller's own
    work (a build, say) and a later ``spawn_ranks`` forks at once."""
    _context()
    multiprocessing.forkserver.ensure_running()


def spawn_ranks(fn: Callable, world_size: int, args: Sequence[Any] = (), timeout: float = 600.0,
                threads: int = 1, workdir: Optional[str] = None) -> List[Any]:
    """Run ``fn(rank, *args)`` on ``world_size`` gloo ranks; their return values
    in rank order.  ``threads`` is each rank's ``torch.set_num_threads``.  The
    ranks' logs and results go to ``workdir`` (a temporary directory, removed
    after, when None)."""
    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="ranks-") if own else workdir
    os.makedirs(workdir, exist_ok=True)
    ctx = _context()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, port, workdir, timeout,
                                                  threads, tuple(args)), daemon=True)
             for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10.0)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if late or failed:
            tails = "\n".join(f"--- rank {r} (exit {procs[r].exitcode}) ---\n"
                              f"{_tail(os.path.join(workdir, f'rank{r}.log'))}"
                              for r in range(world_size))
            what = f"still running after {timeout:.0f} s: {late}" if late else f"failed: {failed}"
            raise RuntimeError(f"gloo ranks {what}\n{tails}")
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        if own:
            shutil.rmtree(workdir, ignore_errors=True)
