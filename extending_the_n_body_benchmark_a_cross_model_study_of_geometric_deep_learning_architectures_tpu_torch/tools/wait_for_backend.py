"""Block until the card is healthy (or a deadline): counterpart of the JAX
repo's ``scripts/wait_for_tpu.py``.

A sick CUDA stack can hang its first call for minutes, so launchers gate an
unattended run on this bounded probe (``utils.device.wait_for_backend``:
each probe a subprocess with a hard timeout) instead of letting the trainer
spend its time limit in a hung initialisation.

Usage:
    python -m <package>.tools.wait_for_backend [--max-wait 3600] [--probe-timeout 90]
                                               [--poll 60] [--platform cuda]
Exit code 0 = healthy, 1 = deadline elapsed.
"""
from __future__ import annotations

import argparse
import sys

from ..utils import device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--max-wait", type=float, default=3600.0,
                    help="seconds to keep retrying before giving up")
    ap.add_argument("--probe-timeout", type=float, default=90.0,
                    help="per-probe subprocess timeout (s)")
    ap.add_argument("--poll", type=float, default=60.0,
                    help="sleep between probes (s)")
    ap.add_argument("--platform", type=str, default="cuda",
                    help="torch device the probe runs on (cuda, cuda:1, cpu)")
    args = ap.parse_args(argv)
    ok = device.wait_for_backend(
        max_wait_s=args.max_wait,
        probe_timeout_s=args.probe_timeout,
        poll_s=args.poll,
        platform=args.platform,
        verbose=True,
    )
    if ok:
        print("backend healthy")
        return 0
    print("backend still unavailable at deadline", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
