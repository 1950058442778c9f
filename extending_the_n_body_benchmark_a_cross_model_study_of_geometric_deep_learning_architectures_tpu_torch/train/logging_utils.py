"""Run logging: counterpart of the JAX package's ``train/logging_utils.py``.

The sink is an append-only ``metrics.jsonl`` in the run dir, with the same
namespaced keys (``train/*``, ``valid/*``, ``self_feed/*``).  The JAX
package mirrors to wandb where it is installed; wandb is not installed beside
the port, so nothing is mirrored.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict


class MetricsLogger:
    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, "metrics.jsonl")

    def log(self, payload: Dict[str, Any]) -> None:
        record = {"_time": time.time()}
        for k, v in payload.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = v
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def alert(self, title: str, text: str) -> None:
        self.log({"alert/title": title, "alert/text": text})


class RunningMean:
    """Mean of the values given to ``update``."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    def update(self, value) -> None:
        self.total += float(value)
        self.count += 1

    def compute(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def reset(self) -> None:
        self.total, self.count = 0.0, 0
