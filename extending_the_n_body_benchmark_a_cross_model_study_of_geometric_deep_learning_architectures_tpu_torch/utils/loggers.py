"""Pluggable loggers: counterpart of the JAX package's ``utils/loggers.py``
(``BaseLogger``, ``JSONLLogger``, ``TensorBoardLogger``, ``WandBLogger``,
``LoggingManager``).

The trainer's own sink is the JSONL stream of ``train/logging_utils.py``;
these classes give code that wants scalar, histogram or figure logging a
fan-out over several backends.  TensorBoard (``torch.utils.tensorboard``)
and wandb are optional: a backend that does not import becomes a no-op.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional


class BaseLogger:
    def log_scalar(self, tag: str, value: float, step: int) -> None:
        raise NotImplementedError

    def log_histogram(self, tag: str, values, step: int) -> None:
        pass

    def log_figure(self, tag: str, figure, step: int) -> None:
        pass

    def log_dict(self, payload: Dict[str, Any], step: int) -> None:
        for k, v in payload.items():
            try:
                self.log_scalar(k, float(v), step)
            except (TypeError, ValueError):
                pass

    def finish(self) -> None:
        pass


class JSONLLogger(BaseLogger):
    """Append-only JSONL metric stream (the default sink)."""

    def __init__(self, log_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)

    def log_scalar(self, tag, value, step):
        with open(self.path, "a") as f:
            f.write(json.dumps({"_time": time.time(), "step": step, tag: value}) + "\n")

    def log_dict(self, payload, step):
        rec = {"_time": time.time(), "step": step}
        for k, v in payload.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


class TensorBoardLogger(BaseLogger):
    """TensorBoard events via any available writer implementation."""

    def __init__(self, log_dir: str):
        self._writer = None
        try:  # needs the tensorboard package beside torch
            from .. import _tf32  # noqa: F401  (TF32 off before torch is used)
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir)
        except Exception:
            self._writer = None

    def log_scalar(self, tag, value, step):
        if self._writer is not None:
            self._writer.add_scalar(tag, value, step)

    def log_histogram(self, tag, values, step):
        if self._writer is not None:
            try:
                self._writer.add_histogram(tag, values, step)
            except Exception:
                pass

    def log_figure(self, tag, figure, step):
        if self._writer is not None:
            try:
                self._writer.add_figure(tag, figure, step)
            except Exception:
                pass

    def finish(self):
        if self._writer is not None:
            self._writer.close()


class WandBLogger(BaseLogger):
    def __init__(self, project: str = "nbody", name: Optional[str] = None):
        self._run = None
        try:
            import wandb

            self._run = wandb.init(project=project, name=name, resume="allow")
        except Exception:
            self._run = None

    def log_scalar(self, tag, value, step):
        if self._run is not None:
            self._run.log({tag: value}, step=step)

    def log_dict(self, payload, step):
        if self._run is not None:
            self._run.log(payload, step=step)

    def finish(self):
        if self._run is not None:
            self._run.finish()


class LoggingManager(BaseLogger):
    """Fan-out to several loggers."""

    def __init__(self, loggers: List[BaseLogger]):
        self.loggers = loggers

    def log_scalar(self, tag, value, step):
        for lg in self.loggers:
            lg.log_scalar(tag, value, step)

    def log_histogram(self, tag, values, step):
        for lg in self.loggers:
            lg.log_histogram(tag, values, step)

    def log_figure(self, tag, figure, step):
        for lg in self.loggers:
            lg.log_figure(tag, figure, step)

    def log_dict(self, payload, step):
        for lg in self.loggers:
            lg.log_dict(payload, step)

    def finish(self):
        for lg in self.loggers:
            lg.finish()
