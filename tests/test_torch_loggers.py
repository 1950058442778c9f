"""The pluggable loggers of the port (``utils/loggers.py``) against the JAX package's.

* ``JSONLLogger`` writes the JAX logger's records, key for key and value for
  value (the ``_time`` stamps apart), for scalars and for dicts with values
  that are no number.
* ``LoggingManager`` fans every call out to each logger, as the JAX one does.
* A backend that does not import is a no-op: TensorBoard without its package,
  wandb (installed on neither machine).  Where tensorboard imports, the
  TensorBoard logger writes an event file.
"""

import builtins
import importlib
import json

import numpy as np
import pytest

TPU = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu"
JLOG = importlib.import_module(TPU + ".utils.loggers")
TLOG = importlib.import_module(TPU + "_torch.utils.loggers")


def _records(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "_time"} for line in f]


def _drive(mod, root):
    lg = mod.JSONLLogger(str(root))
    lg.log_scalar("loss", 0.5, step=1)
    lg.log_dict({"a": 1.0, "b": "text", "c": np.float32(2.5), "d": None}, step=2)
    mgr = mod.LoggingManager([lg, mod.JSONLLogger(str(root), filename="second.jsonl")])
    mgr.log_scalar("x", 2.0, step=3)
    mgr.log_dict({"y": 3}, step=4)
    mgr.log_histogram("h", np.arange(5), step=4)
    mgr.log_figure("f", None, step=4)
    mgr.finish()
    return _records(root / "metrics.jsonl"), _records(root / "second.jsonl")


def test_jsonl_output_equals_jax(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = _drive(JLOG, tmp_path / "jax")
    got = _drive(TLOG, tmp_path / "torch")
    assert got == want
    assert got[0][0] == {"step": 1, "loss": 0.5} and got[0][1]["b"] == "text"
    assert got[1] == [{"step": 3, "x": 2.0}, {"step": 4, "y": 3.0}]


def test_base_logger_log_dict_skips_what_is_no_number():
    seen = []

    class Probe(TLOG.BaseLogger):
        def log_scalar(self, tag, value, step):
            seen.append((tag, value, step))

    Probe().log_dict({"a": 1, "b": "x", "c": 2.5}, step=7)
    assert seen == [("a", 1.0, 7), ("c", 2.5, 7)]
    with pytest.raises(NotImplementedError):
        TLOG.BaseLogger().log_scalar("a", 1.0, 0)


def test_missing_backends_are_no_ops(tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_tensorboard(name, *a, **k):
        if name.startswith("torch.utils.tensorboard") or name.startswith("wandb"):
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    tb, wb = TLOG.TensorBoardLogger(str(tmp_path / "tb")), TLOG.WandBLogger(name="x")
    assert tb._writer is None and wb._run is None
    for lg in (tb, wb):
        lg.log_scalar("a", 1.0, 0)
        lg.log_dict({"a": 1.0}, 0)
        lg.log_histogram("h", np.arange(3), 0)
        lg.finish()
    assert not (tmp_path / "tb").exists()


def test_tensorboard_writes_events_where_it_imports(tmp_path):
    pytest.importorskip("tensorboard")
    lg = TLOG.TensorBoardLogger(str(tmp_path / "tb"))
    assert lg._writer is not None
    lg.log_scalar("loss", 0.25, 1)
    lg.log_histogram("h", np.arange(5.0), 1)
    lg.finish()
    assert any(p.name.startswith("events.out.tfevents") for p in (tmp_path / "tb").iterdir())
