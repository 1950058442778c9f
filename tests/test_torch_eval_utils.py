"""The port's device and profiling helpers (``utils/device.py``,
``utils/profiling.py``): their CPU behaviour here; on the card they time with
CUDA events and probe with one small launch."""

import importlib
import os

import pytest
import torch

PORT = ("extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_"
        "architectures_tpu_torch")
D = importlib.import_module(PORT + ".utils.device")
P = importlib.import_module(PORT + ".utils.profiling")


def test_get_device_resolves_the_cpu_and_refuses_a_missing_card():
    assert D.get_device("cpu") == torch.device("cpu") == D.get_device(-1)
    assert D.get_device("cuda:3") == torch.device("cuda", 3)
    if torch.cuda.device_count() == 0:
        for spec in ("auto", None, 0, "0"):
            with pytest.raises(RuntimeError, match="cpu"):
                D.get_device(spec)
        assert D.describe_devices() == ""
    else:
        assert D.get_device("auto") == torch.device("cuda", 0)


def test_backend_probe_on_the_cpu_and_without_a_card():
    assert D.backend_healthy(probe_timeout_s=120, platform="cpu")
    assert D.backend_healthy(probe_timeout_s=120) == torch.cuda.is_available()


def test_wait_for_backend_retries_until_the_probe_succeeds(monkeypatch):
    answers = iter([False, False, True])
    monkeypatch.setattr(D, "backend_healthy", lambda **k: next(answers))
    monkeypatch.setattr(D.time, "sleep", lambda s: None)
    assert D.wait_for_backend(max_wait_s=60, poll_s=1)
    monkeypatch.setattr(D, "backend_healthy", lambda **k: False)
    assert not D.wait_for_backend(max_wait_s=0, poll_s=1)


def test_time_fn_on_the_cpu_returns_its_fields():
    calls = []
    x = torch.ones(64, 64)
    out = P.time_fn(lambda a: calls.append(1) or a @ a, x, warmup=2, iters=4)
    assert len(calls) == 6
    assert set(out) == {"mean_s", "median_s", "min_s", "max_s", "iters"} and out["iters"] == 4
    assert 0 <= out["min_s"] <= out["median_s"] <= out["max_s"]
    assert out["min_s"] <= out["mean_s"] <= out["max_s"]


def test_trace_writes_a_profile(tmp_path):
    with P.trace(str(tmp_path)) as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    assert prof is not None
    assert any(n.endswith(".pt.trace.json") for n in os.listdir(tmp_path))
