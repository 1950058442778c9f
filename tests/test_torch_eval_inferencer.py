"""The port's ``Inferencer`` and per-layer statistics against the JAX
package's, on one run dir the port's trainer wrote on the CPU (EGNN-MC, 2
layers, width 16, N=5, B=4, float64 scenes).

* ``Inferencer.predict`` on the run's training graph and a 10-step
  ``rollout`` (fully connected) from the same scene: within 1e-10 relative of
  the JAX package's ``Inferencer`` in float64.
* The layer statistics of one forward pass: the port's record has the keys
  the JAX trainer's ``capture_intermediates`` gives (``debug/<flax
  path>.absmax|std|nan_or_inf``, top-level paths), values within 1e-10 on the
  same parameters and scene; ``summarize`` is equal on the same JSONL; and
  ``debug_layer_stats_every`` in a CPU training run writes the file.
"""

import importlib
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

TPU = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu"
PORT = TPU + "_torch"
JI = importlib.import_module(TPU + ".rollout.inferencer")
TI = importlib.import_module(PORT + ".rollout.inferencer")
JT = importlib.import_module(TPU + ".train.trainer")
JR = importlib.import_module(TPU + ".train.restore")
JLS = importlib.import_module(TPU + ".evaluation.layer_stats")
TLS = importlib.import_module(PORT + ".evaluation.layer_stats")
JOTF = importlib.import_module(TPU + ".data.gravity_otf")
JScene = importlib.import_module(TPU + ".core.scene").Scene
TScene = importlib.import_module(PORT + ".core.scene").Scene
tgraph = importlib.import_module(PORT + ".core.graph")
physics = importlib.import_module(PORT + ".core.physics")
TCLI = importlib.import_module(PORT + ".cli")

B, N = 4, 5
ARGV = ["--device", "cpu", "--model.num_layers", "2", "--model.hidden_node_dim", "16",
        "--model.hidden_edge_dim", "16", "--model.hidden_coord_dim", "16",
        "--dataloader.batch_size", str(B), "--dataloader.gravity_dataset.sim_length", "200",
        "--dataloader.seed", "2", "--dataloader.double_precision", "true",
        "--dataloader.num_neighbors", "3", "--trainer.precision_mode", "double",
        "--trainer.steps_per_epoch", "4", "--trainer.train_steps", "2",
        "--trainer.test_macros_every", "1000", "--trainer.seed", "0",
        "--trainer.debug_layer_stats_every", "2"]
RTOL = 1e-10


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The port's training run (it logs layer stats), and one float64 scene."""
    root = tmp_path_factory.mktemp("inferencer")
    cwd = os.getcwd()
    try:
        os.chdir(root)
        trainer = TCLI.main(["train", *ARGV])
    finally:
        os.chdir(cwd)
    loc, vel, force, mass = physics.sample_trajectory_batch(
        B, N, T=200, sample_freq=10, dtype=torch.float64, device="cpu",
        generator=torch.Generator().manual_seed(9))
    f = 3
    arrays = tuple(t.numpy() for t in (loc[:, f], vel[:, f], force[:, f], mass))
    return SimpleNamespace(dir=str(root / trainer.save_dir_path), arrays=arrays,
                           trainer=trainer)


def _scenes(arrays):
    return JScene(*arrays), TScene(*(torch.from_numpy(a.copy()) for a in arrays))


def _jax_inferencer(run_dir, monkeypatch):
    # the JAX dataset's constructor draws a batch; nothing here reads it
    monkeypatch.setattr(JOTF.GravityDatasetOtf, "_load_next_batch", lambda self: None)
    return JI.Inferencer(run_dir)


def test_predict_matches_jax(run, monkeypatch):
    jinf, tinf = _jax_inferencer(run.dir, monkeypatch), TI.Inferencer(run.dir, device="cpu")
    assert tinf.num_neighbors == jinf.num_neighbors == 3
    assert (tinf.train_mode, tinf.matmul_precision) == (jinf.train_mode, jinf.matmul_precision)
    js, ts = _scenes(run.arrays)
    want = np.asarray(jinf.predict(js))
    got = tinf.predict(ts).numpy()
    assert got.shape == (B, N, 6) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_rollout_matches_jax(run, monkeypatch):
    jinf, tinf = _jax_inferencer(run.dir, monkeypatch), TI.Inferencer(run.dir, device="cpu")
    js, ts = _scenes(run.arrays)
    jloc, jvel, jsurv = jinf.rollout(js, num_steps=10)
    tloc, tvel, tsurv = tinf.rollout(ts, num_steps=10)
    assert tloc.shape == (B, 10, N, 3) and tsurv == jsurv == 9
    for got, want in ((tloc, jloc), (tvel, jvel)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    # one rollout function per (num_steps, num_neighbors), reused
    tinf.rollout(ts, num_steps=10)
    tinf.rollout(ts, num_steps=10, num_neighbors=3)
    assert set(tinf._rollouts) == {(10, None), (10, 3)}


def test_evaluate_scores_a_fresh_rollout(run, tmp_path):
    tinf = TI.Inferencer(run.dir, device="cpu")
    out = tinf.evaluate(num_steps=8)
    assert set(out) == {"steps_survived", "per_macro", "combined"} and 0 < out["combined"] <= 1
    saved = tinf.evaluate(num_steps=8, save_dir=str(tmp_path / "eval"))
    assert (tmp_path / "eval" / "sticking_distributions.json").exists()
    assert saved["steps_survived"] == 7


def _jax_layer_stats(run_dir, scene):
    """The JAX trainer's layer-stats function, on the run's parameters as the
    JAX package loads them."""
    model, params, _, _ = JR.load_run(run_dir)
    stand_in = SimpleNamespace(model=model, num_neighbors=3, _data_masks=False)
    fn = JT.Trainer._build_layer_stats_fn(stand_in)
    return {f"debug/{k}": float(v) for k, v in fn(params, scene).items()}


def test_layer_stats_record_matches_jax(run, monkeypatch):
    monkeypatch.setattr(JOTF.GravityDatasetOtf, "_load_next_batch", lambda self: None)
    js, ts = _scenes(run.arrays)
    want = _jax_layer_stats(run.dir, js)
    tinf = TI.Inferencer(run.dir, device="cpu")
    tinf.model.train()
    stats = TLS.capture(tinf.model, ts, tgraph.knn_mask(ts.pos, 3))
    got = TLS.record(7, stats)
    assert got.pop("step") == 7
    assert set(got) == set(want) and "debug/MLP_1/TorchLinear_2.std" in got and "debug/.absmax" in got
    for k, w in want.items():
        assert got[k] == pytest.approx(w, rel=RTOL, abs=1e-300), k
    assert tinf.model.training  # the mode it had before
    assert all(not any(m._forward_hooks) for m in tinf.model.modules())


def test_training_writes_layer_stats(run):
    """``debug_layer_stats_every 2`` over 2 epochs of 4 steps: records at steps
    0 and 2 of each epoch, stamped with the epoch, with the JAX keys."""
    with open(os.path.join(run.dir, "layer_stats.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [0, 0, 1, 1]
    keys = {k for k in records[0] if k != "step"}
    assert {"debug/TorchLinear_0.absmax", "debug/TorchLinear_0/Dense_0.std",
            "debug/MLP_0.nan_or_inf", "debug/.std"} <= keys and len(keys) == 3 * 11
    assert all(np.isfinite(v) for r in records for v in r.values())


def test_summarize_matches_jax(tmp_path):
    recs = [
        {"step": 0, "debug/a.absmax": 1.0, "debug/a.std": 0.5, "debug/a.nan_or_inf": 0.0,
         "debug/MLP_0/TorchLinear_1.absmax": 2.0, "debug/MLP_0/TorchLinear_1.nan_or_inf": 0.0},
        {"step": 4, "debug/a.absmax": 9.0, "debug/a.std": 2.0, "debug/a.nan_or_inf": 0.0,
         "debug/MLP_0/TorchLinear_1.absmax": 50.0, "debug/MLP_0/TorchLinear_1.nan_or_inf": 1.0},
        {"step": 2, "debug/.absmax": 3.0, "debug/.nan_or_inf": 1.0},
    ]
    (tmp_path / "layer_stats.jsonl").write_text("\n".join(json.dumps(r) for r in recs))
    got = TLS.summarize(TLS.load_layer_stats(str(tmp_path)))
    assert got == JLS.summarize(JLS.load_layer_stats(str(tmp_path)))
    assert got["first_nan_step"] == 2 and got["first_nan_layer"] == ""
    assert TLS.main([str(tmp_path)])["num_records"] == 3
    with pytest.raises(FileNotFoundError):
        TLS.load_layer_stats(str(tmp_path / "missing"))
