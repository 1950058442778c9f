"""SEGNN through the evaluation and search mains, on the CPU.

* ``battery.py --family segnn`` runs ``cli self-feed`` on a run dir of the
  queue's argv (``scripts/queues/tpu_queue48.sh:55-56``) around the committed
  10M checkpoint, its bytes unchanged (cut here to 40 substeps, 3 steps a
  draw, B=2), and scores each draw on both bases; the checkpoint's committed
  batteries (12 draws a seed) read back with the medians their files record.
* ``cli validate`` reads the same run dir, every loss finite.
* ``hpo.run_study("segnn")`` with a stub objective gives the JAX package's
  trial records, widths and parameter counts included, in the
  ``param_small`` and ``free`` modes.

(In a file of its own: the trainer tests patch the dataset class for their
whole module.)
"""

import importlib
import json
import math

import pytest

TPU = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu"
PORT = TPU + "_torch"
battery = importlib.import_module(PORT + ".battery")
cli = importlib.import_module(PORT + ".cli")
restore = importlib.import_module(PORT + ".train.restore")
JH = importlib.import_module(TPU + ".hpo.hpo")
TH = importlib.import_module(PORT + ".hpo.hpo")

CUT = ["--dataloader.gravity_dataset.sim_length", "40"]


def test_battery_scores_the_committed_checkpoint(monkeypatch, tmp_path):
    monkeypatch.setattr(battery, "SEGNN_RUN_ARGV", battery.SEGNN_RUN_ARGV + CUT)
    (r,) = battery.main(["--family", "segnn", "--seeds", "281", "--draws", "2",
                         "--batch-size", "2", "--device", "cpu", "--out", str(tmp_path)])
    assert r["family"] == "segnn" and r["compute_dtype"] == "float32"
    assert r["committed"] is None  # the committed batteries drew B=64
    assert r["checkpoint"] == battery.SEGNN_CKPT and r["survived"] == [3, 3]
    assert all(0 <= p <= 1 for p in r["six"] + r["five"])
    with open(battery.SEGNN_CKPT, "rb") as f:
        assert (tmp_path / "segnn10m" / "model.ckpt").read_bytes() == f.read()
    with open(tmp_path / "segnn10m" / "training_args.json") as f:
        args = json.load(f)["args"]
    assert args["model_type"] == "segnn" and args["num_neighbors"] == 4
    assert args["model_kwargs"] == {"hidden_features": 448, "lmax_attr": 1, "lmax_h": 1,
                                    "num_layers": 6}


@pytest.mark.parametrize("seed", [281, 9272])
def test_the_committed_batteries_read_back(seed):
    c = battery.committed(seed, battery.SEGNN_COMMITTED)
    with open(battery.SEGNN_COMMITTED[seed]) as f:
        recorded = json.load(f)
    assert len(c["six"]) == 12 and c["survived"] == [999] * 12
    spread = battery.spread(c["six"])
    assert spread["median"] == recorded["median_combined_pvalue"]
    assert spread["best"] == recorded["best_combined_pvalue"]
    assert battery.committed(seed, {}) is None


def test_validate_reads_a_segnn_run_dir(monkeypatch, tmp_path):
    run_dir = restore.make_run_dir(str(tmp_path / "run"), battery.SEGNN_RUN_ARGV + CUT + [
        "--dataloader.batch_size", "2"], battery.SEGNN_CKPT)
    result = cli.main(["validate", "--run_dir", run_dir, "--batches", "2", "--device", "cpu"])
    assert all(math.isfinite(v) for v in result.values()) and result["loss"] < 1e-2


def _objective(model_kwargs, trainer_overrides):
    return -abs(math.log(trainer_overrides["learning_rate"] / 0.2))


@pytest.mark.parametrize("mode", ["free", "param_small"])
def test_segnn_study_with_a_stub_objective_equals_jax(tmp_path, mode):
    kw = dict(trials=3, mode=mode, objective_fn=_objective)
    want = JH.run_study("segnn", study_dir=str(tmp_path / "jax"), **kw)
    got = TH.run_study("segnn", study_dir=str(tmp_path / "torch"), **kw)
    name = f"segnn_{mode}_trials.jsonl"
    with open(tmp_path / "torch" / name) as f:
        trec = [json.loads(line) for line in f]
    with open(tmp_path / "jax" / name) as f:
        jrec = [json.loads(line) for line in f]
    strip = [{k: v for k, v in r.items() if k != "seconds"} for r in trec]
    assert strip == [{k: v for k, v in r.items() if k != "seconds"} for r in jrec]
    assert len(trec) == 3 and all(r["n_params"] > 0 for r in trec)
    assert {r["model_kwargs"].get("lmax_h") for r in trec} <= {1, 2}
    assert got["value"] == want["value"]
