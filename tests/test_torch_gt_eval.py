"""GraphTransformer through the battery and the evaluation mains, on the CPU.

* ``battery.py --family graph_transformer`` runs ``cli self-feed`` on a run
  dir of the queue's argv (``scripts/queues/tpu_queue48.sh:58-60``) around
  the committed 10M checkpoint, its bytes unchanged (cut here to 40
  substeps, 3 steps a draw, B=2), in training mode with live dropout, and
  scores each draw on both bases; the same seed gives the same draws.
* The checkpoint's committed batteries (12 draws a seed, ``train_mode``
  on) read back on the six-macro basis with the medians their files record:
  their ``combined_pvalue`` is the Fisher combine of the six macros scored
  at N=5, ``stuck_cluster_size`` left out.
* ``cli validate`` reads the same run dir, every loss finite.
* ``rollout_trace`` knows the family, at the committed run's shape.
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
ks = importlib.import_module(PORT + ".metrics.ks")
trace = importlib.import_module(PORT + ".rollout_trace")

CUT = ["--dataloader.gravity_dataset.sim_length", "40"]


def test_battery_scores_the_committed_checkpoint(monkeypatch, tmp_path):
    monkeypatch.setattr(battery, "GT_RUN_ARGV", battery.GT_RUN_ARGV + CUT)
    runs = []
    for out in ("a", "b"):
        (r,) = battery.main(["--family", "graph_transformer", "--seeds", "281", "--draws", "2",
                             "--batch-size", "2", "--device", "cpu", "--out",
                             str(tmp_path / out)])
        runs.append(r)
    r = runs[0]
    assert r["family"] == "graph_transformer" and r["compute_dtype"] == "float32"
    assert r["committed"] is None  # the committed batteries drew B=64
    assert r["checkpoint"] == battery.GT_CKPT and r["survived"] == [3, 3]
    assert all(0 <= p <= 1 for p in r["six"] + r["five"])
    assert runs[1]["six"] == r["six"] and runs[1]["five"] == r["five"]
    with open(battery.GT_CKPT, "rb") as f:
        assert (tmp_path / "a" / "graph_transformer10m" / "model.ckpt").read_bytes() == f.read()
    with open(tmp_path / "a" / "graph_transformer10m" / "training_args.json") as f:
        args = json.load(f)["args"]
    assert args["model_type"] == "graph_transformer" and args["self_feed_train_mode"] is True
    assert args["model_kwargs"] == {"hidden_features": 248, "num_layers": 8, "num_heads": 8}


@pytest.mark.parametrize("seed", [281, 9272])
def test_the_committed_batteries_read_back(seed):
    c = battery.committed(seed, battery.GT_COMMITTED)
    with open(battery.GT_COMMITTED[seed]) as f:
        recorded = json.load(f)
    assert recorded["train_mode"] is True and recorded["seed"] == seed
    assert len(c["six"]) == 12 and c["survived"] == [999] * 12
    spread = battery.spread(c["six"])
    assert spread["median"] == recorded["median_combined_pvalue"]
    assert spread["best"] == recorded["best_combined_pvalue"]
    for d in recorded["draws"]:
        per = {k: v for k, v in d["per_macro"].items() if k != "stuck_cluster_size"}
        assert len(per) == 6
        assert math.isclose(ks.fisher_combine(list(per.values())), d["combined_pvalue"],
                            rel_tol=1e-9)


def test_validate_reads_a_gt_run_dir(tmp_path):
    run_dir = restore.make_run_dir(str(tmp_path / "run"), battery.GT_RUN_ARGV + CUT + [
        "--dataloader.batch_size", "2"], battery.GT_CKPT)
    result = cli.main(["validate", "--run_dir", run_dir, "--batches", "2", "--device", "cpu"])
    assert all(math.isfinite(v) for v in result.values()) and result["loss"] < 1e-1


def test_rollout_trace_knows_the_family():
    ckpt, b, n, substeps, shape, configs = trace.FAMILIES["graph_transformer"]
    assert ckpt == battery.GT_CKPT and (b, n, substeps) == (64, 5, 10000)
    assert shape == {"num_layers": 8, "hidden_features": 248, "num_heads": 8}
    assert [c[2] for c in configs] == [True]  # the evaluation's training mode
