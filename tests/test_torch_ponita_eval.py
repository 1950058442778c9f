"""PONITA through the evaluation mains, on the CPU.

``battery.py --family ponita`` runs ``cli self-feed`` on a run dir of the
queue's argv (``scripts/queues/tpu_queue48.sh:63-64``) around the committed
10M checkpoint, its bytes unchanged (cut here to 40 substeps, 3 steps a draw,
B=2), and scores each draw on both bases; ``cli validate`` reads the same run
dir, every loss finite.  (In a file of its own: the trainer tests patch the
dataset class for their whole module.)
"""

import importlib
import math

TPU = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu"
PORT = TPU + "_torch"
battery = importlib.import_module(PORT + ".battery")
cli = importlib.import_module(PORT + ".cli")


def test_battery_scores_the_committed_checkpoint(monkeypatch, tmp_path):
    """``battery.py --family ponita`` runs ``cli self-feed`` on a run dir of the
    queue's argv around the committed checkpoint (here cut to 40 substeps, 3
    steps a draw, B=2, on the CPU)."""
    monkeypatch.setattr(battery, "PONITA_RUN_ARGV", battery.PONITA_RUN_ARGV + [
        "--dataloader.gravity_dataset.sim_length", "40"])
    (r,) = battery.main(["--family", "ponita", "--seeds", "281", "--draws", "2",
                         "--batch-size", "2", "--device", "cpu", "--out", str(tmp_path)])
    assert r["family"] == "ponita" and r["compute_dtype"] == "float32" and r["committed"] is None
    assert r["checkpoint"] == battery.PONITA_CKPT and r["survived"] == [3, 3]
    assert all(0 <= p <= 1 for p in r["five"])
    with open(battery.PONITA_CKPT, "rb") as f:
        assert (tmp_path / "ponita10m" / "model.ckpt").read_bytes() == f.read()


def test_validate_reads_a_ponita_run_dir(monkeypatch, tmp_path):
    monkeypatch.setattr(battery, "PONITA_RUN_ARGV", battery.PONITA_RUN_ARGV + [
        "--dataloader.gravity_dataset.sim_length", "40", "--dataloader.batch_size", "2"])
    restore = importlib.import_module(PORT + ".train.restore")
    run_dir = restore.make_run_dir(str(tmp_path / "run"), battery.PONITA_RUN_ARGV,
                                   battery.PONITA_CKPT)
    result = cli.main(["validate", "--run_dir", run_dir, "--batches", "2", "--device", "cpu"])
    assert result["loss"] < 1e-3 and all(math.isfinite(v) for v in result.values())
