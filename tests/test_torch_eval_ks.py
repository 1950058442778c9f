"""The port's checkpoint KS ranking (``evaluation/ks_checkpoints.py`` and the
``ks-test`` main) against the JAX package's, on run dirs with crafted macro
JSONs (the cases of ``tests/test_evaluation.py`` that touch these
functions) and on a run dir the port's trainer wrote.  Everything here is
host-side numpy and scipy on the same files: the two packages' summaries,
CSVs and p-values are equal (1e-12 relative, in practice exactly).
"""

import csv
import importlib
import json
import os
import time

import numpy as np
import pytest

TPU = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu"
PORT = TPU + "_torch"
JK = importlib.import_module(TPU + ".evaluation.ks_checkpoints")
TK = importlib.import_module(PORT + ".evaluation.ks_checkpoints")
TART = importlib.import_module(PORT + ".metrics.artifacts")
TCLI = importlib.import_module(PORT + ".cli")

RTOL = 1e-12


def _fake_checkpoint(dirpath, shift=0.0, seed=0, energy_p=0.5, group_nan=False):
    """Macro and energy artifacts of a synthetic rollout pair (the JAX tests'
    fixture), written by the port.  ``group_nan`` blanks the group macro, as
    above the N gate."""
    rng = np.random.default_rng(seed)
    loc = rng.normal(size=(8, 40, 5, 3)).cumsum(axis=1) * 0.2
    vel = np.diff(loc, axis=1, prepend=loc[:, :1])
    TART.evaluate_rollout(dirpath, loc, vel, loc + shift, vel, save_trajectory_npys=False)
    TART.write_energy_metrics_json(
        dirpath,
        {"simulation": {"total": np.ones(40), "potential": np.ones(40), "kinetic": np.zeros(40)},
         "self_feed": {"total": np.ones(40) * (1 + shift), "potential": np.ones(40),
                       "kinetic": np.zeros(40)}},
        {"energy_total": energy_p, "energy_potential": energy_p, "energy_kinetic": energy_p},
        energy_p,
    )
    if group_nan:
        path = os.path.join(dirpath, "group_collision_distribution.json")
        with open(path) as f:
            data = json.load(f)
        for side in data.values():
            side["group_collision_count"] = [float("nan")] * len(side["group_collision_count"])
        with open(path, "w") as f:
            json.dump(data, f)


def _close(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b)
    elif isinstance(a, float):
        assert b == pytest.approx(a, rel=RTOL, abs=1e-300)
    else:
        assert a == b


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("include_energy", [True, False])
@pytest.mark.parametrize("energy_p", [0.5, 1e-300, 0.0])
@pytest.mark.parametrize("group_nan", [False, True])
def test_load_checkpoint_pvalues_matches(tmp_path, include_energy, energy_p, group_nan):
    """Both bases; an energy p of exactly 0.0 is left out of the HPO combine
    while a clamped 1e-300 is kept; stuck_cluster_size joins the combine only
    where the group macro is NaN."""
    ck = str(tmp_path / "ck")
    _fake_checkpoint(ck, shift=0.3, seed=3, energy_p=energy_p, group_nan=group_nan)
    got = TK.load_checkpoint_pvalues(ck, include_energy=include_energy)
    want = JK.load_checkpoint_pvalues(ck, include_energy=include_energy)
    _close(got, want)
    per, combined = got
    assert per["energy_total"] == energy_p  # reported either way
    assert np.isnan(per["group_collision_count"]) == group_nan
    if include_energy and energy_p == 1e-300:
        assert combined <= 1e-100
    combined_over = [k for k in TK.SCORED_MACROS if per[k] == per[k]]
    combined_over += ["stuck_cluster_size"] if group_nan else []
    combined_over += TK.ENERGY_KEYS if include_energy and energy_p > 0 else []
    assert TK.fisher_combine([per[k] for k in combined_over]) == combined


def test_checkpoint_ranking_matches(tmp_path):
    run = tmp_path / "run"
    _fake_checkpoint(str(run / "checkpoints" / "10"), shift=0.0, seed=1)
    _fake_checkpoint(str(run / "checkpoints" / "20"), shift=5.0, seed=2)
    os.makedirs(run / "checkpoints" / "30")  # killed before its evaluation: no artifacts
    os.makedirs(run / "checkpoints" / "notes")
    got = TK.evaluate_run_checkpoints(str(run), plot=False)
    t_csv, t_json = _rows(run / "ks_results.csv"), json.load(open(run / "ks_summary.json"))
    want = JK.evaluate_run_checkpoints(str(run), plot=False)
    j_csv, j_json = _rows(run / "ks_results.csv"), json.load(open(run / "ks_summary.json"))
    _close(got, want)
    _close(t_json, j_json)
    assert t_csv == j_csv
    assert got["num_checkpoints"] == 3 and got["best_checkpoint"] == 10
    assert np.isnan(got["results"][-1]["combined_pvalue"])


def test_scoring_bases_published_vs_hpo(tmp_path):
    ck = tmp_path / "checkpoints" / "10"
    _fake_checkpoint(str(ck), shift=0.0, seed=3, energy_p=1e-300)
    per_pub, comb_pub = TK.load_checkpoint_pvalues(str(ck), include_energy=False)
    per_hpo, comb_hpo = TK.load_checkpoint_pvalues(str(ck), include_energy=True)
    assert comb_pub > 0.01 and comb_hpo <= 1e-100
    assert per_pub["energy_total"] == 1e-300
    summary = TK.evaluate_run_checkpoints(str(tmp_path), plot=False)
    assert summary["best_combined_pvalue"] == comb_pub
    _close((per_pub, comb_pub), JK.load_checkpoint_pvalues(str(ck), include_energy=False))


def test_combined_pvalues_report_matches(tmp_path):
    runs = []
    for i, shift in enumerate((0.0, 2.0)):
        run = tmp_path / "runs" / "egnn_mc" / f"ts{i}"
        _fake_checkpoint(str(run / "checkpoints" / "5"), shift=shift, seed=i)
        _fake_checkpoint(str(run / "checkpoints" / "15"), shift=shift + 0.2, seed=i + 7)
        runs.append(str(run))
    runs.append(str(tmp_path / "runs" / "egnn_mc" / "empty"))  # no checkpoints/: skipped
    got = TK.combined_pvalues_report(runs, str(tmp_path / "t" / "summary.csv"), plot=False)
    want = JK.combined_pvalues_report(runs, str(tmp_path / "j" / "summary.csv"), plot=False)
    _close(got, want)
    assert len(got) == 2 and got[0]["model"] == "egnn_mc"
    assert _rows(tmp_path / "t" / "summary.csv") == _rows(tmp_path / "j" / "summary.csv")


def test_time_cutoff_report_matches(tmp_path):
    t0 = time.time()
    run, empty, none = tmp_path / "run", tmp_path / "empty", tmp_path / "none"
    for d in (run, empty, none):
        d.mkdir()
    with open(run / "metrics.jsonl", "w") as f:
        for r in ({"_time": t0, "train/loss": 1.0}, {"_time": t0 + 100, "self_feed/step": 9},
                  {"_time": t0 + 3600, "self_feed/step": 19},
                  {"_time": t0 + 7200, "self_feed/step": 29}):
            f.write(json.dumps(r) + "\n")
    (empty / "metrics.jsonl").write_text("")
    paths = [str(run), str(empty), str(none)]
    got = TK.time_cutoff_report(paths, hours=1.0, out_json=str(tmp_path / "t.json"))
    want = JK.time_cutoff_report(paths, hours=1.0, out_json=str(tmp_path / "j.json"))
    assert got == want == {str(run): 20}
    assert json.load(open(tmp_path / "t.json")) == json.load(open(tmp_path / "j.json"))


def test_gt_baseline_pvalues_from_the_same_batches():
    rng = np.random.default_rng(5)
    batches = [rng.normal(size=(6, 30, 5, 3)).cumsum(axis=1) * 0.3 for _ in range(4)]

    class Served:
        def __init__(self):
            self.queue = list(batches)

        def get_ground_truth_trajectories(self, batch_size=None):
            loc = self.queue.pop(0)
            return loc, np.diff(loc, axis=1, prepend=loc[:, :1]), None, None

    got = TK.gt_baseline_pvalues(Served(), n_pairs=2)
    want = JK.gt_baseline_pvalues(Served(), n_pairs=2)
    _close(got, want)


def test_ks_test_main_on_a_port_run_dir(tmp_path, monkeypatch, capsys):
    """The port's trainer writes the macro JSONs and energy record that the
    ranking reads; ``ks-test`` ranks them as the JAX package's main does,
    with the GT-vs-GT floor drawn on the CPU for ``--baseline``, and the
    multi-run form writes the summary CSV."""
    monkeypatch.chdir(tmp_path)
    trainer = TCLI.main(["train", "--device", "cpu", "--model.num_layers", "1",
                         "--model.hidden_node_dim", "8", "--model.hidden_edge_dim", "8",
                         "--model.hidden_coord_dim", "8", "--dataloader.batch_size", "4",
                         "--dataloader.gravity_dataset.sim_length", "200",
                         "--trainer.steps_per_epoch", "2", "--trainer.train_steps", "2",
                         "--trainer.test_macros_every", "1", "--trainer.self_feed_limit_steps",
                         "10", "--dataloader.seed", "1", "--trainer.seed", "0"])
    run = trainer.save_dir_path
    got = TCLI.main(["ks-test", run, "--baseline", "--hours", "1", "--device", "cpu"])
    want = JK.evaluate_run_checkpoints(run, plot=False)
    for k in ("num_checkpoints", "best_checkpoint", "best_combined_pvalue", "results"):
        _close(got[k], want[k])
    assert got["num_checkpoints"] == 2 and len(got["gt_baseline_pvalues"]) == 5
    assert all(0 < p <= 1 for p in got["gt_baseline_pvalues"])
    out = capsys.readouterr().out
    assert f"best checkpoint: {got['best_checkpoint']}" in out and "max checkpoint in 1.0h" in out
    rows = TCLI.main(["ks-test", run, "--multi-out", str(tmp_path / "multi.csv")])
    assert len(rows) == 1 and rows[0]["best_combined_pvalue"] == got["best_combined_pvalue"]
    assert (tmp_path / "multi.csv").exists()
