"""The port's HPO (``hpo/hpo.py``, the ``hpo`` main) against the JAX
package's.  Both are host Python with ``random.Random``: the samplers propose
the same points exactly for the same seed and history, and the port
reproduces the committed EGNN-MC studies' sampled parameters, bisected
widths and parameter counts (counted on the meta device) exactly.  The
study loop runs here with stub objectives (resume, pruning, the budget
modes); its default objective trains through the port's trainer, which
``[hpo]`` of ``chip_smoke.py`` drives on the card.
"""

import importlib
import json
import math
import os

import numpy as np
import pytest

TPU = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu"
PORT = TPU + "_torch"
JH = importlib.import_module(TPU + ".hpo.hpo")
TH = importlib.import_module(PORT + ".hpo.hpo")
TCLI = importlib.import_module(PORT + ".cli")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(REPO, "docs", "results")
STUDIES = {"param_small": os.path.join(RESULTS, "hpo_param_small_egnn",
                                       "egnn_mc_param_small_trials.jsonl"),
           "param_medium": os.path.join(RESULTS, "hpo_param_medium_egnn",
                                        "egnn_mc_param_medium_trials.jsonl")}
FAMILIES = ["ponita", "segnn", "equiformer_v2", "cgenn", "graph_transformer", "painn",
            "egnn_mc", "gmn", "no_such_family"]


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.mark.parametrize("family", FAMILIES)
def test_search_space_equals_jax(family):
    assert TH.search_space(family) == JH.search_space(family)


@pytest.mark.parametrize("seed", [0, 3, 17])
def test_tpe_proposes_exactly_the_jax_points(seed):
    """Random start-up points, then density-ratio proposals over a scored
    history: the same points, to the last bit."""
    space = TH.search_space("segnn")
    history = []
    jax_s, port_s = JH.TPESampler(space, seed=seed), TH.TPESampler(space, seed=seed)
    for _ in range(14):
        want, got = jax_s.propose(history), port_s.propose(history)
        assert got == want
        history.append({"params": got, "value": -abs(math.log(got["lr"] / 0.1))})
    assert [port_s.propose(history) for _ in range(3)] == [jax_s.propose(history)
                                                          for _ in range(3)]


def test_tpe_does_not_repropose_exact_good_points():
    space = TH.search_space("egnn_mc")
    sampler = TH.TPESampler(space, seed=3)
    history = [{"params": sampler._random_point(), "value": float(-i)} for i in range(10)]
    seen = {tuple(sorted(h["params"].items())) for h in history}
    assert not any(tuple(sorted(sampler.propose(history).items())) in seen for _ in range(20))


@pytest.mark.parametrize("mode", sorted(STUDIES))
def test_committed_egnn_studies_are_reproduced(mode):
    """Each committed trial: ``suggest_trial`` on the history before it gives
    its sampled parameters, and ``trial_to_overrides`` then
    ``adjust_width_to_target`` its bisected ``model_kwargs`` and ``n_params``
    (trial 1 of param_small: hidden_node_dim 96 -> 240, 1,872,828 params)."""
    records = _records(STUDIES[mode])
    history = []
    for rec in records:
        if rec["number"] == len(history):
            assert TH.suggest_trial("egnn_mc", history) == rec["params"]
        mk, trainer = TH.trial_to_overrides("egnn_mc", rec["params"])
        assert trainer["learning_rate"] == rec["params"]["lr"]
        kwargs, n = TH.adjust_width_to_target("egnn_mc", mk, TH.PARAM_TARGETS[mode])
        assert (kwargs, n) == (rec["model_kwargs"], rec["n_params"])
        if rec["number"] == len(history):
            history.append(rec)
    if mode == "param_small":
        assert records[1]["model_kwargs"]["hidden_node_dim"] == 240
        assert records[1]["n_params"] == 1_872_828


def test_the_hpo_winner_counts_as_committed():
    """``egnn_hpo_winner``: the param_small study's best trial (L6, width 240),
    1,872,828 parameters; the scoreboard's EGNN-MC at the reference size has
    865k (``docs/results/fidelity_n100/README.md``)."""
    with open(os.path.join(RESULTS, "hpo_param_small_egnn",
                           "egnn_mc_param_small_summary.json")) as f:
        best = json.load(f)["best"]
    assert TH._count_params("egnn_mc", best["model_kwargs"], 5) == best["n_params"] == 1_872_828
    default = TH._count_params("egnn_mc", {}, 100)
    assert default == JH._count_params("egnn_mc", {}, 5)
    assert round(default, -3) == 865_000


@pytest.mark.parametrize("width,heads", [(100, 1), (8, 1), (250, 4), (333, 3), (1000, 8)])
@pytest.mark.parametrize("family", ["egnn_mc", "graph_transformer", "equiformer_v2"])
def test_quantize_width_equals_jax(family, width, heads):
    assert TH._quantize_width(family, width, heads) == JH._quantize_width(family, width, heads)


def test_median_pruner_semantics():
    for mod in (TH, JH):
        p = mod.MedianPruner(n_startup_trials=2)
        assert not p.should_prune(1, -100.0)
        p.register({1: 0.0, 2: 1.0})
        p.register({1: 2.0, 2: 3.0})
        assert p.should_prune(1, 0.5)
        assert not p.should_prune(1, 1.0)
        assert not p.should_prune(3, -100.0)
    q = TH.MedianPruner(n_startup_trials=0, n_warmup_steps=5)
    q.register({1: 10.0})
    assert not q.should_prune(1, -1.0)


def _strip(records):
    return [{k: v for k, v in r.items() if k != "seconds"} for r in records]


def _objective(model_kwargs, trainer_overrides):
    return -abs(math.log(trainer_overrides["learning_rate"] / 0.2))


@pytest.mark.parametrize("mode", ["free", "param_small", "time_matched"])
def test_run_study_with_a_stub_objective_equals_jax(tmp_path, mode):
    """The same trial records (widths and parameter counts included) and
    summary as the JAX package's, and a resumed study runs no extra trial."""
    kw = dict(trials=4, mode=mode, objective_fn=_objective)
    want = JH.run_study("egnn_mc", study_dir=str(tmp_path / "jax"), **kw)
    got = TH.run_study("egnn_mc", study_dir=str(tmp_path / "torch"), **kw)
    name = f"egnn_mc_{mode}_trials.jsonl"
    trec, jrec = _records(tmp_path / "torch" / name), _records(tmp_path / "jax" / name)
    assert _strip(trec) == _strip(jrec) and len(trec) == 4
    assert all(r["n_params"] > 0 for r in trec)
    assert {k: v for k, v in got.items() if k != "seconds"} == {
        k: v for k, v in want.items() if k != "seconds"}
    again = TH.run_study("egnn_mc", study_dir=str(tmp_path / "torch"), **kw)
    assert len(_records(tmp_path / "torch" / name)) == 4 and again["value"] == got["value"]
    with open(tmp_path / "torch" / f"egnn_mc_{mode}_summary.json") as f:
        assert json.load(f)["n_trials"] == 4


def test_run_study_prunes_as_jax(tmp_path):
    def make():
        n = [0]

        def objective(model_kwargs, trainer_overrides, report=None):
            n[0] += 1
            val = 1.0 if n[0] <= 2 else -1.0
            report(1, val)
            return val
        return objective

    for mod, d in ((JH, "jax"), (TH, "torch")):
        mod.run_study("egnn_mc", trials=5, study_dir=str(tmp_path / d), objective_fn=make(),
                      pruner=mod.MedianPruner(n_startup_trials=2))
    store = "egnn_mc_free_trials.jsonl"
    trec = _records(tmp_path / "torch" / store)
    assert _strip(trec) == _strip(_records(tmp_path / "jax" / store))
    assert [r["status"] for r in trec] == ["done"] * 2 + ["pruned"] * 3
    with open(tmp_path / "torch" / "egnn_mc_free_summary.json") as f:
        assert json.load(f)["best"]["status"] == "done"
    p2 = TH.MedianPruner(n_startup_trials=2)
    TH.run_study("egnn_mc", trials=5, study_dir=str(tmp_path / "torch"), objective_fn=make(),
                 pruner=p2)
    assert len(p2._trials) == 5


def test_param_mode_without_a_width_knob_fails_the_trial(tmp_path):
    best = TH.run_study("gmn", trials=1, mode="param_small", study_dir=str(tmp_path),
                        objective_fn=lambda mk, tr: 0.0)
    (rec,) = _records(tmp_path / "gmn_param_small_trials.jsonl")
    assert rec["status"] == "failed" and "width knob" in rec["error"] and best is None


def test_base_model_config_is_layered_under_the_samples(tmp_path):
    seen = {}
    TH.run_study("painn", trials=1, mode="free", study_dir=str(tmp_path),
                 base_config={"models": {"painn": {"use_tanh": True}}},
                 objective_fn=lambda mk, tr: seen.update(mk) or 1.0)
    assert seen.get("use_tanh") is True and "hidden_features" in seen


@pytest.mark.parametrize("family", ["schnet"])
def test_a_family_the_port_cannot_build_raises(tmp_path, family):
    """Counting, bisecting or training it raises NotImplementedError naming
    queue 1 item 6; nothing falls back to EGNN-MC."""
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        TH._count_params(family, {}, 5)
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        TH.adjust_width_to_target(family, {"hidden_features": 128, "num_layers": 4}, 1_800_000)
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        TH.run_study(family, trials=1, study_dir=str(tmp_path / "a"), device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        TH.run_study(family, trials=1, mode="param_small", study_dir=str(tmp_path / "b"),
                     objective_fn=_objective)
    assert not os.path.exists(tmp_path / "a" / f"{family}_free_trials.jsonl")


def test_score_run_on_macro_files(tmp_path):
    art = importlib.import_module(PORT + ".metrics.artifacts")
    rng = np.random.default_rng(3)
    loc = rng.normal(size=(8, 40, 5, 3)).cumsum(axis=1) * 0.2
    vel = np.diff(loc, axis=1, prepend=loc[:, :1])
    for step in ("1", "2"):
        art.evaluate_rollout(str(tmp_path / "checkpoints" / step), loc, vel, loc, vel,
                             save_trajectory_npys=False)
    for how in ("best", "mean", "median"):
        got = TH.score_run(str(tmp_path), mode=how)
        assert got == JH.score_run(str(tmp_path), mode=how) and got > math.log(1e-300)
    assert TH.score_run(str(tmp_path / "none")) == math.log(1e-300)


def test_hpo_main_trains_a_trial_on_the_cpu(tmp_path, monkeypatch):
    """The ``hpo`` main at a tiny size: one trial through the port's trainer,
    scored from its checkpoints."""
    monkeypatch.chdir(tmp_path)
    best = TCLI.main(["hpo", "--model_type", "egnn_mc", "--trials", "1", "--device", "cpu",
                      "--train_epochs", "2", "--steps_per_epoch", "2",
                      "--self_feed_limit_steps", "6", "--batch_size", "4", "--sim_length", "100",
                      "--study_dir", "study"])
    assert best["status"] == "done" and math.isfinite(best["value"]) and best["n_params"] > 0
    assert best["steps_per_min"] > 0 and "peak_hbm_mb" not in best
    assert (tmp_path / "study" / "egnn_mc_free_summary.json").exists()
