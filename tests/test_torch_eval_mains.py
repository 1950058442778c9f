"""The port's ``self-feed`` and ``validate`` mains against the JAX package's
``self_feed_main`` and ``validate_main``, on one run dir the port's trainer
wrote on the CPU (EGNN-MC, 2 layers, width 16, N=5, B=4, float64, one epoch
of three steps).

Both mains draw their own GT and batches: here both packages' datasets serve
the same numpy arrays in the same order.  Tolerances: trajectories and
losses in float64 agree to 1e-10 relative; the macros computed from them are
then the same counts, and their KS and Fisher p-values (host numpy and
scipy) agree to 1e-12.

Also here: the NaN-safe best and median of a battery on crafted draws, the
resolution of ``--train_mode`` and ``--matmul_precision``, ``load_run``
keeping a float64 checkpoint in float64 (F4), ``make_run_dir`` around the
committed checkpoint, and the CLI's dispatch.
"""

import contextlib
import importlib
import io
import json
import os
import shutil
import statistics

import jax
import numpy as np
import pytest
import torch

TPU = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu"
PORT = TPU + "_torch"
JCLI = importlib.import_module(TPU + ".cli")
TCLI = importlib.import_module(PORT + ".cli")
JOTF = importlib.import_module(TPU + ".data.gravity_otf")
TOTF = importlib.import_module(PORT + ".data.gravity_otf")
JR = importlib.import_module(TPU + ".train.restore")
TR = importlib.import_module(PORT + ".train.restore")
JLOSS = importlib.import_module(TPU + ".train.losses")
JART = importlib.import_module(TPU + ".metrics.artifacts")
TART = importlib.import_module(PORT + ".metrics.artifacts")
JROLL = importlib.import_module(TPU + ".rollout")
TSF = importlib.import_module(PORT + ".rollout.self_feed")
TT = importlib.import_module(PORT + ".train.trainer")
JScene = importlib.import_module(TPU + ".core.scene").Scene
TScene = importlib.import_module(PORT + ".core.scene").Scene
physics = importlib.import_module(PORT + ".core.physics")
tmodels = importlib.import_module(PORT + ".models")
weights = importlib.import_module(PORT + ".weights")
TCK = importlib.import_module(PORT + ".train.checkpoint")
battery = importlib.import_module(PORT + ".battery")

B, N, FRAMES = 4, 5, 20
TRAIN_ARGV = ["--device", "cpu", "--model.num_layers", "2", "--model.hidden_node_dim", "16",
              "--model.hidden_edge_dim", "16", "--model.hidden_coord_dim", "16",
              "--dataloader.batch_size", str(B), "--dataloader.gravity_dataset.sim_length",
              str(FRAMES * 10), "--dataloader.seed", "3", "--dataloader.double_precision", "true",
              "--trainer.precision_mode", "double", "--trainer.steps_per_epoch", "3",
              "--trainer.train_steps", "1", "--trainer.test_macros_every", "1",
              "--trainer.self_feed_limit_steps", "12", "--trainer.seed", "0"]
P_RTOL, X_RTOL = 1e-12, 1e-10


def _batches(count, seed):
    gen = torch.Generator().manual_seed(seed)
    return [tuple(t.numpy() for t in physics.sample_trajectory_batch(
        B, N, T=FRAMES * 10, sample_freq=10, dtype=torch.float64, device="cpu", generator=gen))
        for _ in range(count)]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("mains")
    cwd = os.getcwd()
    try:
        os.chdir(root)
        trainer = TCLI.main(["train", *TRAIN_ARGV])
        return str(root / trainer.save_dir_path)
    finally:
        os.chdir(cwd)


def _serve_gt(monkeypatch, batches):
    """Both dataset classes serve ``batches`` from
    ``get_ground_truth_trajectories``; the JAX constructor's own draw is a
    stand-in."""
    queues = {"jax": list(batches), "torch": list(batches)}
    stand_in = dict(zip(("loc", "vel", "force", "mass"), batches[0]))
    monkeypatch.setattr(JOTF.GravityDatasetOtf, "generate_trajectories", lambda self, bs: stand_in)
    monkeypatch.setattr(JOTF.GravityDatasetOtf, "get_ground_truth_trajectories",
                        lambda self, bs=None: queues["jax"].pop(0))
    monkeypatch.setattr(TOTF.GravityDatasetOtf, "get_ground_truth_trajectories",
                        lambda self, bs=None: tuple(torch.from_numpy(a.copy())
                                                    for a in queues["torch"].pop(0)))
    return queues


def _close(a, b, rtol=P_RTOL):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k], rtol)
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, rtol)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b)
    elif isinstance(a, float):
        assert b == pytest.approx(a, rel=rtol, abs=1e-300)
    else:
        assert a == b


# ---------------------------------------------------------------- self-feed

def test_self_feed_main_matches_jax(run_dir, tmp_path, monkeypatch):
    """``--steps 10 --draws 3`` on the same GT: the same files, keys, survived
    steps and p-values; the trajectories within 1e-10."""
    queues = _serve_gt(monkeypatch, _batches(3, seed=1))
    argv = ["--run_dir", run_dir, "--steps", "10", "--draws", "3", "--seed", "4"]
    JCLI.self_feed_main(argv + ["--out", str(tmp_path / "jax")])
    got = TCLI.main(["self-feed", *argv, "--out", str(tmp_path / "torch"), "--device", "cpu"])
    assert queues == {"jax": [], "torch": []}
    with open(tmp_path / "jax" / "self_feed_draws.json") as f:
        want = json.load(f)
    with open(tmp_path / "torch" / "self_feed_draws.json") as f:
        written = json.load(f)
    _close(written, want)
    _close(json.loads(json.dumps(got)), want)
    assert [d["steps_survived"] for d in written["draws"]] == [9, 9, 9]
    for i in range(3):
        d = f"draw_{i:02d}"
        assert sorted(os.listdir(tmp_path / "torch" / d)) == sorted(
            n for n in os.listdir(tmp_path / "jax" / d) if not n.endswith(".png"))
        traj = os.path.join(d, "trajectories_data")
        for name in ("loc_pred_sim_0.npy", "vel_pred_sim_3.npy"):
            w = np.load(tmp_path / "jax" / traj / name)
            np.testing.assert_allclose(np.load(tmp_path / "torch" / traj / name), w,
                                       rtol=X_RTOL, atol=X_RTOL * np.abs(w).max())


def _stub_rollouts(monkeypatch, combined, captured):
    """Both mains' rollouts and scoring replaced: draw ``i`` scores
    ``combined[i]`` (its per-macro values follow it); ``captured`` collects
    what each rollout was asked for."""
    per = lambda p: {"collision_histogram": p, "group_collision_count": float("nan")}  # noqa: E731

    def rollout(pkg):
        def fn(*a, **k):
            captured.append((pkg, k.get("train_mode"), k.get("matmul_precision"),
                             torch.backends.cuda.matmul.allow_tf32))
            return None, None, None, None, 7
        return fn

    def evaluate(pkg):
        calls = iter(range(len(combined)))

        def fn(save_dir, *a, **k):
            os.makedirs(save_dir, exist_ok=True)
            p = combined[next(calls)]
            return per(p), p, None, None
        return fn

    monkeypatch.setattr(JROLL, "run_self_feed", rollout("jax"))
    monkeypatch.setattr(TSF, "run_self_feed", rollout("torch"))
    monkeypatch.setattr(JART, "evaluate_rollout", evaluate("jax"))
    monkeypatch.setattr(TART, "evaluate_rollout", evaluate("torch"))


@pytest.mark.parametrize("combined", [
    [float("nan"), 1e-5, 0.3, 2e-3],
    [float("nan"), float("nan")],
    [float("nan")],
    [0.5],
])
def test_best_and_median_rules_match(run_dir, tmp_path, monkeypatch, combined):
    """A NaN draw never wins and stays out of the median; with every draw NaN
    the first is best and the median NaN; one draw writes the file too."""
    _stub_rollouts(monkeypatch, combined, [])
    argv = ["--run_dir", run_dir, "--draws", str(len(combined))]
    JCLI.self_feed_main(argv + ["--out", str(tmp_path / "jax")])
    TCLI.self_feed_main(argv + ["--out", str(tmp_path / "torch"), "--device", "cpu"])
    with open(tmp_path / "jax" / "self_feed_draws.json") as f:
        want = json.load(f)
    with open(tmp_path / "torch" / "self_feed_draws.json") as f:
        got = json.load(f)
    _close(got, want)
    best, median = TCLI.best_and_median(got["draws"])
    valid = sorted(p for p in combined if p == p)
    if valid:
        assert best["combined_pvalue"] == valid[-1] == got["best_combined_pvalue"]
        assert median == statistics.median(valid) == got["median_combined_pvalue"]
    else:
        assert best["draw"] == 0 and np.isnan(median) and np.isnan(got["median_combined_pvalue"])


@pytest.mark.parametrize("run_train_mode,run_precision", [
    (True, "float32"), (False, None), (True, "high")])
@pytest.mark.parametrize("train_flag,precision_flag", [
    ("auto", "auto"), ("on", "default"), ("off", "float32"), ("auto", "bfloat16")])
def test_train_mode_and_matmul_precision_resolve_as_in_jax(
        run_dir, tmp_path, monkeypatch, run_train_mode, run_precision, train_flag,
        precision_flag):
    """The same train mode and matmul precision reach the rollout in both
    mains; in the port TF32 is on inside the rollout exactly for the
    precisions that allow it, and off for float32 and None."""
    rd = tmp_path / "run"
    shutil.copytree(run_dir, rd)
    with open(rd / "training_args.json") as f:
        meta = json.load(f)
    meta["args"]["self_feed_train_mode"] = run_train_mode
    meta["args"]["self_feed_matmul_precision"] = run_precision
    with open(rd / "training_args.json", "w") as f:
        json.dump(meta, f)
    captured = []
    _stub_rollouts(monkeypatch, [0.1], captured)
    argv = ["--run_dir", str(rd), "--train_mode", train_flag, "--matmul_precision",
            precision_flag]
    JCLI.self_feed_main(argv + ["--out", str(tmp_path / "jax")])
    TCLI.self_feed_main(argv + ["--out", str(tmp_path / "torch"), "--device", "cpu"])
    (_, jmode, jprec, _), (_, tmode, _, tf32) = captured
    assert tmode == jmode == {"auto": run_train_mode, "on": True, "off": False}[train_flag]
    from types import SimpleNamespace
    targs = SimpleNamespace(self_feed_train_mode=run_train_mode,
                            self_feed_matmul_precision=run_precision)
    assert TCLI.resolve_matmul_precision(precision_flag, targs) == jprec
    assert TCLI.resolve_train_mode(train_flag, targs) == jmode
    assert tf32 == (jprec in TT.TF32_PRECISIONS)
    assert torch.backends.cuda.matmul.allow_tf32 is False  # restored after the rollout


# ----------------------------------------------------------------- validate

def test_validate_main_matches_jax(run_dir, monkeypatch):
    """``--batches 3`` on the same batches: the loss, each term and each
    percentage error within 1e-10 in float64, and the same printed lines."""
    traj = _batches(1, seed=2)[0]
    loc, vel, force, mass = traj
    frames = [0, 5, 11]
    jb = [(JScene(pos=loc[:, f], vel=vel[:, f], force=force[:, f], mass=mass),
           np.concatenate([loc[:, f + 1] - loc[:, f], vel[:, f + 1]], axis=-1)) for f in frames]
    tb = [(TScene(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (s.pos, s.vel, s.force,
                                                                        s.mass))),
           torch.from_numpy(y)) for s, y in jb]
    _serve_gt(monkeypatch, [traj])
    jq, tq = list(jb), list(tb)
    monkeypatch.setattr(JOTF.GravityDatasetOtf, "get_batch", lambda self: jq.pop(0))
    monkeypatch.setattr(TOTF.GravityDatasetOtf, "get_batch", lambda self: tq.pop(0))
    # the JAX main's values, recorded as it computes them (eagerly)
    seen = []
    build = JLOSS.build_loss_fn

    def recording_build(args):
        fn = build(args)

        def loss_fn(pred, scene, y):
            total, terms = fn(pred, scene, y)
            seen.append({"loss": float(total), **{k: float(v) for k, v in terms.items()}})
            return total, terms
        return loss_fn

    perc = JLOSS.percentage_errors

    def recording_perc(pred, y, targets):
        out = perc(pred, y, targets)
        seen[-1].update({k: float(v) for k, v in out.items()})
        return out

    monkeypatch.setattr(JLOSS, "build_loss_fn", recording_build)
    monkeypatch.setattr(JLOSS, "percentage_errors", recording_perc)
    jout, tout = io.StringIO(), io.StringIO()
    with jax.disable_jit(), contextlib.redirect_stdout(jout):
        JCLI.validate_main(["--run_dir", run_dir, "--batches", "3"])
    with contextlib.redirect_stdout(tout):
        got = TCLI.main(["validate", "--run_dir", run_dir, "--batches", "3", "--device", "cpu"])
    assert jq == [] and tq == [] and len(seen) == 3
    assert set(got) == set(seen[0])
    for k in got:
        want = sum(s[k] for s in seen) / 3
        assert got[k] == pytest.approx(want, rel=X_RTOL), k
    assert tout.getvalue() == jout.getvalue()


# ------------------------------------------------ run dirs and load_run (F4)

def test_load_run_keeps_a_float64_checkpoint_in_float64(tmp_path):
    """F4: ``load_run`` loaded every checkpoint into a float32 model, so a
    float64 run rolled out with rounded weights; the JAX package keeps the
    checkpoint's dtype.  Now both hold the float64 values bitwise."""
    model = tmodels.create_model("egnn_mc", device="cpu", dtype=torch.float64, num_layers=2,
                                 hidden_node_dim=16, hidden_edge_dim=16, hidden_coord_dim=16)
    TCK.save_checkpoint(str(tmp_path), weights.params_to_jax(model.state_dict()), {}, 0,
                        filename="f64.ckpt")
    argv = ["--model.num_layers", "2", "--model.hidden_node_dim", "16",
            "--model.hidden_edge_dim", "16", "--model.hidden_coord_dim", "16"]
    rd = TR.make_run_dir(str(tmp_path / "run"), argv, str(tmp_path / "f64.ckpt"))
    loaded, _, _ = TR.load_run(rd, device="cpu")
    _, jparams, _, _ = JR.load_run(rd)
    want = weights.params_from_jax(jparams)
    for name, p in loaded.state_dict().items():
        assert p.dtype == torch.float64, name
        assert torch.equal(p, model.state_dict()[name]) and torch.equal(p, want[name]), name


def test_make_run_dir_around_the_committed_checkpoint(tmp_path):
    """The battery's run dir: the study protocol's files beside the committed
    checkpoint, copied byte for byte; both packages' ``load_run`` read it."""
    rd = battery.make_study_run_dir(str(tmp_path / "run"))
    with open(battery.CKPT, "rb") as f, open(os.path.join(rd, "model.ckpt"), "rb") as g:
        assert f.read() == g.read()
    assert {"training_args.json", "model_params.json", "nbody_small_dataset",
            "model.ckpt"} <= set(os.listdir(rd))
    model, ds, args = TR.load_run(rd, device="cpu")
    assert (ds.num_nodes, ds.batch_size, ds.sim_length) == (100, 16, 2500)
    assert args.self_feed_limit_steps == 249 and len(model.layers) == 6
    jmodel, jparams, jds, jargs = JR.load_run(rd)
    assert jds.get_serializable_attributes() == ds.get_serializable_attributes()
    with open(os.path.join(rd, "model_params.json")) as f:
        assert json.load(f)["num_params"] == sum(p.numel() for p in model.parameters())
    bf16 = battery.make_study_run_dir(str(tmp_path / "bf16"), "bfloat16")
    assert TR.load_run(bf16, device="cpu")[0].compute_dtype == torch.bfloat16


def test_five_macro_basis_reproduces_the_committed_batteries():
    """The committed batteries predate the sixth macro: a Fisher combine of
    their five finite per-macro p-values gives each draw's combined p."""
    for path in battery.COMMITTED.values():
        with open(path) as f:
            draws = json.load(f)["draws"]
        assert len(draws) == 6
        for d in draws:
            assert "stuck_cluster_size" not in d["per_macro"]
            assert battery.five_macro_p(d["per_macro"]) == pytest.approx(
                d["combined_pvalue"], rel=1e-12)


def test_battery_rescores_a_written_battery_on_both_bases(capsys):
    """``--rescore``: the committed battery has no sixth macro (its six-macro
    p is NaN) and its five-macro p is its own combined p."""
    path = battery.COMMITTED[281]
    (got,) = battery.main(["--rescore", path])
    with open(path) as f:
        want = [d["combined_pvalue"] for d in json.load(f)["draws"]]
    assert got["five"] == pytest.approx(want, rel=1e-12) and all(np.isnan(got["six"]))
    assert got["survived"] == [25, 24, 87, 63, 21, 35]
    assert "five-macro best=4.721e-08 median=1.541e-10" in capsys.readouterr().out


def test_cli_dispatches_its_five_commands():
    assert set(TCLI.MAINS) == {"train", "self-feed", "validate", "ks-test", "hpo"}
    with pytest.raises(SystemExit, match="self-feed"):
        TCLI.main(["bogus"])
    with pytest.raises(SystemExit):
        TCLI.main(["validate", "--help"])
