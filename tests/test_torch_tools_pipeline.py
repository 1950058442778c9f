"""The port's pipeline (``<torch>/tools/pipeline.py``) against the JAX repo's
``scripts/pipeline.py``, on the CPU.

*Helpers.*  Every helper of both modules on one synthetic workdir (run dirs
with checkpoint dirs, crash snapshots, summaries, batteries, a malformed
summary, mtimes set) gives equal results; ``_train_cmd`` equal commands
apart from the program (``train.py`` against ``-m <torch>.cli train
--device D``).

*Decisions.*  ``main`` of both, under one recording fake ``runner`` and
``wait_fn`` that write the files a stage would write (run dir mtimes kept
fixed so that both see the same order), takes the same stages in the same
order with the same arguments but the program and ``--device``, probes
alike (the port also names the device it probes), and prints the same JSON,
the same stderr and exits with the same code, in each case: fresh, reuse
(with a partial battery that must run again), resume with the seed bump
from a crash snapshot, a timeout, two stalls, near-complete, failed train,
failed score, a second-seed battery.  The JAX scorer is handed an
environment (``JAX_PLATFORMS``); the port's scorer inherits the caller's,
so ``env`` is left out of the comparison.

*A real run.*  ``python -m <torch>.tools.pipeline --device cpu`` on a tiny
EGNN-MC (2 layers, width 16, N=5, B=4, 2 epochs of 2 steps, a 10-step
evaluation a checkpoint): status ``ok``, two checkpoint dirs, a summary and
a battery; a second call prints the same JSON and starts no stage;
``--epochs 3 --skip-draws`` resumes from the run's ``model.ckpt`` with the
seed bumped by the 2 epochs reached and scores the new run dir.  Beside it,
a workdir whose crash snapshot the JAX trainer wrote (one epoch, no
checkpoint dir) resumes in the port's pipeline (``--skip-draws``).  The two
workdirs' pipelines run side by side.
"""

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch"
TPU = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu"
T = importlib.import_module(PORT + ".tools.pipeline")


def _load_script(name):
    """``scripts/<name>.py`` under a module name of its own (``tests/test_pipeline.py``
    imports it as a top-level ``pipeline``)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J = _load_script("pipeline")
SCRIPT_STAGE = {"train.py": "train", "ks_test.py": "ks-test", "self_feed.py": "self-feed"}


# ------------------------------------------------------- synthetic files


def _write_json(path, obj):
    """Write ``obj`` to ``path``, keeping the run dir's mtime (the order
    ``latest_run`` and ``runs_with_checkpoints`` read) as it was."""
    run = path
    while os.path.basename(os.path.dirname(os.path.dirname(run))) != "runs":
        run = os.path.dirname(run)
    st = os.stat(run)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(obj, fh)
    os.utime(run, ns=(st.st_atime_ns, st.st_mtime_ns))


def _mk_partial(workdir, stamp, epochs, resume=True, mtime=1000, model="egnn_mc"):
    """A run dir with checkpoint dirs for ``epochs`` (each with its
    ``model.ckpt``) and, with ``resume``, the run's ``model.ckpt``."""
    run = os.path.join(workdir, "runs", model, stamp)
    os.makedirs(run, exist_ok=True)
    for e in epochs:
        ck = os.path.join(run, "checkpoints", str(e))
        os.makedirs(ck, exist_ok=True)
        open(os.path.join(ck, "model.ckpt"), "w").write("x")
    if resume:
        open(os.path.join(run, "model.ckpt"), "w").write("x")
    os.utime(run, (mtime, mtime))
    return run


def _mk_summary(run, pvals):
    _write_json(os.path.join(run, "ks_summary.json"),
                {"results": [{"checkpoint": int(ck), "combined_pvalue": p}
                             for ck, p in pvals.items()]})


def _mk_battery(run, name, p, best=True):
    rec = {"draws": [{"draw": 0, "combined_pvalue": p}]}
    if best:
        rec["best_combined_pvalue"] = p
    _write_json(os.path.join(run, name, "self_feed_draws.json"), rec)


# ----------------------------------------------------------- helpers


def _synthetic_workdir(wd):
    a = _mk_partial(wd, "a", [10, 20], mtime=1000)
    _mk_summary(a, {10: 0.2, 20: 0.6, 60: 0.99})  # 60 has no checkpoint
    _mk_battery(a, "draws_ckpt10", 0.9)
    _mk_battery(a, "draws2_ckpt20", 0.4)
    os.makedirs(os.path.join(a, "draws_ckpt20", "draw_00"))  # a killed battery
    os.utime(a, (1000, 1000))
    b = os.path.join(wd, "runs", "egnn_mc", "b")  # a crash before its first checkpoint
    os.makedirs(b)
    open(os.path.join(b, "model.ckpt"), "w").write("x")
    os.utime(b, (2000, 2000))
    c = _mk_partial(wd, "c", [30, 40], resume=False, mtime=3000, model="painn")
    os.makedirs(os.path.join(c, "checkpoints", "tmp"))  # not an epoch
    os.remove(os.path.join(c, "checkpoints", "40", "model.ckpt"))
    _mk_summary(c, {30: 0.5, 40: 0.95})
    _mk_battery(c, "draws_ckpt30", 0.7, best=False)
    d = _mk_partial(wd, "d", [50], mtime=4000)
    open(os.path.join(d, "ks_summary.json"), "w").write("{not json")
    os.utime(d, (4000, 4000))
    return [a, b, c, d]


def _args(mod, wd, *extra):
    return mod.build_parser().parse_args(
        ["--workdir", wd, "--model", "egnn_mc", "--epochs", "50",
         "--deadline-hours", "0.01", "--poll-s", "0.01", *extra])


def _split(cmd):
    """``(stage, its arguments, device)`` of a stage's command."""
    cmd = list(cmd)
    assert cmd[0] == sys.executable
    if cmd[1] == "-m":
        assert cmd[2] == PORT + ".cli" and cmd[4] == "--device", cmd
        return cmd[3], cmd[6:], cmd[5]
    return SCRIPT_STAGE[os.path.basename(cmd[1])], cmd[2:], None


def test_helpers_agree_on_one_workdir(tmp_path):
    wd = str(tmp_path)
    runs = _synthetic_workdir(wd)
    assert J.latest_run(wd) == T.latest_run(wd) == runs[3]
    for rd in runs + [None]:
        for k in (0, 1, 2, 3):
            assert J.run_usable(rd, k) == T.run_usable(rd, k), (rd, k)
    assert J.runs_with_checkpoints(wd) == T.runs_with_checkpoints(wd) == [runs[0], runs[2],
                                                                         runs[3]]
    assert J.total_epochs_reached(wd) == T.total_epochs_reached(wd) == 50
    assert J.continuation_ckpt(wd) == T.continuation_ckpt(wd) == os.path.join(runs[3],
                                                                              "model.ckpt")
    with_ck = J.runs_with_checkpoints(wd)
    for k in range(1, 6):
        assert (J.aggregate_top_checkpoints(with_ck, k)
                == T.aggregate_top_checkpoints(with_ck, k))
    assert T.aggregate_top_checkpoints(with_ck, 9) == [(runs[0], "20"), (runs[2], "30"),
                                                       (runs[0], "10")]
    assert J.best_checkpoint_overall(with_ck) == T.best_checkpoint_overall(with_ck) == (
        runs[0], "10")
    assert J.best_combined_p(wd) == T.best_combined_p(wd) == {
        "best_in_run": 0.99, "best_draw": 0.9, "best": 0.99}
    for epochs, interval, mins in ((50, 10, 1), (55, 10, 9), (60, 10, 1), (5, 10, 3),
                                   (5, 10, 1)):
        extra = ["--ckpt-interval", str(interval), "--min-checkpoints", str(mins)]
        ja, ta = _args(J, wd, *extra), _args(T, wd, *extra)
        ja.epochs = ta.epochs = epochs
        assert J._target_reached(ja) == T._target_reached(ta), (epochs, interval, mins)
    # the resume command, the seed bumped by the 50 epochs reached
    ov = ["-o", "dataloader.seed=7", "-o", "trainer.seed=7", "-o", "model.num_layers=2"]
    ja, ta = _args(J, wd, *ov), _args(T, wd, *ov)
    for path in (None, os.path.join(wd, "x.ckpt")):
        js, jargs, _ = _split(J._train_cmd(ja, model_path=path))
        ts, targs, dev = _split(T._train_cmd(ta, model_path=path))
        assert (js, jargs) == (ts, targs) and dev == "cuda"
    assert targs[targs.index("--dataloader.seed") + 1] == "57"


def test_parsers_agree():
    ja, ta = (m.build_parser().parse_args(["--workdir", "w", "--model", "m", "--epochs", "3"])
              for m in (J, T))
    tv = vars(ta)
    assert tv.pop("device") == "cuda"
    assert vars(ja) == tv
    # the default config is the repo root's, found from inside the package
    assert ta.config == ja.config == os.path.join(os.path.realpath(REPO), "config.yaml")
    assert T.CLI == PORT + ".cli"


def test_cli_names_a_commands_kernel_launches(monkeypatch, capsys):
    """The CLI's last line on the card names the command's launches, as
    ``chip_smoke.py``'s ``[pipeline]`` reads them from a stage's output; a
    command that launched nothing (every command on the CPU) prints none."""
    cli = importlib.import_module(PORT + ".cli")
    k1 = importlib.import_module(PORT + ".ops.egnn_messages").fused_egnn_messages
    leapfrog = importlib.import_module(PORT + ".ops.gravity").leapfrog
    monkeypatch.setattr(k1, "launches", k1.launches + 7)  # launches before the command
    monkeypatch.setattr(leapfrog, "launches", leapfrog.launches)

    def battery(argv):  # what a 2-step battery of a 6-layer EGNN-MC counts on the card
        k1.launches += 12
        leapfrog.launches += 1
        return argv

    monkeypatch.setitem(cli.MAINS, "self-feed", battery)
    assert cli.main(["self-feed", "--draws", "1"]) == ["--draws", "1"]
    out = capsys.readouterr().out
    assert out == 'kernel launches (self-feed on cuda): {"k1": 12, "leapfrog": 1}\n'
    monkeypatch.syspath_prepend(REPO)
    smoke = importlib.import_module("chip_smoke")
    assert smoke._launch_line("draw 0: ...\n" + out, "self-feed") == {"k1": 12, "leapfrog": 1}
    assert smoke._launch_line(out, "train") == {}
    monkeypatch.setitem(cli.MAINS, "validate", lambda argv: None)
    cli.main(["validate", "--device", "cpu"])
    assert capsys.readouterr().out == ""


# ------------------------------------------------------ fake runner


class Fake:
    """A recording ``runner`` and ``wait_fn`` writing what a stage writes.

    ``train``: one action an attempt, ``(stamp, epochs, resume, mtime)`` for
    a run dir, ``"timeout"`` after the previous action's files, or None for
    an attempt that writes nothing.  ``scores``: a run dir's name -> its
    checkpoints' p (absent: the scorer writes nothing).  ``draw_p``: the
    battery's ``(run name, out dir name)`` -> p."""

    def __init__(self, wd, train=(), scores=None, draw_p=None, healthy=True):
        self.wd, self.train, self.healthy = wd, list(train), healthy
        self.scores, self.draw_p = scores or {}, draw_p or {}
        self.calls, self.devices = [], set()

    def _norm(self, v):
        return v.replace(self.wd, "<wd>") if isinstance(v, str) else v

    def wait(self, **kw):
        kw.pop("max_wait_s")  # the time left to the deadline
        platform = kw.pop("platform", None)
        if platform is not None:
            self.devices.add(platform)
        self.calls.append(("wait", sorted(kw.items())))
        return self.healthy

    def run(self, cmd, **kw):
        stage, args, dev = _split(cmd)
        if dev is not None:
            self.devices.add(dev)
        kw.pop("env", None)
        if "stdout" in kw:
            kw["stdout"] = kw["stdout"].name
        self.calls.append((stage, [self._norm(a) for a in args],
                           sorted((k, self._norm(v)) for k, v in kw.items())))
        if stage == "train":
            action = self.train.pop(0) if self.train else None
            if action == "timeout":
                raise subprocess.TimeoutExpired(cmd, kw.get("timeout", 0))
            if action is not None:
                stamp, epochs, resume, mtime = action
                _mk_partial(self.wd, stamp, epochs, resume=resume, mtime=mtime)
                if self.train and self.train[0] == "timeout":
                    self.train.pop(0)
                    raise subprocess.TimeoutExpired(cmd, kw.get("timeout", 0))
        elif stage == "ks-test":
            run = args[-1]
            pvals = self.scores.get(os.path.basename(run))
            if pvals is not None:
                _mk_summary(run, pvals)
        else:
            run, out = args[args.index("--run_dir") + 1], args[args.index("--out") + 1]
            p = self.draw_p.get((os.path.basename(run), os.path.basename(out)), 0.3)
            _write_json(os.path.join(out, "self_feed_draws.json"),
                        {"best_combined_pvalue": p, "draws": [{"draw": 0, "combined_pvalue": p}],
                         "seed": int(args[args.index("--seed") + 1])})


def _setup_fresh(wd):
    pass


def _setup_reuse(wd):
    a = _mk_partial(wd, "a", [10, 20, 30, 40, 50])
    _mk_summary(a, {10: 0.1, 20: 0.8, 30: 0.5})
    _mk_battery(a, "draws_ckpt20", 0.85)
    os.makedirs(os.path.join(a, "draws_ckpt30", "draw_00"))  # killed: runs again


def _setup_partial(wd):
    _mk_partial(wd, "a", [10, 20], mtime=1000)
    b = os.path.join(wd, "runs", "egnn_mc", "b")  # the newest: a crash snapshot alone
    os.makedirs(b)
    open(os.path.join(b, "model.ckpt"), "w").write("x")
    os.utime(b, (1500, 1500))


def _setup_stuck(epochs_reached):
    def setup(wd):
        _mk_partial(wd, "a", epochs_reached, mtime=1000)
    return setup


SCORES = {"a": {10: 0.2, 20: 0.6}, "b": {30: 0.5, 40: 0.1, 50: 0.7},
          "c": {10: 0.3, 20: 0.4, 30: 0.45, 40: 0.42, 50: 0.41}}
CASES = {
    "fresh": (_setup_fresh, ["--top-k", "2"],
              dict(train=[("c", [10, 20, 30, 40, 50], True, 3000)], scores=SCORES,
                   draw_p={("c", "draws_ckpt30"): 0.9})),
    "reuse": (_setup_reuse, ["--top-k", "2", "--min-checkpoints", "99"], dict(scores={})),
    "resume_seed_bump": (_setup_partial,
                         ["-o", "dataloader.seed=7", "-o", "trainer.seed=7", "--top-k", "3"],
                         dict(train=[("c", [30, 40, 50], True, 3000)], scores=SCORES)),
    "timeout": (_setup_fresh, ["--min-checkpoints", "99"],
                dict(train=[("a", [10, 20], True, 1000), "timeout",
                            ("b", [30, 40, 50], True, 2000)], scores=SCORES)),
    "two_stalls": (_setup_stuck([10, 20]), ["--deadline-hours", "0.05"],
                   dict(train=[None, None, ("b", [30, 40, 50], True, 2000)], scores=SCORES)),
    "near_complete": (_setup_stuck([10, 20, 30, 40]), ["--deadline-hours", "0.05"],
                      dict(train=[None, None], scores={"a": {10: 0.2, 40: 0.3}})),
    "failed_train": (_setup_fresh, [], dict(healthy=False)),
    "failed_score": (_setup_fresh, [],
                     dict(train=[("c", [10, 20, 30, 40, 50], True, 3000)], scores={})),
    "second_seed": (_setup_stuck([10, 20]),
                    ["--epochs", "20", "--min-checkpoints", "99", "--top-k", "2",
                     "--draw-seed", "281", "--second-draw-seed", "9272"],
                    dict(scores={"a": {10: 0.2, 20: 0.6}},
                         draw_p={("a", "draws_ckpt10"): 0.95})),
}


def _drive(mod, wd, case, capsys):
    setup, extra, fake_kw = CASES[case]
    os.makedirs(wd)
    setup(wd)
    fake = Fake(wd, **fake_kw)
    argv = ["--workdir", wd, "--model", "egnn_mc", "--epochs", "50",
            "--deadline-hours", "0.01", "--poll-s", "0.01", *extra]
    rc = mod.main(argv, runner=fake.run, wait_fn=fake.wait)
    out, err = capsys.readouterr()
    return rc, out.replace(wd, "<wd>"), err.replace(wd, "<wd>"), fake


@pytest.mark.parametrize("case", list(CASES))
def test_main_decides_as_the_script(tmp_path, capsys, case):
    j = _drive(J, str(tmp_path / "j"), case, capsys)
    t = _drive(T, str(tmp_path / "t"), case, capsys)
    assert t[3].calls == j[3].calls, case
    assert t[:3] == j[:3], case
    assert j[3].devices == set() and t[3].devices <= {"cuda"}
    if j[3].calls:
        assert t[3].devices == {"cuda"}
    result = json.loads(t[1].strip().splitlines()[-1])
    want = {"fresh": ("ok", 0.9), "reuse": ("ok", 0.85), "resume_seed_bump": ("ok", 0.6),
            "timeout": ("ok", 0.7), "two_stalls": ("failed", None),
            "near_complete": ("ok", 0.3), "failed_train": ("failed", None),
            "failed_score": ("failed", None), "second_seed": ("ok", 0.95)}[case]
    assert (result["status"], result.get("best")) == want
    assert t[0] == (0 if want[0] == "ok" else 1)
    stages = [c[0] for c in t[3].calls]
    if case == "reuse":  # the finished battery is kept, the killed one runs again
        assert stages == ["wait", "self-feed"]
        assert "<wd>/runs/egnn_mc/a/draws_ckpt30" in t[3].calls[1][1]
    if case == "resume_seed_bump":
        train = t[3].calls[1][1]
        assert train[train.index("--trainer.model_path") + 1] == "<wd>/runs/egnn_mc/b/model.ckpt"
        assert train[train.index("--dataloader.seed") + 1] == "27"
        assert [c[1][-1] for c in t[3].calls if c[0] == "ks-test"] == [
            "<wd>/runs/egnn_mc/a", "<wd>/runs/egnn_mc/c"]
    if case == "timeout":
        assert stages.count("train") == 2 and "hit --train-timeout-s" in t[2]
    if case == "two_stalls":
        assert stages == ["wait", "train", "wait", "train"]
        assert t[1].strip() == '{"status": "failed", "stage": "train"}'
    if case == "near_complete":
        assert "accepting near-complete run at epoch 40" in t[2]
    if case == "failed_score":
        assert result == {"status": "failed", "stage": "score", "run": "<wd>/runs/egnn_mc/c"}
    if case == "second_seed":
        draws = [(c[1][c[1].index("--out") + 1].rsplit("/", 1)[1],
                  c[1][c[1].index("--seed") + 1]) for c in t[3].calls if c[0] == "self-feed"]
        assert draws == [("draws_ckpt20", "281"), ("draws_ckpt10", "281"),
                         ("draws2_ckpt10", "9272")]


# ------------------------------------------------------------ real run

TINY = ["-o", "model.num_layers=2", "-o", "model.hidden_node_dim=16",
        "-o", "model.hidden_edge_dim=16", "-o", "model.hidden_coord_dim=16",
        "-o", "dataloader.batch_size=4", "-o", "dataloader.gravity_dataset.sim_length=200",
        "-o", "trainer.steps_per_epoch=2", "-o", "trainer.test_macros_every=1",
        "-o", "trainer.save_model_every=1", "-o", "trainer.self_feed_limit_steps=10"]
TIMEOUT = 240


def _pipeline_cmd(wd, epochs, *extra):
    return [sys.executable, "-m", PORT + ".tools.pipeline", "--device", "cpu",
            "--workdir", wd, "--model", "egnn_mc", "--epochs", str(epochs),
            "--ckpt-interval", "1", "--min-checkpoints", "2", "--draws", "1",
            "--top-k", "1", "--poll-s", "1", "--deadline-hours", "0.05",
            "--draw-seed", "5", *TINY, *extra]


def _start(cmd, cwd):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=cwd, env=env)


def _finish(proc):
    out, err = proc.communicate(timeout=TIMEOUT)
    assert proc.returncode == 0, (out[-3000:], err[-3000:])
    return json.loads(out.strip().splitlines()[-1]), out, err


def _tree(wd):
    """Every path under the workdir with its mtime."""
    return {os.path.join(r, n): os.stat(os.path.join(r, n)).st_mtime_ns
            for r, ds, fs in os.walk(wd) for n in ds + fs}


def _jax_crash_snapshot(wd, monkeypatch):
    """The JAX trainer's run dir after one epoch of the tiny config: its
    ``model.ckpt`` written as on a crash before the first checkpoint dir."""
    JCFG = importlib.import_module(TPU + ".utils.config")
    JT = importlib.import_module(TPU + ".train.trainer")
    over = [a for a in TINY if a != "-o"]
    argv = ["--config", os.path.join(REPO, "config.yaml"), "--main.model_type", "egnn_mc",
            "--trainer.train_steps", "2", "--trainer.run_name", "jax"]
    for ov in over:
        key, _, val = ov.partition("=")
        argv += [f"--{key}", val]
    os.makedirs(wd)
    monkeypatch.chdir(wd)
    args, cfg = JCFG.parse_args(argv)
    trainer = JT.create_trainer_from_args(args, cfg)
    trainer.train_one_epoch()
    trainer.step_count += 1
    path = trainer.save_model()
    monkeypatch.chdir(REPO)
    return os.path.abspath(os.path.join(wd, path))


@pytest.fixture(scope="module")
def real(tmp_path_factory):
    root = tmp_path_factory.mktemp("real_pipeline")
    wd, wj = str(root / "port"), str(root / "jax")
    t0 = time.time()
    fresh = _start(_pipeline_cmd(wd, 2, "-o", "dataloader.seed=3"), root)
    with pytest.MonkeyPatch.context() as mp:
        jax_ckpt = _jax_crash_snapshot(wj, mp)
    from_jax = _start(_pipeline_cmd(wj, 2, "--skip-draws"), root)
    out = {"fresh": _finish(fresh), "tree_after_fresh": _tree(wd)}
    with open(os.path.join(wd, "train_attempt1.log")) as f:
        out["fresh_log"] = f.read()
    out["runs_after_fresh"] = _runs(wd)
    out["again"] = _finish(_start(_pipeline_cmd(wd, 2, "-o", "dataloader.seed=3"), root))
    out["tree_after_again"] = _tree(wd)
    out["more"] = _finish(_start(_pipeline_cmd(wd, 3, "--skip-draws",
                                               "-o", "dataloader.seed=3"), root))
    out["from_jax"] = _finish(from_jax)
    out.update(root=str(root), wd=wd, wj=wj, jax_ckpt=jax_ckpt, seconds=time.time() - t0)
    return out


def _runs(wd):
    base = os.path.join(wd, "runs", "egnn_mc")
    return sorted(os.path.join(base, r) for r in os.listdir(base))


def test_real_pipeline_runs_fresh_on_the_cpu(real):
    result, out, err = real["fresh"]
    (run,) = real["runs_after_fresh"]
    assert result["status"] == "ok" and result["run"] == run
    assert sorted(os.listdir(os.path.join(run, "checkpoints"))) == ["1", "2"]
    with open(os.path.join(run, "ks_summary.json")) as f:
        summary = json.load(f)
    best_ck = max(summary["results"], key=lambda r: r["combined_pvalue"])["checkpoint"]
    with open(os.path.join(run, f"draws_ckpt{best_ck}", "self_feed_draws.json")) as f:
        battery = json.load(f)
    assert battery["seed"] == 5 and len(battery["draws"]) == 1
    assert result["best_in_run"] == summary["best_combined_pvalue"]
    assert result["best_draw"] == battery["draws"][0]["combined_pvalue"]
    assert result["best"] == max(result["best_in_run"], result["best_draw"])
    assert "pipeline: training attempt 1\n" in err
    # on the host no kernel launches, so the CLI prints no launch line
    assert "Epoch 1 |" in real["fresh_log"] and "kernel launches" not in real["fresh_log"]
    assert sorted(os.listdir(real["root"])) == ["jax", "port"]  # the stages' cwd stays clean


def test_real_pipeline_second_call_starts_nothing(real):
    (r1, out1, _), (r2, out2, err2) = real["fresh"], real["again"]
    assert out2.strip().splitlines()[-1] == out1.strip().splitlines()[-1]
    assert out2.strip().count("\n") == 0  # no stage printed anything
    assert "pipeline: reusing run" in err2
    assert "training attempt" not in err2 and "draws at" not in err2
    assert real["tree_after_again"] == real["tree_after_fresh"]


def test_real_pipeline_resumes_its_run(real):
    result, _, err = real["more"]
    first, second = _runs(real["wd"])
    assert f"pipeline: training attempt 1 (resuming from {first}/model.ckpt)" in err
    assert "resume bumps dataloader.seed 3 -> 5" in err
    assert result["status"] == "ok" and result["run"] == second
    assert os.listdir(os.path.join(second, "checkpoints")) == ["3"]
    assert os.path.exists(os.path.join(second, "ks_summary.json"))
    with open(os.path.join(real["wd"], "train_attempt1.log")) as f:
        log = f.read()
    assert f"Loaded model and optimizer state from {first}/model.ckpt" in log
    assert "Epoch 2 |" in log and "Epoch 1 |" not in log


def test_real_pipeline_resumes_a_jax_crash_snapshot(real):
    result, _, err = real["from_jax"]
    jax_run, port_run = _runs(real["wj"])
    assert real["jax_ckpt"] == os.path.join(jax_run, "model.ckpt")
    assert not os.path.exists(os.path.join(jax_run, "checkpoints"))
    assert f"(resuming from {real['jax_ckpt']})" in err
    assert result["status"] == "ok" and result["run"] == port_run
    assert os.listdir(os.path.join(port_run, "checkpoints")) == ["2"]
    with open(os.path.join(port_run, "ks_summary.json")) as f:
        assert [r["checkpoint"] for r in json.load(f)["results"]] == [2]
    with open(os.path.join(real["wj"], "train_attempt1.log")) as f:
        log = f.read()
    assert f"Loaded model and optimizer state from {real['jax_ckpt']}" in log
    assert "Epoch 1 |" in log and "Epoch 0 |" not in log
