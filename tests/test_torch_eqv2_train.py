"""EquiformerV2's training path in the port against the JAX package's ``Trainer``.

* Both trainers resume the committed 10M checkpoint
  (``docs/results/eqv2_10m_L8c128_cont/ckpt_130_model.ckpt``, L8 c128,
  epoch 130, AdamW count 130000) with the queue's argv, both dropout rates
  set to 0 in both packages (their dropout streams differ), and take one step
  on the same batch (B=2, N=5, computed in float64 from the float32
  parameters, as both packages do): the parameters agree within 1e-7 of their
  largest value, and each parameter's update within 1e-3 of its largest
  update plus two float32 ulps of the parameter (the packages round the
  float32 update in their own order).
* Each package reads the other's run: a small EquiformerV2 trained one step
  by each from the same float64 parameters; the steps agree within 1e-9, and
  each package's ``load_run`` of the other's run dir gives the other's
  outputs within 1e-10 relative; the port's checkpoint keeps the JAX key
  layout, AdamW's ``mu`` and ``nu`` included.
* A 20-step eval-mode self-feed rollout of the small model agrees with the
  JAX package's from the same GT arrays within 1e-8.
* With dropout on, two port trainers of one ``seed`` take bitwise-equal
  steps and another seed takes other steps; ``cli train`` trains a tiny
  EquiformerV2 with live dropout on the CPU, and the Inferencer's rollouts of
  its run dir repeat bitwise under one ``rng``.
* HPO: ``trial_to_overrides`` ties the three channel knobs to
  ``channel_base``, ``_quantize_width`` rounds to a multiple of the heads,
  and ``adjust_width_to_target`` bisects ``sphere_channels`` to the JAX
  package's widths and counts.
"""

import importlib
import importlib.util
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

TPU = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu"
PORT = TPU + "_torch"
JOTF = importlib.import_module(TPU + ".data.gravity_otf")
JT = importlib.import_module(TPU + ".train.trainer")
JCFG = importlib.import_module(TPU + ".utils.config")
JR = importlib.import_module(TPU + ".train.restore")
JH = importlib.import_module(TPU + ".hpo.hpo")
jrollout = importlib.import_module(TPU + ".rollout")
JScene = importlib.import_module(TPU + ".core.scene").Scene
TOTF = importlib.import_module(PORT + ".data.gravity_otf")
TT = importlib.import_module(PORT + ".train.trainer")
TCFG = importlib.import_module(PORT + ".utils.config")
TR = importlib.import_module(PORT + ".train.restore")
TDL = importlib.import_module(PORT + ".data.dataloaders")
TH = importlib.import_module(PORT + ".hpo.hpo")
tgraph = importlib.import_module(PORT + ".core.graph")
tmodels = importlib.import_module(PORT + ".models")
TE = importlib.import_module(PORT + ".models.equiformer_v2")
trollout = importlib.import_module(PORT + ".rollout.self_feed")
TINF = importlib.import_module(PORT + ".rollout.inferencer")
physics = importlib.import_module(PORT + ".core.physics")
weights = importlib.import_module(PORT + ".weights")
cli = importlib.import_module(PORT + ".cli")
Scene = importlib.import_module(PORT + ".core.scene").Scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)
CKPT = os.path.join(REPO, "docs", "results", "eqv2_10m_L8c128_cont", "ckpt_130_model.ckpt")
N, FRAMES = 5, 20
QUEUE = ["--main.model_type", "equiformer_v2", "--model.num_layers", "8",
         "--model.sphere_channels", "128", "--model.attn_hidden_channels", "128",
         "--model.ffn_hidden_channels", "128", "--model.num_heads", "8", "--model.remat", "true"]
SMALL = ["--main.model_type", "equiformer_v2", "--model.num_layers", "2",
         "--model.sphere_channels", "8", "--model.attn_hidden_channels", "8",
         "--model.ffn_hidden_channels", "8", "--model.num_heads", "2",
         "--model.edge_channels", "8"]
NO_DROPOUT = ["--model.alpha_drop", "0.0", "--model.drop_path_rate", "0.0"]
READ_RTOL, ROLLOUT_ATOL = 1e-10, 1e-8


def _batch(b):
    """One float64 GT batch from the plain integrator, as numpy arrays."""
    loc, vel, force, mass = physics.sample_trajectory_batch(
        b, N, T=FRAMES * 10, sample_freq=10, dtype=torch.float64, device="cpu",
        generator=torch.Generator().manual_seed(1))
    return {"loc": loc.numpy(), "vel": vel.numpy(), "force": force.numpy(), "mass": mass.numpy()}


def _f64(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), tree)


def _assert_rel(got, want, rtol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert got.shape == want.shape and err <= rtol * scale, f"{what}: {err} vs {scale}"


def _same_batches(monkeypatch, traj):
    monkeypatch.setattr(JOTF.GravityDatasetOtf, "generate_trajectories",
                        lambda self, bs: {k: jnp.asarray(v) for k, v in traj.items()})
    monkeypatch.setattr(TOTF.GravityDatasetOtf, "generate_trajectories",
                        lambda self, bs: {k: torch.from_numpy(v.copy()) for k, v in traj.items()})


def test_committed_checkpoint_resumes_and_steps_as_jax_does(tmp_path, monkeypatch):
    _same_batches(monkeypatch, _batch(2))
    argv = QUEUE + NO_DROPOUT + ["--dataloader.batch_size", "2",
                                "--dataloader.gravity_dataset.sim_length", str(FRAMES * 10),
                                "--dataloader.seed", "5", "--trainer.precision_mode", "double",
                                "--trainer.steps_per_epoch", "1"]
    trainers = {}
    for name, cfg, create in (("jax", JCFG, JT.create_trainer_from_args),
                              ("torch", TCFG, TT.create_trainer_from_args)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        # a resumed run links itself into the checkpoint's folder: resume a copy
        args, resolved = cfg.parse_args(
            argv + ["--trainer.model_path", str(shutil.copy(CKPT, tmp_path / name))])
        trainers[name] = create(args, resolved_config=resolved,
                                **({"device": "cpu"} if name == "torch" else {}))
    jt, tt = trainers["jax"], trainers["torch"]
    assert tt.optim.count == 130_000 and tt.step_count == jt.step_count == 130
    assert tt.n_params == jt.n_params == 9_689_010
    assert tt.best_metrics == {"self_feed_steps": 1000}
    assert isinstance(tt.model, TE.EquiformerV2) and tt.model.remat
    before = {k: v.detach().double().clone() for k, v in tt.model.named_parameters()}
    for name, t in (("jax", jt), ("torch", tt)):
        monkeypatch.chdir(tmp_path / name)
        t.train_one_epoch()
    want = weights.params_from_jax(jt.params, "equiformer_v2")
    for name, p in tt.model.named_parameters():
        got, w, b = p.detach().double(), want[name].double(), before[name]
        _assert_rel(got.numpy(), w.numpy(), 1e-7, name)
        du, dw = got - b, w - b
        allowed = 1e-3 * dw.abs().max() + 2 * 2.0**-23 * b.abs()
        assert bool(((du - dw).abs() <= allowed).all()), name
    assert tt.optim.count == 130_001


@pytest.fixture(scope="module")
def small_pair(tmp_path_factory):
    """A small EquiformerV2 (no dropout) trained one step by each package from
    the same float64 parameters, on the same batch, each saving its run."""
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("eqv2")
    _same_batches(mp, _batch(4))
    argv = SMALL + NO_DROPOUT + [
        "--dataloader.batch_size", "4", "--dataloader.gravity_dataset.sim_length",
        str(FRAMES * 10), "--dataloader.seed", "5", "--dataloader.double_precision", "true",
        "--trainer.precision_mode", "double", "--trainer.steps_per_epoch", "1"]
    try:
        for name in ("jax", "torch"):
            (root / name).mkdir()
        mp.chdir(root / "jax")
        jargs, jcfg = JCFG.parse_args(argv + ["--trainer.run_name", "jax"])
        jt = JT.create_trainer_from_args(jargs, resolved_config=jcfg)
        mp.chdir(root / "torch")
        targs, tcfg = TCFG.parse_args(argv + ["--trainer.run_name", "torch"])
        torch.manual_seed(0)
        model = tmodels.create_model("equiformer_v2", device="cpu", dtype=torch.float64,
                                     **targs.model_kwargs)
        tt = TT.Trainer(model, TDL.create_dataloader(targs, device="cpu").dataset, targs,
                        resolved_config=tcfg, device="cpu")
        jt.params = weights.params_to_jax(model.state_dict())
        jt.opt_state = jt.tx.init(jt.params)
        for name, t in (("jax", jt), ("torch", tt)):
            mp.chdir(root / name)
            t.train_one_epoch()
            t.step_count = 1
            t.save_model()
        yield dict(jt=jt, tt=tt, root=root)
    finally:
        mp.undo()


def _scene_arrays(b=2, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, N, 3)), rng.normal(size=(b, N, 3)), np.zeros((b, N, 3)),
            np.ones((b, N, 1))]


def _fc(b=1):
    return jnp.asarray(~np.eye(N, dtype=bool))[None].repeat(b, 0)


def test_small_step_matches_jax(small_pair):
    want = weights.params_from_jax(small_pair["jt"].params, "equiformer_v2")
    for name, p in small_pair["tt"].model.named_parameters():
        _assert_rel(p.detach().numpy(), want[name].numpy(), 1e-9, name)


def test_jax_reads_the_ports_run(small_pair):
    tt = small_pair["tt"]
    run_dir = os.path.join(str(small_pair["root"] / "torch"), tt.save_dir_path)
    payload = weights.read_checkpoint(os.path.join(run_dir, "model.ckpt"))
    jtree = jax.tree_util.tree_structure(small_pair["jt"].params)
    assert jax.tree_util.tree_structure(payload["params"]) == jtree
    for moment in weights._find_adam(payload["opt_state"])[1:]:  # mu, nu
        assert jax.tree_util.tree_structure(moment) == jtree
    jmodel, jparams, _, _ = JR.load_run(run_dir, seed=0)
    arrs = _scene_arrays()
    js = JScene(*(jnp.asarray(a) for a in arrs))
    want = np.asarray(jmodel.apply(_f64(jparams), js, _fc(2)))
    tt.model.eval()
    with torch.no_grad():
        got = tt.model(Scene(*(torch.from_numpy(a) for a in arrs)),
                       tgraph.knn_mask(torch.from_numpy(arrs[0]), N - 1)).numpy()
    _assert_rel(got, want, READ_RTOL, "JAX load_run of the port's run")


def test_the_port_reads_the_jax_run(small_pair):
    jt = small_pair["jt"]
    run_dir = os.path.join(str(small_pair["root"] / "jax"), jt.save_dir_path)
    model, dataset, args = TR.load_run(run_dir, seed=0, device="cpu")
    assert isinstance(model, TE.EquiformerV2) and args.model_type == "equiformer_v2"
    assert dataset.num_nodes == N
    arrs = _scene_arrays(seed=4)
    js = JScene(*(jnp.asarray(a) for a in arrs))
    want = np.asarray(jt.model.apply(_f64(jt.params), js, _fc(2)))
    model = model.double().eval()
    with torch.no_grad():
        got = model(Scene(*(torch.from_numpy(a) for a in arrs)),
                    tgraph.knn_mask(torch.from_numpy(arrs[0]), N - 1)).numpy()
    # the JAX run keeps float32 parameters: both apply the same ones in float64
    _assert_rel(got, want, READ_RTOL, "the port's load_run of a JAX run")


def test_self_feed_rollout_matches_jax(small_pair):
    traj = _batch(4)
    arrs = [traj[k][:, 0] for k in ("loc", "vel", "force")] + [traj["mass"]]
    jloc, jvel, jsurv = jrollout.make_rollout_fn(small_pair["jt"].model, FRAMES + 1)(
        small_pair["jt"].params, JScene(*(jnp.asarray(a) for a in arrs)))
    model = small_pair["tt"].model.eval()
    loc, vel, surv = trollout.make_rollout_fn(model, FRAMES + 1)(
        Scene(*(torch.from_numpy(a) for a in arrs)))
    assert loc.shape == (4, FRAMES + 1, N, 3) and torch.isfinite(loc).all()
    np.testing.assert_allclose(loc.numpy(), np.asarray(jloc), rtol=0, atol=ROLLOUT_ATOL)
    np.testing.assert_allclose(vel.numpy(), np.asarray(jvel), rtol=0, atol=ROLLOUT_ATOL)
    np.testing.assert_array_equal(surv.numpy(), np.asarray(jsurv))


def test_one_seed_trains_one_way(tmp_path, monkeypatch):
    """Three small port trainers from one init, with both dropout rates on:
    seeds 3, 3 and 4."""
    runs = []
    for i, seed in enumerate((3, 3, 4)):
        (tmp_path / str(i)).mkdir()
        monkeypatch.chdir(tmp_path / str(i))
        args, cfg = TCFG.parse_args(SMALL + [
            "--model.alpha_drop", "0.4", "--model.drop_path_rate", "0.4",
            "--dataloader.batch_size", "4", "--dataloader.gravity_dataset.sim_length", "200",
            "--dataloader.seed", "5", "--trainer.steps_per_epoch", "3",
            "--trainer.seed", str(seed)])
        torch.manual_seed(0)
        t = TT.create_trainer_from_args(args, resolved_config=cfg, device="cpu")
        assert tmodels.needs_generator(t.model.train())
        t.train_one_epoch()
        runs.append({k: v.clone() for k, v in t.model.state_dict().items()})
    assert all(torch.equal(v, runs[1][k]) for k, v in runs[0].items())
    assert not all(torch.equal(v, runs[2][k]) for k, v in runs[0].items())


def test_cli_trains_with_live_dropout_and_the_inferencer_repeats(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trainer = cli.main(["train", "--device", "cpu", *SMALL, "--dataloader.batch_size", "4",
                        "--dataloader.gravity_dataset.sim_length", "300",
                        "--trainer.steps_per_epoch", "2", "--trainer.train_steps", "1",
                        "--trainer.test_macros_every", "1", "--trainer.self_feed_limit_steps",
                        "10"])
    assert trainer.step_count == 1 and trainer.args.model_type == "equiformer_v2"
    assert trainer.model.alpha_drop == 0.1 and trainer.model.drop_path_rate == 0.05
    tree = weights.read_checkpoint(os.path.join(trainer.save_dir_path, "model.ckpt"))["params"]
    assert weights.jax_family(tree) == "equiformer_v2"
    assert os.path.exists(os.path.join(trainer.save_dir_path, "checkpoints", "1",
                                       "sticking_distributions.json"))
    inf = TINF.Inferencer(trainer.save_dir_path, device="cpu")
    assert inf.train_mode
    loc0, vel0, force0, mass = inf.dataset.get_ground_truth_trajectories(3)
    scene0 = Scene(loc0[:, 0], vel0[:, 0], force0[:, 0], mass)
    a, b, c = (inf.rollout(scene0, 6, rng=r)[0] for r in (2, 2, 3))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("params", [dict(lr=0.3, num_layers=8, num_heads=8, channel_base=128),
                                    dict(lr=0.1, num_layers=6, num_heads=4, channel_base=192),
                                    dict(lr=1.0, num_layers=10, num_heads=8, channel_base=112)])
def test_hpo_width_bisection_equals_jax(params):
    mk, trainer = TH.trial_to_overrides("equiformer_v2", params)
    assert (mk, trainer) == JH.trial_to_overrides("equiformer_v2", params)
    assert (mk["sphere_channels"] == mk["attn_hidden_channels"] == mk["ffn_hidden_channels"]
            == params["channel_base"])
    for target in (TH.PARAM_TARGETS["param_small"], TH.PARAM_TARGETS["param_medium"]):
        got = TH.adjust_width_to_target("equiformer_v2", mk, target)
        assert got == JH.adjust_width_to_target("equiformer_v2", mk, target)
        kw, n = got
        assert kw["sphere_channels"] % params["num_heads"] == 0
        assert kw["sphere_channels"] == kw["attn_hidden_channels"] == kw["ffn_hidden_channels"]
        assert n == TH._count_params("equiformer_v2", kw, 5)


def test_hpo_runs_an_equiformer_study(tmp_path):
    """Two param_small trials: each trial's widths are the bisection's, in
    lockstep, and its count theirs.  At width steps of 16 the bisection can
    stop outside the 7% band (the first trial, L8 with 4 heads, ends at
    width 48 and 2,379,506 parameters), and the study goes on with it, as the
    JAX package's does.  ``chip_smoke.py`` holds the card's study to the same
    widths and counts (its ``EQV2_HPO_WANT``)."""
    seen = []
    best = TH.run_study("equiformer_v2", trials=2, mode="param_small", study_dir=str(tmp_path),
                        objective_fn=lambda mk, tr: seen.append(mk) or -float(len(seen)))
    assert len(seen) == 2 and best["value"] == -1.0
    history = []
    for mk in seen:
        assert mk["sphere_channels"] == mk["attn_hidden_channels"] == mk["ffn_hidden_channels"]
        sampled = TH.suggest_trial("equiformer_v2", history)
        want = JH.adjust_width_to_target(
            "equiformer_v2", JH.trial_to_overrides("equiformer_v2", sampled)[0], 1_800_000)
        assert (mk, TH._count_params("equiformer_v2", mk, 5)) == want
        assert want == SMOKE.EQV2_HPO_WANT[len(history)]
        history.append({"params": sampled, "value": -float(len(history) + 1)})
    assert seen[0]["sphere_channels"] == 48 and seen[0]["num_layers"] == 8
