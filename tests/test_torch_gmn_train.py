"""GMN's training, evaluation and search paths in the port against the JAX package's.

* A small GMN (5 isolated bodies, ``tanh`` on so that ``coords_range``,
  which no output reads, is in the tree; ``remat`` on in the port and off in
  the JAX package: the tree is the same), trained one step by each package from the same float64
  parameters on the same batch: every parameter agrees within 1e-12 of the
  model's largest parameter value, and every tensor's update within 1e-9 of
  its largest update plus two float64 ulps of the parameter.  The
  parameters no output reads (``coords_range`` and
  the last layer's node model) get no gradient in the port and zeros in the
  JAX package: both decay them alike.  Then both packages resume the JAX trainer's
  checkpoint (its parameters and AdamW state) and take one more step on the
  same batch, held the same way, and the port's AdamW count goes on from the
  saved one.  Both resume into float64 trees: the port's
  trainer around a float64 model, and the JAX trainer handed the
  checkpoint's tree as written (it restores a checkpoint into the dtypes of
  its fresh tree, where under the tests' x64 CGENN's normal-initialised
  weights are float32 and ``coords_range`` float64).
* Each package's ``load_run`` of the other's run dir gives the other's
  outputs within 1e-10; the port's checkpoint keeps the JAX key layout,
  AdamW's ``mu`` and ``nu`` included.
* A 20-step self-feed rollout of the small model agrees with the JAX
  package's from the same GT arrays within 1e-8.
* ``cli train`` trains a tiny GMN on the CPU, resumes from its own
  checkpoint with the AdamW count going on, and ``cli self-feed`` and ``cli
  validate`` read its run.
* HPO: GMN's space has no width knob, so its search runs ``mode="free"``:
  a free study samples the JAX package's trials (the learning rate only) and
  the ``hpo`` main trains a GMN trial on the CPU.
"""

import importlib
import math
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
JCK = importlib.import_module(TPU + ".train.checkpoint")
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
TG = importlib.import_module(PORT + ".models.gmn")
trollout = importlib.import_module(PORT + ".rollout.self_feed")
physics = importlib.import_module(PORT + ".core.physics")
weights = importlib.import_module(PORT + ".weights")
cli = importlib.import_module(PORT + ".cli")
Scene = importlib.import_module(PORT + ".core.scene").Scene

N, FRAMES = 5, 20
SMALL = ["--main.model_type", "gmn", "--model.num_layers", "2", "--model.hidden_features", "8",
         "--model.tanh", "true"]
STEP_RTOL, UPDATE_RTOL, READ_RTOL, ROLLOUT_ATOL = 1e-12, 1e-9, 1e-10, 1e-8
ULP = 2.0**-52


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


def _assert_step(model, jparams, before, what):
    """Each parameter within STEP_RTOL of the model's largest parameter value,
    each tensor's update within UPDATE_RTOL of its largest update plus two
    float64 ulps of the parameter (a tensor no output reads moves by its
    weight decay alone, ~1e-13 of itself, which the two packages round apart:
    ``p * (1 - lr wd)`` here, ``p - lr (wd p)`` in optax)."""
    want = weights.params_from_jax(jparams, "gmn")
    scale = max(v.abs().max().item() for v in want.values())
    for name, p in model.named_parameters():
        got, w, b = p.detach(), want[name], before[name]
        assert (got - w).abs().max().item() <= STEP_RTOL * scale, f"{what}: {name}"
        du, dw = got - b, w - b
        allowed = UPDATE_RTOL * dw.abs().max() + 2 * ULP * b.abs()
        assert bool(((du - dw).abs() <= allowed).all()), f"{what}: {name}'s update"


@pytest.fixture(scope="module")
def small_pair(tmp_path_factory):
    """One step of each package from the same float64 parameters on the same
    batch, each saving its run; then both resume the JAX run's checkpoint and
    take one more step."""
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("gmn")
    traj = _batch(4)
    mp.setattr(JOTF.GravityDatasetOtf, "generate_trajectories",
               lambda self, bs: {k: jnp.asarray(v) for k, v in traj.items()})
    mp.setattr(TOTF.GravityDatasetOtf, "generate_trajectories",
               lambda self, bs: {k: torch.from_numpy(v.copy()) for k, v in traj.items()})
    argv = SMALL + [
        "--dataloader.batch_size", "4", "--dataloader.gravity_dataset.sim_length",
        str(FRAMES * 10), "--dataloader.seed", "5", "--dataloader.double_precision", "true",
        "--trainer.precision_mode", "double", "--trainer.steps_per_epoch", "1"]
    try:
        for name in ("jax", "torch", "jax_resumed", "torch_resumed"):
            (root / name).mkdir()
        mp.chdir(root / "jax")
        jargs, jcfg = JCFG.parse_args(argv + ["--trainer.run_name", "jax"])
        jt = JT.create_trainer_from_args(jargs, resolved_config=jcfg)
        mp.chdir(root / "torch")
        targs, tcfg = TCFG.parse_args(argv + ["--model.remat", "true",
                                              "--trainer.run_name", "torch"])
        torch.manual_seed(0)
        model = tmodels.create_model("gmn", device="cpu", dtype=torch.float64,
                                     **targs.model_kwargs)
        assert model.remat
        tt = TT.Trainer(model, TDL.create_dataloader(targs, device="cpu").dataset, targs,
                        resolved_config=tcfg, device="cpu")
        init = {k: v.clone() for k, v in model.state_dict().items()}
        jt.params = weights.params_to_jax(model.state_dict())
        jt.opt_state = jt.tx.init(jt.params)
        for name, t in (("jax", jt), ("torch", tt)):
            mp.chdir(root / name)
            t.train_one_epoch()
            t.step_count = 1
            t.save_model()
        ckpt = os.path.join(str(root / "jax"), jt.save_dir_path, "model.ckpt")
        resumed = {}
        for name, cfg in (("jax_resumed", JCFG), ("torch_resumed", TCFG)):
            mp.chdir(root / name)
            # a resumed run links itself into the checkpoint's folder: resume a copy
            args, resolved = cfg.parse_args(argv + [
                "--trainer.model_path", str(shutil.copy(ckpt, root / name)),
                "--trainer.train_steps", "2", "--trainer.run_name", name])
            if name == "jax_resumed":
                t = JT.create_trainer_from_args(args, resolved_config=resolved)
                written = JCK.load_checkpoint(ckpt)
                t.params, t.opt_state = written["params"], written["opt_state"]
            else:
                t = TT.Trainer(tmodels.create_model("gmn", device="cpu", dtype=torch.float64,
                                                    **args.model_kwargs),
                               TDL.create_dataloader(args, device="cpu").dataset, args,
                               resolved_config=resolved, device="cpu")
            t.train_one_epoch()
            resumed[name] = t
        yield dict(jt=jt, tt=tt, root=root, init=init, jt2=resumed["jax_resumed"],
                   tt2=resumed["torch_resumed"])
    finally:
        mp.undo()


def _scene_arrays(b=2, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, N, 3)), rng.normal(size=(b, N, 3)), np.zeros((b, N, 3)),
            np.ones((b, N, 1))]


def _fc(b):
    return jnp.asarray(~np.eye(N, dtype=bool))[None].repeat(b, 0)


def test_small_step_matches_jax(small_pair):
    _assert_step(small_pair["tt"].model, small_pair["jt"].params, small_pair["init"],
                 "first step")


def test_resumed_step_matches_jax(small_pair):
    tt2, jt2 = small_pair["tt2"], small_pair["jt2"]
    assert tt2.optim.count == 2 and isinstance(tt2.model, TG.GMN)
    assert tt2.model.get_model_size() == 8 and "blocks.1.coords_range" in tt2.model.state_dict()
    _assert_step(tt2.model, jt2.params, weights.params_from_jax(small_pair["jt"].params, "gmn"),
                 "resumed step")


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
    want = np.asarray(jmodel.apply(_f64(jparams), JScene(*(jnp.asarray(a) for a in arrs)),
                                   _fc(2)))
    tt.model.eval()
    ts = Scene(*(torch.from_numpy(a) for a in arrs))
    with torch.no_grad():
        got = tt.model(ts, tgraph.knn_mask(ts.pos, N - 1)).numpy()
    _assert_rel(got, want, READ_RTOL, "JAX load_run of the port's run")


def test_the_port_reads_the_jax_run(small_pair):
    jt = small_pair["jt"]
    run_dir = os.path.join(str(small_pair["root"] / "jax"), jt.save_dir_path)
    model, dataset, args = TR.load_run(run_dir, seed=0, device="cpu")
    assert isinstance(model, TG.GMN) and args.model_type == "gmn"
    arrs = _scene_arrays(seed=4)
    want = np.asarray(jt.model.apply(_f64(jt.params), JScene(*(jnp.asarray(a) for a in arrs)),
                                     _fc(2)))
    model = model.double().eval()
    ts = Scene(*(torch.from_numpy(a) for a in arrs))
    with torch.no_grad():
        got = model(ts, tgraph.knn_mask(ts.pos, N - 1)).numpy()
    _assert_rel(got, want, READ_RTOL, "the port's load_run of a JAX run")


def test_self_feed_rollout_matches_jax(small_pair):
    traj = _batch(4)
    arrs = [traj[k][:, 0] for k in ("loc", "vel", "force")] + [traj["mass"]]
    jloc, jvel, jsurv = jrollout.make_rollout_fn(small_pair["jt"].model, FRAMES + 1)(
        small_pair["jt"].params, JScene(*(jnp.asarray(a) for a in arrs)))
    loc, vel, surv = trollout.make_rollout_fn(small_pair["tt"].model.eval(), FRAMES + 1)(
        Scene(*(torch.from_numpy(a) for a in arrs)))
    assert torch.isfinite(loc).all()
    np.testing.assert_allclose(loc.numpy(), np.asarray(jloc), rtol=0, atol=ROLLOUT_ATOL)
    np.testing.assert_allclose(vel.numpy(), np.asarray(jvel), rtol=0, atol=ROLLOUT_ATOL)
    np.testing.assert_array_equal(surv.numpy(), np.asarray(jsurv))


def test_cli_trains_resumes_scores_and_validates(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    common = ["--device", "cpu", *SMALL, "--dataloader.batch_size", "4",
              "--dataloader.gravity_dataset.sim_length", "300", "--trainer.steps_per_epoch", "2",
              "--trainer.test_macros_every", "1", "--trainer.self_feed_limit_steps", "10"]
    first = cli.main(["train", *common, "--trainer.train_steps", "1", "--trainer.run_name", "a"])
    assert first.step_count == 1 and first.n_params == tmodels.count_params(first.model)
    ckpt = os.path.join(first.save_dir_path, "model.ckpt")
    assert weights.jax_family(weights.read_checkpoint(ckpt)["params"]) == "gmn"
    second = cli.main(["train", *common, "--trainer.train_steps", "2", "--trainer.model_path",
                       ckpt, "--trainer.run_name", "b"])
    assert second.step_count == 2 and second.optim.count == 4
    summary = cli.main(["self-feed", "--device", "cpu", "--run_dir", second.save_dir_path,
                        "--draws", "1", "--steps", "12"])
    assert len(summary["draws"]) == 1 and 0 <= summary["draws"][0]["combined_pvalue"] <= 1
    result = cli.main(["validate", "--device", "cpu", "--run_dir", second.save_dir_path,
                       "--batches", "2"])
    assert all(math.isfinite(v) for v in result.values())


def test_hpo_runs_a_free_gmn_study(tmp_path):
    """Two free trials: the JAX package's sampled learning rates, the model
    at its defaults."""
    seen = []
    best = TH.run_study("gmn", trials=2, mode="free", study_dir=str(tmp_path),
                        objective_fn=lambda mk, tr: seen.append((mk, tr)) or -float(len(seen)))
    history = []
    for mk, tr in seen:
        sampled = TH.suggest_trial("gmn", history)
        assert sampled == JH.suggest_trial("gmn", history) and set(sampled) == {"lr"}
        assert (mk, tr) == TH.trial_to_overrides("gmn", sampled) == JH.trial_to_overrides(
            "gmn", sampled)
        history.append({"params": sampled, "value": -float(len(history) + 1)})
    assert len(seen) == 2 and best["status"] == "done"


def test_hpo_main_trains_a_gmn_trial_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    best = cli.main(["hpo", "--model_type", "gmn", "--trials", "1", "--device", "cpu",
                     "--mode", "free", "--train_epochs", "1", "--steps_per_epoch", "2",
                     "--self_feed_limit_steps", "6", "--batch_size", "4", "--sim_length", "100",
                     "--study_dir", "study"])
    assert best["status"] == "done" and math.isfinite(best["value"])
    assert best["n_params"] == 150_212
    assert (tmp_path / "study" / "gmn_free_summary.json").exists()
