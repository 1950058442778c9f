"""SEGNN's training path in the port against the JAX package's ``Trainer``.

* Both trainers resume the committed 10M checkpoint
  (``docs/results/segnn10m_r5/ckpt_110_model.ckpt``, L6 w448, epoch 110,
  AdamW count 110000) with the queue's argv and take one step on the same
  batch (B=2, N=5, computed in float64 from the float32 parameters, as both
  packages do): the parameters agree within 1e-7 of their largest value, and
  each parameter's update within 1e-3 of its largest update plus two float32
  ulps of the parameter (both packages round the float32 update in their own
  order; an update made with wrong moments, count or rate is off by its own
  size).
* Each package reads the other's run: the JAX package's ``load_run`` reads a
  run dir the port's trainer wrote (a small SEGNN, one step), and the port's
  ``load_run`` reads one the JAX trainer wrote; each model's output is the
  other's within 1e-10 relative.  The port's checkpoint keeps the JAX key
  layout, AdamW's ``mu`` and ``nu`` included.
* A 20-step self-feed rollout of a small SEGNN agrees with the JAX package's
  from the same GT arrays within 1e-8 (the closed loop amplifies last-bit
  differences), with equal ``survived``.
* ``cli train --main.model_type segnn`` trains a tiny SEGNN on the CPU, and a
  fresh SEConv trainer builds and steps.
"""

import importlib
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
jrollout = importlib.import_module(TPU + ".rollout")
JScene = importlib.import_module(TPU + ".core.scene").Scene
TOTF = importlib.import_module(PORT + ".data.gravity_otf")
TT = importlib.import_module(PORT + ".train.trainer")
TCFG = importlib.import_module(PORT + ".utils.config")
TR = importlib.import_module(PORT + ".train.restore")
TDL = importlib.import_module(PORT + ".data.dataloaders")
tgraph = importlib.import_module(PORT + ".core.graph")
tmodels = importlib.import_module(PORT + ".models")
tsegnn = importlib.import_module(PORT + ".models.segnn")
trollout = importlib.import_module(PORT + ".rollout.self_feed")
physics = importlib.import_module(PORT + ".core.physics")
weights = importlib.import_module(PORT + ".weights")
cli = importlib.import_module(PORT + ".cli")
Scene = importlib.import_module(PORT + ".core.scene").Scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "docs", "results", "segnn10m_r5", "ckpt_110_model.ckpt")
N, FRAMES = 5, 20
QUEUE = ["--main.model_type", "segnn", "--model.num_layers", "6",
         "--model.hidden_features", "448"]
SMALL = ["--main.model_type", "segnn", "--model.num_layers", "2",
         "--model.hidden_features", "16"]
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


def _trainers(tmp_path, monkeypatch, argv, resume=None):
    """The JAX and the port's trainer of ``argv`` in their own directories,
    each resumed from its own copy of ``resume`` (a resumed run links itself
    into the checkpoint's folder)."""
    trainers = {}
    for name, cfg, create in (("jax", JCFG, JT.create_trainer_from_args),
                              ("torch", TCFG, TT.create_trainer_from_args)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        extra = (["--trainer.model_path", str(shutil.copy(resume, tmp_path / name))]
                 if resume else [])
        args, resolved = cfg.parse_args(argv + extra)
        kw = {"device": "cpu"} if name == "torch" else {}
        trainers[name] = create(args, resolved_config=resolved, **kw)
    return trainers["jax"], trainers["torch"]


def test_committed_checkpoint_resumes_and_steps_as_jax_does(tmp_path, monkeypatch):
    _same_batches(monkeypatch, _batch(2))
    argv = QUEUE + ["--dataloader.batch_size", "2",
                    "--dataloader.gravity_dataset.sim_length", str(FRAMES * 10),
                    "--dataloader.seed", "5", "--trainer.precision_mode", "double",
                    "--trainer.steps_per_epoch", "1"]
    jt, tt = _trainers(tmp_path, monkeypatch, argv, CKPT)
    assert tt.optim.count == 110_000 and tt.step_count == jt.step_count == 110
    assert tt.n_params == jt.n_params == 10_557_344
    assert tt.best_metrics == {"self_feed_steps": 1000}
    before = {k: v.detach().double().clone() for k, v in tt.model.named_parameters()}
    for name, t in (("jax", jt), ("torch", tt)):
        monkeypatch.chdir(tmp_path / name)
        t.train_one_epoch()
    want = weights.params_from_jax(jt.params, "segnn")
    for name, p in tt.model.named_parameters():
        got, w, b = p.detach().double(), want[name].double(), before[name]
        _assert_rel(got.numpy(), w.numpy(), 1e-7, name)
        du, dw = got - b, w - b
        allowed = 1e-3 * dw.abs().max() + 2 * 2.0**-23 * b.abs()
        assert bool(((du - dw).abs() <= allowed).all()) and dw.abs().max() > 0, name
    assert tt.optim.count == 110_001


@pytest.fixture(scope="module")
def small_pair(tmp_path_factory):
    """A small SEGNN trained one step by each package from the same float64
    parameters, on the same batch, each saving its run."""
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("segnn")
    _same_batches(mp, _batch(4))
    argv = SMALL + ["--dataloader.batch_size", "4",
                    "--dataloader.gravity_dataset.sim_length", str(FRAMES * 10),
                    "--dataloader.seed", "5", "--dataloader.double_precision", "true",
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
        model = tmodels.create_model("segnn", device="cpu", dtype=torch.float64,
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


def test_small_step_matches_jax(small_pair):
    want = weights.params_from_jax(small_pair["jt"].params, "segnn")
    for name, p in small_pair["tt"].model.named_parameters():
        _assert_rel(p.detach().numpy(), want[name].numpy(), 1e-9, name)


def test_jax_reads_the_ports_run(small_pair):
    tt = small_pair["tt"]
    payload = weights.read_checkpoint(os.path.join(small_pair["root"] / "torch",
                                                   tt.save_dir_path, "model.ckpt"))
    jtree = jax.tree_util.tree_structure(small_pair["jt"].params)
    assert jax.tree_util.tree_structure(payload["params"]) == jtree
    for moment in weights._find_adam(payload["opt_state"])[1:]:  # mu, nu
        assert jax.tree_util.tree_structure(moment) == jtree
    run_dir = os.path.join(str(small_pair["root"] / "torch"), tt.save_dir_path)
    jmodel, jparams, _, _ = JR.load_run(run_dir, seed=0)
    arrs = _scene_arrays()
    js = JScene(*(jnp.asarray(a) for a in arrs))
    want = np.asarray(jmodel.apply(_f64(jparams), js, jnp.asarray(~np.eye(N, dtype=bool))[None]))
    with torch.no_grad():
        got = tt.model(Scene(*(torch.from_numpy(a) for a in arrs)),
                       tgraph.knn_mask(torch.from_numpy(arrs[0]), N - 1)).numpy()
    _assert_rel(got, want, READ_RTOL, "JAX load_run of the port's run")


def test_the_port_reads_the_jax_run(small_pair):
    jt = small_pair["jt"]
    run_dir = os.path.join(str(small_pair["root"] / "jax"), jt.save_dir_path)
    model, dataset, args = TR.load_run(run_dir, seed=0, device="cpu")
    assert isinstance(model, tsegnn.SEGNN) and args.model_type == "segnn"
    assert dataset.num_nodes == N
    arrs = _scene_arrays(seed=4)
    js = JScene(*(jnp.asarray(a) for a in arrs))
    want = np.asarray(jt.model.apply(_f64(jt.params), js,
                                     jnp.asarray(~np.eye(N, dtype=bool))[None]))
    model = model.double()
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
    loc, vel, surv = trollout.make_rollout_fn(small_pair["tt"].model, FRAMES + 1)(
        Scene(*(torch.from_numpy(a) for a in arrs)))
    assert loc.shape == (4, FRAMES + 1, N, 3) and torch.isfinite(loc).all()
    np.testing.assert_allclose(loc.numpy(), np.asarray(jloc), rtol=0, atol=ROLLOUT_ATOL)
    np.testing.assert_allclose(vel.numpy(), np.asarray(jvel), rtol=0, atol=ROLLOUT_ATOL)
    np.testing.assert_array_equal(surv.numpy(), np.asarray(jsurv))


@pytest.mark.parametrize("family_argv", [SMALL, ["--main.model_type", "seconv",
                                                 "--model.num_layers", "2",
                                                 "--model.hidden_features", "16"]])
def test_cli_trains_the_steerable_families_on_the_cpu(family_argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trainer = cli.main(["train", "--device", "cpu", *family_argv, "--dataloader.batch_size", "4",
                        "--dataloader.gravity_dataset.sim_length", "300",
                        "--trainer.steps_per_epoch", "2", "--trainer.train_steps", "1",
                        "--trainer.test_macros_every", "1", "--trainer.self_feed_limit_steps",
                        "10"])
    family = family_argv[1]
    assert trainer.step_count == 1 and trainer.args.model_type == family
    assert isinstance(trainer.model, tsegnn.SEGNN if family == "segnn" else tsegnn.SEConv)
    tree = weights.read_checkpoint(os.path.join(trainer.save_dir_path, "model.ckpt"))["params"]
    assert weights.jax_family(tree) == family
    assert os.path.exists(os.path.join(trainer.save_dir_path, "checkpoints", "1",
                                       "sticking_distributions.json"))
