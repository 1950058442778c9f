"""PONITA's training path in the port against the JAX package's ``Trainer``.

Both trainers are built from one argv (a small PONITA: 2 layers, width 16, 6
orientations, basis 16; N=5, B=4, float64), after both dataset classes are
made to return the same numpy trajectory batch, so both constructors draw the
same first batch.  The JAX trainer's initial parameters (cast to float64) are
caught on their way into its ``calibrate_params`` and given to the port's
model, so both calibrate the same parameters on the same batch:

* the port's trainer calibrates on its first batch: its parameters agree with
  the JAX trainer's within 1e-12 of each tensor's largest value, its
  statistics with the JAX trainer's ``calib`` within 1e-12 relative, and its
  ``n_params`` is the JAX trainer's (the parameters and 3 statistics a layer);
* one training step each (one epoch of one step): the parameters after the
  update agree within 1e-9 of each tensor's largest value.  (The JAX
  optimizer also decays its ``calib`` leaves by the weight decay; nothing
  reads them, and the port leaves its statistics as calibrated);
* the port's checkpoint keeps the JAX key layout, ``calib`` and AdamW's
  ``mu`` / ``nu`` included, and the JAX package's ``load_run`` reads the
  port's run dir into params that give the port model's output;
* a 20-step self-feed rollout of the trained parameters agrees with the JAX
  package's from the same GT arrays within 1e-8 (the closed loop amplifies
  last-bit differences), with equal ``survived``;
* ``cli train --main.model_type ponita`` runs a tiny training on the CPU;
* on a stand-in for the card, a float64 and a bf16 PONITA trainer build and
  step: the precision refusal is about the edge kernel, which PONITA lacks;
* both trainers resume the committed 10M checkpoint with its AdamW state and
  take the same step (tolerances in the test's docstring).
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
jponita = importlib.import_module(TPU + ".models.ponita")
jrollout = importlib.import_module(TPU + ".rollout")
JScene = importlib.import_module(TPU + ".core.scene").Scene
TOTF = importlib.import_module(PORT + ".data.gravity_otf")
TT = importlib.import_module(PORT + ".train.trainer")
TDL = importlib.import_module(PORT + ".data.dataloaders")
TCFG = importlib.import_module(PORT + ".utils.config")
tgraph = importlib.import_module(PORT + ".core.graph")
tmodels = importlib.import_module(PORT + ".models")
tponita = importlib.import_module(PORT + ".models.ponita")
trollout = importlib.import_module(PORT + ".rollout.self_feed")
physics = importlib.import_module(PORT + ".core.physics")
weights = importlib.import_module(PORT + ".weights")
cli = importlib.import_module(PORT + ".cli")
Scene = importlib.import_module(PORT + ".core.scene").Scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "docs", "results", "ponita10m_r5_partial", "model.ckpt")
B, N, FRAMES = 4, 5, 20
SMALL = ["--main.model_type", "ponita", "--model.num_layers", "2", "--model.hidden_features",
         "16", "--model.num_ori", "6", "--model.basis_dim", "16"]
ARGV = SMALL + ["--dataloader.batch_size", str(B), "--dataloader.gravity_dataset.sim_length",
                str(FRAMES * 10), "--dataloader.seed", "5",
                "--dataloader.double_precision", "true", "--trainer.precision_mode", "double",
                "--trainer.steps_per_epoch", "1", "--trainer.learning_rate_warmup_steps", "4"]
CALIB_RTOL, PARAM_RTOL, ROLLOUT_ATOL = 1e-12, 1e-9, 1e-8
ROLLOUT_FRAMES = 21


def _batch():
    """One float64 GT batch from the plain integrator, as numpy arrays."""
    loc, vel, force, mass = physics.sample_trajectory_batch(
        B, N, T=FRAMES * 10, sample_freq=10, dtype=torch.float64, device="cpu",
        generator=torch.Generator().manual_seed(1))
    return {"loc": loc.numpy(), "vel": vel.numpy(), "force": force.numpy(), "mass": mass.numpy()}


def _f64(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), tree)


def _assert_rel(got, want, rtol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert got.shape == want.shape and err <= rtol * scale, f"{what}: {err} vs {scale}"


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("ponita")
    traj = _batch()
    mp.setattr(JOTF.GravityDatasetOtf, "generate_trajectories",
               lambda self, bs: {k: jnp.asarray(v) for k, v in traj.items()})
    mp.setattr(TOTF.GravityDatasetOtf, "generate_trajectories",
               lambda self, bs: {k: torch.from_numpy(v.copy()) for k, v in traj.items()})
    caught = {}
    calibrate = jponita.calibrate_params

    def catching(model, params, scene, mask):
        caught["params"] = _f64(params)  # the JAX trainer's initial parameters
        return calibrate(model, caught["params"], scene, mask)

    mp.setattr(jponita, "calibrate_params", catching)
    try:
        for name in ("jax", "torch"):
            (root / name).mkdir()
        mp.chdir(root / "jax")
        jargs, jcfg = JCFG.parse_args(ARGV + ["--trainer.run_name", "jax"])
        jt = JT.create_trainer_from_args(jargs, resolved_config=jcfg)
        jt.opt_state = jt.tx.init(jt.params)  # over the float64 params

        mp.chdir(root / "torch")
        targs, tcfg = TCFG.parse_args(ARGV + ["--trainer.run_name", "torch"])
        model = tmodels.create_model("ponita", device="cpu", dtype=torch.float64,
                                     **targs.model_kwargs)
        model.load_state_dict(weights.params_from_jax(caught["params"], "ponita"))
        dataset = TDL.create_dataloader(targs, device="cpu").dataset
        tt = TT.Trainer(model, dataset, targs, resolved_config=tcfg, device="cpu")
        calibrated = ({k: v.clone() for k, v in tt.model.state_dict().items()},
                      jax.tree_util.tree_map(np.array, jt.params))
        mp.chdir(root / "jax")
        jt.train_one_epoch()
        mp.chdir(root / "torch")
        tt.train_one_epoch()
        tt.step_count = jt.step_count = 1
        path = tt.save_model()
        yield dict(jt=jt, tt=tt, root=root, calibrated=calibrated, ckpt=path)
    finally:
        mp.undo()


def test_trainer_calibrates_on_its_first_batch_as_jax_does(pair):
    sd, jparams = pair["calibrated"]
    want = weights.params_from_jax(jparams, "ponita")
    assert set(sd) == set(want)
    for name, w in want.items():
        if name.endswith(tponita.CALIB_STATS):
            assert abs(float(sd[name]) - float(w)) <= CALIB_RTOL * float(w), name
        else:
            _assert_rel(sd[name].numpy(), w.numpy(), CALIB_RTOL, name)
    assert float(sd["blocks.1.conv.std_1"]) != 1.0  # measured, not the initial ones
    assert pair["tt"].n_params == pair["jt"].n_params


def test_one_training_step_matches_jax(pair):
    want = weights.params_from_jax(pair["jt"].params, "ponita", calib=False)
    got = dict(pair["tt"].model.named_parameters())
    assert set(got) == set(want)
    moved = 0
    for name, w in want.items():
        _assert_rel(got[name].detach().numpy(), w.numpy(), PARAM_RTOL, name)
        moved += not torch.equal(got[name].detach(), pair["calibrated"][0][name])
    assert moved == len(want) and pair["tt"].optim.count == 1


def test_checkpoint_keeps_the_jax_layout_and_jax_reads_it(pair):
    payload = weights.read_checkpoint(pair["ckpt"])
    jtree = jax.tree_util.tree_structure(pair["jt"].params)
    assert jax.tree_util.tree_structure(payload["params"]) == jtree
    for moment in weights._find_adam(payload["opt_state"])[1:]:  # mu, nu
        assert jax.tree_util.tree_structure(moment) == jtree
        assert all(v[0] == 0.0 for conv in moment["calib"].values()
                   for stats in conv.values() for v in stats.values())
    run_dir = os.path.join(str(pair["root"] / "torch"), pair["tt"].save_dir_path)
    jmodel, jparams, _, _ = JR.load_run(run_dir, seed=0)
    rng = np.random.default_rng(3)
    arrs = [rng.normal(size=(2, N, 3)), rng.normal(size=(2, N, 3)), np.zeros((2, N, 3)),
            np.ones((2, N, 1))]
    js = JScene(*(jnp.asarray(a) for a in arrs))
    ts = Scene(*(torch.from_numpy(a) for a in arrs))
    want = np.asarray(jmodel.apply(_f64(jparams), js, jnp.asarray(~np.eye(N, dtype=bool))[None]))
    with torch.no_grad():
        got = pair["tt"].model(ts, tgraph.knn_mask(ts.pos, N - 1)).numpy()
    _assert_rel(got, want, 1e-10, "JAX load_run of the port's run")


def test_self_feed_rollout_matches_jax(pair):
    traj = _batch()
    arrs = [traj[k][:, 0] for k in ("loc", "vel", "force")] + [traj["mass"]]
    jloc, jvel, jsurv = jrollout.make_rollout_fn(pair["jt"].model, ROLLOUT_FRAMES)(
        pair["jt"].params, JScene(*(jnp.asarray(a) for a in arrs)))
    loc, vel, surv = trollout.make_rollout_fn(pair["tt"].model, ROLLOUT_FRAMES)(
        Scene(*(torch.from_numpy(a) for a in arrs)))
    assert loc.shape == (B, ROLLOUT_FRAMES, N, 3) and torch.isfinite(loc).all()
    np.testing.assert_allclose(loc.numpy(), np.asarray(jloc), rtol=0, atol=ROLLOUT_ATOL)
    np.testing.assert_allclose(vel.numpy(), np.asarray(jvel), rtol=0, atol=ROLLOUT_ATOL)
    np.testing.assert_array_equal(surv.numpy(), np.asarray(jsurv))


def test_cli_trains_ponita_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trainer = cli.main(["train", "--device", "cpu", *SMALL, "--dataloader.batch_size", "4",
                        "--dataloader.gravity_dataset.sim_length", "300",
                        "--trainer.steps_per_epoch", "2", "--trainer.train_steps", "1",
                        "--trainer.test_macros_every", "1", "--trainer.self_feed_limit_steps",
                        "10"])
    assert trainer.step_count == 1 and isinstance(trainer.model, tponita.PONITA)
    assert float(trainer.model.blocks[0].conv.std_in) != 1.0  # calibrated
    tree = weights.read_checkpoint(os.path.join(trainer.save_dir_path, "model.ckpt"))["params"]
    assert set(tree) == {"params", "calib"}
    assert os.path.exists(os.path.join(trainer.save_dir_path, "checkpoints", "1",
                                       "sticking_distributions.json"))


class _OneBatch:
    """Stands in for a dataset: one float32 batch, then the next draw raises."""

    def __init__(self):
        rng = np.random.default_rng(6)
        self.batch = (Scene(*(torch.from_numpy(rng.normal(size=(2, N, 3))).float()
                              for _ in range(3)), torch.ones(2, N, 1)), None)

    def get_batch(self):
        batch, self.batch = self.batch, None
        if batch is None:
            raise StopIteration
        return batch

    def get_serializable_attributes(self):
        return {}


@pytest.mark.parametrize("mode", ["double", "bfloat16"])
def test_edge_stage_checks_pass_a_model_without_one(mode, tmp_path, monkeypatch):
    """On a stand-in for the card, a non-float32 PONITA run builds (the
    precision refusal is about the edge kernel, which PONITA does not have),
    and its training step passes no ``edge_impl``."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(importlib.import_module(PORT + ".ops._build"), "wants_kernel",
                        lambda t: True)
    args, _ = TCFG.parse_args(SMALL + ["--trainer.precision_mode", mode])
    model = tmodels.create_model("ponita", device="cpu", **args.model_kwargs)
    assert not tmodels.has_edge_stage(model)
    trainer = TT.Trainer(model, _OneBatch(), args, device="cpu")
    rng = np.random.default_rng(7)
    scene = Scene(*(torch.from_numpy(rng.normal(size=(2, N, 3))).float() for _ in range(3)),
                  torch.ones(2, N, 1))
    vec = trainer._train_step(scene, torch.from_numpy(rng.normal(size=(2, N, 6))).float())
    assert torch.isfinite(vec).all() and trainer.optim.count == 1


def test_committed_checkpoint_resumes_and_steps_as_jax_does(tmp_path, monkeypatch):
    """Both trainers resume the committed 10M checkpoint (L5 h480) with its
    AdamW state (count 90000) and take one step on the same batch (B=2,
    computed in float64 from the float32 parameters, as both packages do):
    the parameters agree within 1e-7 of their largest value, and each
    parameter's update within 1e-3 of its largest update plus two float32
    ulps of the parameter (both packages round the float32 update in their
    own order; an update made with wrong moments, count or rate is off by
    its own size)."""
    traj = {k: v[:2] for k, v in _batch().items()}
    monkeypatch.setattr(JOTF.GravityDatasetOtf, "generate_trajectories",
                        lambda self, bs: {k: jnp.asarray(v) for k, v in traj.items()})
    monkeypatch.setattr(TOTF.GravityDatasetOtf, "generate_trajectories",
                        lambda self, bs: {k: torch.from_numpy(v.copy()) for k, v in traj.items()})
    argv = ["--main.model_type", "ponita", "--model.num_layers", "5",
            "--model.hidden_features", "480", "--dataloader.batch_size", "2",
            "--dataloader.gravity_dataset.sim_length", str(FRAMES * 10),
            "--dataloader.seed", "5", "--trainer.precision_mode", "double",
            "--trainer.steps_per_epoch", "1"]
    trainers = {}
    for name, cfg, create in (("jax", JCFG, JT.create_trainer_from_args),
                              ("torch", TCFG, TT.create_trainer_from_args)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        ckpt = shutil.copy(CKPT, tmp_path / name)  # a resumed run links into its folder
        args, resolved = cfg.parse_args(argv + ["--trainer.model_path", str(ckpt)])
        kw = {"device": "cpu"} if name == "torch" else {}
        trainers[name] = create(args, resolved_config=resolved, **kw)
    jt, tt = trainers["jax"], trainers["torch"]
    assert tt.optim.count == 90000 and tt.step_count == jt.step_count == 90
    before = {k: v.detach().double().clone() for k, v in tt.model.named_parameters()}
    for name, t in trainers.items():
        monkeypatch.chdir(tmp_path / name)
        t.train_one_epoch()
    want = weights.params_from_jax(jt.params, "ponita", calib=False)
    for name, p in tt.model.named_parameters():
        got, w, b = p.detach().double(), want[name].double(), before[name]
        _assert_rel(got.numpy(), w.numpy(), 1e-7, name)
        du, dw = got - b, w - b
        allowed = 1e-3 * dw.abs().max() + 2 * 2.0**-23 * b.abs()
        assert bool(((du - dw).abs() <= allowed).all()) and dw.abs().max() > 0, name
    assert tt.optim.count == 90001
