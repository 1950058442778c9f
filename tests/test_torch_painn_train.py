"""PaiNN's training, evaluation and search paths in the port against the JAX package's.

* A small PaiNN with the stability run's toggles (``remat`` on in the port
  and off in the JAX package: the tree is the same) and gradient clipping by
  norm, trained one step by each package from the same float64 parameters on
  the same batch: the parameters agree within 1e-9 of their largest value.
  Each package's ``load_run`` of the other's run dir gives the other's
  outputs within 1e-10; the port's checkpoint keeps the JAX key layout,
  AdamW's ``mu`` and ``nu`` included.
* A 20-step self-feed rollout of the small model agrees with the JAX
  package's from the same GT arrays within 1e-8.
* ``cli train`` trains a tiny PaiNN on the CPU (``painn_nbody``: 4
  neighbours), resumes from its own checkpoint with the AdamW count going
  on, and ``cli self-feed`` and ``cli validate`` read its run.
* HPO: ``adjust_width_to_target`` bisects ``hidden_features`` to the JAX
  package's widths and counts; a ``param_small`` study samples the JAX
  package's trials; the ``hpo`` main trains a PaiNN trial on the CPU.
"""

import importlib
import math
import os

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
TP = importlib.import_module(PORT + ".models.painn")
trollout = importlib.import_module(PORT + ".rollout.self_feed")
physics = importlib.import_module(PORT + ".core.physics")
weights = importlib.import_module(PORT + ".weights")
cli = importlib.import_module(PORT + ".cli")
Scene = importlib.import_module(PORT + ".core.scene").Scene

N, FRAMES = 5, 20
TOGGLES = ["--model.residual_scale_interaction", "0.5", "--model.tanh_message_scale", "5.0",
           "--model.filter_gain", "0.5", "--model.clip_vector_msg_norm", "10.0",
           "--model.clip_scalar_msg_value", "10.0", "--model.residual_scale_mixing", "0.5",
           "--model.tanh_mixing_scale", "5.0", "--model.clip_mu_norm", "20.0",
           "--model.clip_q_value", "100.0", "--trainer.clip_gradients_norm", "1.0"]
SMALL = ["--main.model_type", "painn", "--model.num_layers", "2",
         "--model.hidden_features", "8", "--model.num_rbf", "6"] + TOGGLES
READ_RTOL, ROLLOUT_ATOL = 1e-10, 1e-8


def _batch(b):
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


@pytest.fixture(scope="module")
def small_pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("painn")
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
        for name in ("jax", "torch"):
            (root / name).mkdir()
        mp.chdir(root / "jax")
        jargs, jcfg = JCFG.parse_args(argv + ["--trainer.run_name", "jax"])
        jt = JT.create_trainer_from_args(jargs, resolved_config=jcfg)
        mp.chdir(root / "torch")
        targs, tcfg = TCFG.parse_args(argv + ["--model.remat", "true",
                                              "--trainer.run_name", "torch"])
        torch.manual_seed(0)
        model = tmodels.create_model("painn", device="cpu", dtype=torch.float64,
                                     **targs.model_kwargs)
        assert model.remat
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


def _fc(b):
    return jnp.asarray(~np.eye(N, dtype=bool))[None].repeat(b, 0)


def test_small_step_matches_jax(small_pair):
    tt = small_pair["tt"]
    assert tt.num_neighbors == 4 and tt.optim.clip_norm == 1.0
    want = weights.params_from_jax(small_pair["jt"].params, "painn")
    for name, p in tt.model.named_parameters():
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
    assert isinstance(model, TP.PaiNN) and args.model_type == "painn"
    assert model.blocks[0]._Interaction_0.tanh_message_scale == 5.0
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
    assert first.step_count == 1 and first.num_neighbors == 4
    ckpt = os.path.join(first.save_dir_path, "model.ckpt")
    tree = weights.read_checkpoint(ckpt)["params"]
    assert weights.jax_family(tree) == "painn"
    second = cli.main(["train", *common, "--trainer.train_steps", "2", "--trainer.model_path",
                       ckpt, "--trainer.run_name", "b"])
    assert second.step_count == 2 and second.optim.count == 4
    summary = cli.main(["self-feed", "--device", "cpu", "--run_dir", second.save_dir_path,
                        "--draws", "1", "--steps", "12"])
    assert len(summary["draws"]) == 1 and 0 <= summary["draws"][0]["combined_pvalue"] <= 1
    result = cli.main(["validate", "--device", "cpu", "--run_dir", second.save_dir_path,
                       "--batches", "2"])
    assert all(math.isfinite(v) for v in result.values())


@pytest.mark.parametrize("kw", [dict(hidden_features=128, num_layers=4),
                                dict(hidden_features=224, num_layers=8),
                                dict(hidden_features=160, num_layers=5)])
def test_hpo_width_bisection_equals_jax(kw):
    for target in (TH.PARAM_TARGETS["param_small"], TH.PARAM_TARGETS["param_medium"]):
        got = TH.adjust_width_to_target("painn", kw, target)
        assert got == JH.adjust_width_to_target("painn", kw, target)
        assert got[1] == TH._count_params("painn", got[0], 5)


def test_hpo_runs_a_painn_study(tmp_path):
    seen = []
    TH.run_study("painn", trials=2, mode="param_small", study_dir=str(tmp_path),
                 objective_fn=lambda mk, tr: seen.append(mk) or -float(len(seen)))
    history = []
    for mk in seen:
        sampled = TH.suggest_trial("painn", history)
        want = JH.adjust_width_to_target("painn", JH.trial_to_overrides("painn", sampled)[0],
                                         1_800_000)
        assert (mk, TH._count_params("painn", mk, 5)) == want
        assert abs(want[1] - 1_800_000) <= TH.PARAM_TOLERANCE * 1_800_000
        history.append({"params": sampled, "value": -float(len(history) + 1)})
    assert len(seen) == 2


def test_hpo_main_trains_a_painn_trial_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    best = cli.main(["hpo", "--model_type", "painn", "--trials", "1", "--device", "cpu",
                     "--mode", "param_small", "--train_epochs", "1", "--steps_per_epoch", "2",
                     "--self_feed_limit_steps", "6", "--batch_size", "4", "--sim_length", "100",
                     "--study_dir", "study"])
    assert best["status"] == "done" and math.isfinite(best["value"])
    assert abs(best["n_params"] - 1_800_000) <= TH.PARAM_TOLERANCE * 1_800_000
    assert (tmp_path / "study" / "painn_param_small_summary.json").exists()
