"""The JAX package's ``Trainer`` resumes a run of the port.

For each combination of the optimizer's flags (none; clipping by value;
clipping by global norm; ``discard_nan_gradients``; all three), the port's
``Trainer`` (a small EGNN-MC, float64) takes two steps and writes its
checkpoint (``save_model``); under ``discard_nan_gradients`` its second step
has a NaN target, so it is skipped and counted.  The JAX package's
``Trainer``, built from the same argv with float64 parameters, resumes from
that file through its own ``load_model_from_checkpoint`` (which maps the
saved ``opt_state`` onto its live optax state, so the structure must be
optax's for those flags), and both take the next step on the same batch:
the parameters after it agree within 1e-12 of each tensor's largest value
(``tests/test_torch_train_optim.py``'s optax parity: the same float64
gradients up to the order of their sums), the counts and
``apply_if_finite``'s counters are equal, and a further NaN step leaves the
parameters of both as they were and counts alike.

Also here: the port reads its older checkpoints, whose ``opt_state`` is a
plain ``{"count", "mu", "nu"}``.
"""

import importlib
import os
import pickle

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
JScene = importlib.import_module(TPU + ".core.scene").Scene
TOTF = importlib.import_module(PORT + ".data.gravity_otf")
TT = importlib.import_module(PORT + ".train.trainer")
TDL = importlib.import_module(PORT + ".data.dataloaders")
TCFG = importlib.import_module(PORT + ".utils.config")
tmodels = importlib.import_module(PORT + ".models")
weights = importlib.import_module(PORT + ".weights")
Scene = importlib.import_module(PORT + ".core.scene").Scene

B, N, FRAMES = 4, 5, 20
ARGV = ["--model.num_layers", "2", "--model.hidden_node_dim", "16",
        "--model.hidden_edge_dim", "16", "--model.hidden_coord_dim", "16",
        "--dataloader.batch_size", str(B), "--dataloader.gravity_dataset.sim_length",
        str(FRAMES * 10), "--dataloader.seed", "5", "--dataloader.double_precision", "true",
        "--trainer.precision_mode", "double", "--trainer.learning_rate_warmup_steps", "4"]
FLAGS = {
    "plain": [],
    "clip_value": ["--trainer.clip_gradients_value", "0.05"],
    "clip_norm": ["--trainer.clip_gradients_norm", "0.1"],
    "discard": ["--trainer.discard_nan_gradients", "true"],
    "all": ["--trainer.clip_gradients_value", "0.05", "--trainer.clip_gradients_norm", "0.1",
            "--trainer.discard_nan_gradients", "true"],
}
RTOL = 1e-12


def _trajectories():
    rng = np.random.default_rng(0)
    return {"loc": rng.normal(size=(B, FRAMES, N, 3)), "vel": rng.normal(size=(B, FRAMES, N, 3)),
            "force": rng.normal(size=(B, FRAMES, N, 3)), "mass": rng.uniform(0.5, 1.5, (B, N, 1))}


def _batches(nan=None):
    """Four float64 ``(pos, vel, force, mass, y)`` batches; batch ``nan`` has a
    NaN target."""
    rng = np.random.default_rng(1)
    out = []
    for i in range(4):
        arrs = [rng.normal(size=(B, N, 3)), rng.normal(size=(B, N, 3)) * 0.3,
                rng.normal(size=(B, N, 3)), rng.uniform(0.5, 1.5, (B, N, 1)),
                rng.normal(size=(B, N, 6)) * 0.1]
        if i == nan:
            arrs[4][0, 0, 0] = np.nan
        out.append(arrs)
    return out


def _port_step(tt, arrs):
    tt._train_step(Scene(*(torch.from_numpy(a) for a in arrs[:4])), torch.from_numpy(arrs[4]))


def _jax_step(jt, arrs):
    js = JScene(*(jnp.asarray(a) for a in arrs[:4]))
    jt.params, jt.opt_state, jt._rng, _ = jt._train_step(jt.params, jt.opt_state, js,
                                                         jnp.asarray(arrs[4]), jt._rng)


def _jax_counters(opt_state):
    if type(opt_state).__name__ != "ApplyIfFiniteState":
        return None
    return (int(opt_state.notfinite_count), bool(opt_state.last_finite),
            int(opt_state.total_notfinite))


def _assert_params(tt, jt):
    want = weights.params_from_jax(jt.params)
    for name, p in tt.model.state_dict().items():
        w = want[name].numpy()
        assert np.abs(p.numpy() - w).max() <= RTOL * np.abs(w).max(), name


@pytest.fixture
def trajectories(monkeypatch):
    traj = _trajectories()
    monkeypatch.setattr(JOTF.GravityDatasetOtf, "generate_trajectories",
                        lambda self, bs: {k: jnp.asarray(v) for k, v in traj.items()})
    monkeypatch.setattr(TOTF.GravityDatasetOtf, "generate_trajectories",
                        lambda self, bs: {k: torch.from_numpy(v.copy()) for k, v in traj.items()})


def _port_trainer(argv):
    targs, tcfg = TCFG.parse_args(argv + ["--trainer.run_name", "torch"])
    model = tmodels.create_model("egnn_mc", device="cpu", dtype=torch.float64,
                                 **targs.model_kwargs)
    return TT.Trainer(model, TDL.create_dataloader(targs, device="cpu").dataset, targs,
                      resolved_config=tcfg, device="cpu")


@pytest.mark.parametrize("flags", list(FLAGS))
def test_jax_trainer_resumes_a_port_run(flags, trajectories, tmp_path, monkeypatch):
    argv = ARGV + FLAGS[flags]
    discard = "--trainer.discard_nan_gradients" in argv
    batches = _batches(nan=1 if discard else None)
    (tmp_path / "torch").mkdir()
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "torch")
    tt = _port_trainer(argv)
    for arrs in batches[:2]:
        _port_step(tt, arrs)
    tt.step_count = 2
    path = os.path.abspath(tt.save_model())
    counters = (1, False, 1) if discard else None
    assert tt.optim.count == (1 if discard else 2)
    if discard:
        assert tt.optim.skip_counts() == counters

    monkeypatch.chdir(tmp_path / "jax")
    jargs, jcfg = JCFG.parse_args(argv + ["--trainer.run_name", "jax"])
    jt = JT.create_trainer_from_args(jargs, resolved_config=jcfg)
    jt.params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64), jt.params)
    jt.opt_state = jt.tx.init(jt.params)
    live = jax.tree_util.tree_structure(jt.opt_state)
    jt.load_model_from_checkpoint(path)
    with open(path, "rb") as f:  # optax's own classes, read by plain pickle
        assert jax.tree_util.tree_structure(pickle.load(f)["opt_state"]) == live
    _assert_params(tt, jt)
    assert jt.step_count == 2 and _jax_counters(jt.opt_state) == counters

    _port_step(tt, batches[2])
    _jax_step(jt, batches[2])
    _assert_params(tt, jt)
    count = tt.optim.count
    assert jax.tree_util.tree_leaves(jt.opt_state)[-1] == count  # the schedule's count
    if discard:
        assert tt.optim.skip_counts() == _jax_counters(jt.opt_state) == (0, True, 1)
        before = {k: v.clone() for k, v in tt.model.state_dict().items()}
        nan = [a.copy() for a in batches[3]]
        nan[4][1, 2, 3] = np.nan
        _port_step(tt, nan)
        _jax_step(jt, nan)
        assert all(torch.equal(v, before[k]) for k, v in tt.model.state_dict().items())
        _assert_params(tt, jt)
        assert tt.optim.count == count
        assert tt.optim.skip_counts() == _jax_counters(jt.opt_state) == (1, False, 2)


def test_the_port_reads_its_older_checkpoints(trajectories, tmp_path, monkeypatch):
    """A checkpoint whose ``opt_state`` is the port's older ``{"count", "mu",
    "nu"}`` resumes AdamW's count and moments as the new structure does."""
    monkeypatch.chdir(tmp_path)
    tt = _port_trainer(ARGV)
    for arrs in _batches()[:2]:
        _port_step(tt, arrs)
    payload = weights.read_checkpoint(os.path.abspath(tt.save_model()))
    count, mu, nu = weights._find_adam(payload["opt_state"])
    older = dict(payload, opt_state={"count": np.asarray(count), "mu": mu, "nu": nu})
    path = os.path.join(tmp_path, "older.ckpt")
    with open(path, "wb") as f:
        pickle.dump(older, f)
    for source in (payload, weights.read_checkpoint(path)):
        fresh = _port_trainer(ARGV)
        TT.load_training_state(fresh.model, fresh.optim, source, "egnn_mc")
        assert fresh.optim.count == 2
        for a, b in zip(fresh.optim.moments(), tt.optim.moments()):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
