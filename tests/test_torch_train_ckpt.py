"""Checkpoints both ways between the port and the JAX package.

A port checkpoint (``train/checkpoint.py``: params in the flax layout by
``weights.params_to_jax``, AdamW's count and moments beside them) loads
through the JAX package's ``load_checkpoint``, and the JAX ``EGNNMC.apply`` on
its params equals the port's forward within 1e-10 relative (float64, a small
model).  The committed N=100 checkpoint resumes in the port's trainer with its
optimizer state: parameters equal ``params_from_jax``'s, ``exp_avg`` /
``exp_avg_sq`` equal optax's ``mu`` / ``nu``, the step equals optax's
``count``, and the next learning rate equals the JAX schedule's at that count.
The orbax backend round-trips in both packages.
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
jgraph = importlib.import_module(TPU + ".core.graph")
JScene = importlib.import_module(TPU + ".core.scene").Scene
jmodels = importlib.import_module(TPU + ".models")
JCK = importlib.import_module(TPU + ".train.checkpoint")
JO = importlib.import_module(TPU + ".train.optim")
tgraph = importlib.import_module(PORT + ".core.graph")
Scene = importlib.import_module(PORT + ".core.scene").Scene
tmodels = importlib.import_module(PORT + ".models")
weights = importlib.import_module(PORT + ".weights")
TCK = importlib.import_module(PORT + ".train.checkpoint")
TO = importlib.import_module(PORT + ".train.optim")
TT = importlib.import_module(PORT + ".train.trainer")
TCFG = importlib.import_module(PORT + ".utils.config")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "docs", "results", "fidelity_n100", "egnn_n100_ckpt_30_model.ckpt")
SMALL = dict(num_layers=2, hidden_node_dim=16, hidden_edge_dim=16, hidden_coord_dim=16)
B, N = 4, 5


def _scene(seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(B, N, 3))
    return pos, rng.normal(size=(B, N, 3)), np.zeros((B, N, 3)), np.ones((B, N, 1))


def _port_state(model, seed=0):
    """An optimizer over ``model`` with made-up count and moments."""
    opt = TO.create_optimizer(model.parameters(), 0.5, 16)
    rng = np.random.default_rng(seed)
    mu = [torch.from_numpy(rng.normal(size=p.shape)) for p in model.parameters()]
    nu = [torch.from_numpy(rng.uniform(size=p.shape)) for p in model.parameters()]
    opt.set_state(7, mu, nu)
    return opt


def _save(model, opt, path):
    names = [n for n, _ in model.named_parameters()]
    mu, nu = opt.moments()
    opt_state = {"count": np.asarray(opt.count, np.int32),
                 "mu": weights.params_to_jax(dict(zip(names, mu))),
                 "nu": weights.params_to_jax(dict(zip(names, nu)))}
    return TCK.save_checkpoint(str(path), weights.params_to_jax(model.state_dict()), opt_state,
                               3, {"self_feed_steps": 4})


def test_port_checkpoint_loads_in_jax_and_gives_the_same_forward(tmp_path):
    torch.manual_seed(0)
    model = tmodels.create_model("egnn_mc", device="cpu", dtype=torch.float64, **SMALL)
    path = _save(model, _port_state(model), tmp_path)
    ckpt = JCK.load_checkpoint(path)
    assert ckpt["step_count"] == 3 and ckpt["best_metrics"] == {"self_feed_steps": 4}
    arrs = _scene()
    js = JScene(*(jnp.asarray(a) for a in arrs))
    want = np.asarray(jmodels.create_model("egnn_mc", **SMALL).apply(
        ckpt["params"], js, jgraph.knn_mask(js.pos, N - 1)))
    scene = Scene(*(torch.from_numpy(a) for a in arrs))
    with torch.no_grad():
        got = model(scene, tgraph.knn_mask(scene.pos, N - 1)).numpy()
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def test_port_checkpoint_round_trips_with_its_optimizer_state(tmp_path):
    torch.manual_seed(1)
    model = tmodels.create_model("egnn_mc", device="cpu", dtype=torch.float64, **SMALL)
    opt = _port_state(model, seed=3)
    path = _save(model, opt, tmp_path)
    fresh = tmodels.create_model("egnn_mc", device="cpu", dtype=torch.float64, **SMALL)
    fresh_opt = TO.create_optimizer(fresh.parameters(), 0.5, 16)
    TT.load_training_state(fresh, fresh_opt, TCK.load_checkpoint(path))
    assert all(torch.equal(a, b) for a, b in zip(fresh.state_dict().values(),
                                                 model.state_dict().values()))
    for a, b in zip(fresh_opt.moments(), opt.moments()):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert fresh_opt.count == 7 and float(fresh_opt.lr) == float(opt.lr)


def test_committed_checkpoint_resumes_with_its_optimizer_state(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    # a copy: a resumed run links itself into the checkpoint's folder
    ckpt_copy = shutil.copy(CKPT, tmp_path)
    args, cfg = TCFG.parse_args(["--trainer.model_path", ckpt_copy, "--dataloader.batch_size", "2",
                                 "--dataloader.gravity_dataset.sim_length", "40",
                                 "--dataloader.cache_data", "false"])
    trainer = TT.create_trainer_from_args(args, cfg, device="cpu")
    ckpt = JCK.load_checkpoint(CKPT)
    adam = ckpt["opt_state"][0][0]  # optax's ScaleByAdamState under adamw's chain
    count = int(adam.count)
    assert trainer.step_count == ckpt["step_count"] == 30 and count == 30000
    want = weights.params_from_jax(ckpt["params"])
    assert all(torch.equal(v, want[k]) for k, v in trainer.model.state_dict().items())
    mu, nu = weights.params_from_jax(adam.mu), weights.params_from_jax(adam.nu)
    names = [n for n, _ in trainer.model.named_parameters()]
    exp_avg, exp_avg_sq = trainer.optim.moments()
    assert all(torch.equal(a, mu[n]) for a, n in zip(exp_avg, names))
    assert all(torch.equal(a, nu[n]) for a, n in zip(exp_avg_sq, names))
    assert trainer.optim.count == count
    jsched = JO.noam_schedule(args.learning_rate, 128, args.learning_rate_factor,
                              args.learning_rate_warmup_steps)
    assert float(trainer.optim.lr) == float(jsched(jnp.asarray(count, jnp.int32)))
    assert trainer.best_metrics == ckpt["best_metrics"]


def test_orbax_backend_is_refused(tmp_path):
    """The orbax backend now round-trips: the port's ``model.orbax`` of a
    JAX-initialised state loads back bitwise in the port and in the JAX
    package (with its live state as the template, the optax structure
    rebuilt), and the JAX package's own ``model.orbax`` of it loads in the
    port as the JAX package's untemplated load gives it.  A directory that
    holds no orbax checkpoint is still refused."""
    js = JScene(*(jnp.asarray(a) for a in _scene()))
    params = jmodels.create_model("egnn_mc", **SMALL).init(
        jax.random.PRNGKey(0), js, jgraph.knn_mask(js.pos, N - 1))
    state = JO.create_optimizer(0.5, 16, clip_value=1.0, discard_nan_gradients=True).init(params)
    host = jax.tree_util.tree_map(np.asarray, (params, state))
    jpath = JCK.save_checkpoint(str(tmp_path / "jax"), params, state, 5, backend="orbax")
    ported = TCK.optax_opt_state(TO.NoamAdamW(
        [torch.zeros(1)], learning_rate=0.5, model_size=16, clip_value=1.0,
        discard_nan_gradients=True),
        host[1].inner_state[1][0].mu, host[1].inner_state[1][0].nu)
    path = TCK.save_checkpoint(str(tmp_path / "port"), host[0], ported, 5, {"p": 0.25},
                               backend="orbax")
    assert path.endswith("model.orbax") and os.path.isdir(path)
    back = JCK.load_checkpoint(path, template={"params": params, "opt_state": state})
    assert jax.tree_util.tree_structure(back["opt_state"]) == jax.tree_util.tree_structure(state)
    for got, want in zip(jax.tree_util.tree_leaves((back["params"], back["opt_state"])),
                         jax.tree_util.tree_leaves(host)):
        assert np.asarray(got).dtype == want.dtype and np.array_equal(got, want)
    assert back["step_count"] == 5 and back["best_metrics"] == {"p": 0.25}
    want = JCK.load_checkpoint(jpath)  # untemplated: dicts, lists and None
    want = (want["params"], want["opt_state"])
    for got in (TCK.load_checkpoint(path), TCK.load_checkpoint(jpath)):
        got = (got["params"], got["opt_state"])
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    (tmp_path / "empty.orbax").mkdir()
    with pytest.raises(ValueError, match="_METADATA"):
        TCK.load_checkpoint(str(tmp_path / "empty.orbax"))


def test_opt_state_is_found_under_clipping_and_apply_if_finite(tmp_path):
    """``opt_state_from_jax`` finds optax's Adam state wherever the JAX
    package's chain puts it, in a pickle read without optax."""
    js = JScene(*(jnp.asarray(a) for a in _scene()))
    params = jmodels.create_model("egnn_mc", **SMALL).init(
        jax.random.PRNGKey(0), js, jgraph.knn_mask(js.pos, N - 1))
    keys = set(weights.params_from_jax(params))
    for kw in (dict(), dict(clip_value=1.0, clip_norm=1.0), dict(discard_nan_gradients=True)):
        state = JO.create_optimizer(0.5, 16, **kw).init(params)
        path = JCK.save_checkpoint(str(tmp_path), params, state, 0)
        count, mu, nu = weights.opt_state_from_jax(weights.read_checkpoint(path)["opt_state"])
        assert count == 0 and set(mu) == set(nu) == keys
        assert all(not v.any() for v in mu.values())
