"""The ``orbax`` checkpoint backend between the port and the JAX package.

For each combination of the optimizer's flags that
``tests/test_torch_train_resume_jax.py`` covers (none; clipping by value; by
global norm; ``discard_nan_gradients``; all three), on a small EGNN-MC:

* the JAX package's ``save_checkpoint(..., backend="orbax")`` of a state
  with nonzero moments loads in the port with every leaf bitwise what the JAX
  package's ``load_checkpoint(path)`` gives with no template, in the same
  tree of dicts, lists and None and the same dtypes, and resumes the port's
  trainer as that state's pickle does;
* the port's trainer (float64, two steps, the second skipped under
  ``discard_nan_gradients``) writes ``model.orbax``, which the JAX package
  restores with its live state as the template (``load_checkpoint(path,
  template=...)``) bitwise its pickle of the same state, with the live optax
  structure, and which the JAX ``Trainer.load_model_from_checkpoint``
  resumes; the port resumed from it takes the next step bitwise as resumed
  from the pickle.  Under all three flags the JAX trainer takes that step
  too: within 1e-12 of each tensor's largest value.

Also: the committed fixture (``tests/torch_fixtures/orbax_egnn_mc/``, written
by :func:`write_fixture`) equals its ``model.ckpt``; a port ``cli train`` run
with ``checkpoint_backend: orbax`` writes ``model.orbax`` and
``checkpoints/<epoch>/model.orbax``, and ``load_run`` and ``cli self-feed`` /
``validate --checkpoint model.orbax`` read it; layouts that the JAX
package's save does not write are refused by name.

The fixture, regenerated (the JAX package's own save, orbax and tensorstore
installed):

    python tests/test_torch_orbax_ckpt.py fixture tests/torch_fixtures/orbax_egnn_mc

and a tensorstore-written copy of the committed N=100 checkpoint (about 10 MB
of trained float32 state), for the decode rate of ``ckpt_format.rate``:

    python tests/test_torch_orbax_ckpt.py n100 <dir>
"""

import importlib
import json
import os
import pickle
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # run as a script, to write the fixture
    sys.path.insert(0, REPO)
TPU = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu"
PORT = TPU + "_torch"
FIXTURE = os.path.join(REPO, "tests", "torch_fixtures", "orbax_egnn_mc")
N100 = os.path.join(REPO, "docs", "results", "fidelity_n100", "egnn_n100_ckpt_30_model.ckpt")
JCK = importlib.import_module(TPU + ".train.checkpoint")
JO = importlib.import_module(TPU + ".train.optim")
JT = importlib.import_module(TPU + ".train.trainer")
JCFG = importlib.import_module(TPU + ".utils.config")
JOTF = importlib.import_module(TPU + ".data.gravity_otf")
JScene = importlib.import_module(TPU + ".core.scene").Scene
TCK = importlib.import_module(PORT + ".train.checkpoint")
TT = importlib.import_module(PORT + ".train.trainer")
TDL = importlib.import_module(PORT + ".data.dataloaders")
TCFG = importlib.import_module(PORT + ".utils.config")
TOTF = importlib.import_module(PORT + ".data.gravity_otf")
tmodels = importlib.import_module(PORT + ".models")
weights = importlib.import_module(PORT + ".weights")
restore = importlib.import_module(PORT + ".train.restore")
cli = importlib.import_module(PORT + ".cli")
Scene = importlib.import_module(PORT + ".core.scene").Scene

B, N, FRAMES = 4, 5, 20
SMALL = ["--model.num_layers", "2", "--model.hidden_node_dim", "16",
         "--model.hidden_edge_dim", "16", "--model.hidden_coord_dim", "16"]
ARGV = SMALL + ["--dataloader.batch_size", str(B), "--dataloader.gravity_dataset.sim_length",
                str(FRAMES * 10), "--dataloader.seed", "5",
                "--dataloader.double_precision", "true", "--trainer.precision_mode", "double",
                "--trainer.learning_rate_warmup_steps", "4"]
FLAGS = {
    "plain": [],
    "clip_value": ["--trainer.clip_gradients_value", "0.05"],
    "clip_norm": ["--trainer.clip_gradients_norm", "0.1"],
    "discard": ["--trainer.discard_nan_gradients", "true"],
    "all": ["--trainer.clip_gradients_value", "0.05", "--trainer.clip_gradients_norm", "0.1",
            "--trainer.discard_nan_gradients", "true"],
}
RTOL = 1e-12


def _optimizer(args, params):
    return JO.create_optimizer(learning_rate=args.learning_rate, model_size=16,
                               factor=args.learning_rate_factor,
                               warmup=args.learning_rate_warmup_steps,
                               clip_value=args.clip_gradients_value,
                               clip_norm=args.clip_gradients_norm,
                               discard_nan_gradients=args.discard_nan_gradients)


def _jax_state(argv, dtype=np.float32, seed=0):
    """A JAX EGNN-MC's params and its optax state for ``argv``'s flags after
    two updates on random gradients (nonzero moments and counts)."""
    args, _ = JCFG.parse_args(argv + ["--trainer.run_name", "x"])
    model = tmodels.create_model("egnn_mc", device="cpu", **args.model_kwargs)
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, dtype),
                                    weights.params_to_jax(model.state_dict()))
    tx = _optimizer(args, params)
    state = tx.init(params)
    rng = np.random.default_rng(seed)
    for _ in range(2):
        grads = jax.tree_util.tree_map(lambda x: rng.normal(size=x.shape).astype(dtype), params)
        updates, state = tx.update(grads, state, params)
        params = jax.tree_util.tree_map(lambda p, u: np.asarray(p + u, dtype), params, updates)
    return params, jax.tree_util.tree_map(np.asarray, state)


def _assert_same_tree(got, want):
    """Equal tree structure (dicts, lists, None), every leaf bitwise with its
    dtype."""
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)


def _port_trainer(argv):
    targs, tcfg = TCFG.parse_args(argv + ["--trainer.run_name", "torch"])
    model = tmodels.create_model("egnn_mc", device="cpu", dtype=torch.float64,
                                 **targs.model_kwargs)
    return TT.Trainer(model, TDL.create_dataloader(targs, device="cpu").dataset, targs,
                      resolved_config=tcfg, device="cpu")


def _batches(nan=None):
    rng = np.random.default_rng(1)
    out = []
    for i in range(3):
        arrs = [rng.normal(size=(B, N, 3)), rng.normal(size=(B, N, 3)) * 0.3,
                rng.normal(size=(B, N, 3)), rng.uniform(0.5, 1.5, (B, N, 1)),
                rng.normal(size=(B, N, 6)) * 0.1]
        if i == nan:
            arrs[4][0, 0, 0] = np.nan
        out.append(arrs)
    return out


def _port_step(tt, arrs):
    tt._train_step(Scene(*(torch.from_numpy(a) for a in arrs[:4])), torch.from_numpy(arrs[4]))


def _port_state(tt):
    return ({k: v.clone() for k, v in tt.model.state_dict().items()}, tt.optim.count,
            [[t.clone() for t in ts] for ts in tt.optim.moments()], tt.optim.skip_counts()
            if tt.optim.discard_nan_gradients else None)


def _assert_port_equal(a, b):
    (pa, ca, ma, sa), (pb, cb, mb, sb) = a, b
    assert ca == cb and sa == sb
    assert all(torch.equal(v, pb[k]) for k, v in pa.items())
    assert all(torch.equal(x, y) for xs, ys in zip(ma, mb) for x, y in zip(xs, ys))


@pytest.fixture
def trajectories(monkeypatch):
    rng = np.random.default_rng(0)
    traj = {"loc": rng.normal(size=(B, FRAMES, N, 3)), "vel": rng.normal(size=(B, FRAMES, N, 3)),
            "force": rng.normal(size=(B, FRAMES, N, 3)),
            "mass": rng.uniform(0.5, 1.5, (B, N, 1))}
    monkeypatch.setattr(JOTF.GravityDatasetOtf, "generate_trajectories",
                        lambda self, bs: {k: jnp.asarray(v) for k, v in traj.items()})
    monkeypatch.setattr(TOTF.GravityDatasetOtf, "generate_trajectories",
                        lambda self, bs: {k: torch.from_numpy(v.copy()) for k, v in traj.items()})


@pytest.mark.parametrize("flags", list(FLAGS))
def test_jax_orbax_save_loads_in_the_port(flags, tmp_path, trajectories, monkeypatch):
    argv = ARGV + FLAGS[flags]
    params, state = _jax_state(argv)
    path = JCK.save_checkpoint(str(tmp_path), params, state, 3, {"p": 0.5}, backend="orbax")
    pkl = JCK.save_checkpoint(str(tmp_path), params, state, 3, {"p": 0.5})
    want = JCK.load_checkpoint(path)
    got = TCK.load_checkpoint(path)
    _assert_same_tree(got["params"], want["params"])
    _assert_same_tree(got["opt_state"], want["opt_state"])
    assert got["step_count"] == want["step_count"] == 3
    assert got["best_metrics"] == want["best_metrics"] == {"p": 0.5}
    monkeypatch.chdir(tmp_path)
    resumed = []
    for source in (path, pkl):
        tt = _port_trainer(argv)
        TT.load_training_state(tt.model, tt.optim, TCK.load_checkpoint(source), "egnn_mc")
        resumed.append(_port_state(tt))
    _assert_port_equal(*resumed)
    assert resumed[0][1] == 2


@pytest.mark.parametrize("flags", list(FLAGS))
def test_port_orbax_save_restores_in_jax(flags, tmp_path, trajectories, monkeypatch):
    argv = ARGV + FLAGS[flags] + ["--trainer.checkpoint_backend", "orbax"]
    discard = flags in ("discard", "all")
    batches = _batches(nan=1 if discard else None)
    (tmp_path / "torch").mkdir()
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "torch")
    tt = _port_trainer(argv)
    for arrs in batches[:2]:
        _port_step(tt, arrs)
    tt.step_count = 2
    path = os.path.abspath(tt.save_model())
    assert path.endswith("model.orbax") and os.path.isdir(path)
    tt.args.checkpoint_backend = "pickle"
    pkl = os.path.abspath(tt.save_model())

    jargs, jcfg = JCFG.parse_args(argv + ["--trainer.run_name", "jax"])
    with open(pkl, "rb") as f:  # the pickle, in optax's own classes
        want = pickle.load(f)
    live = jax.tree_util.tree_map(jnp.asarray, want["params"])
    template = {"params": live, "opt_state": _optimizer(jargs, live).init(live)}
    back = JCK.load_checkpoint(path, template=template)
    assert (jax.tree_util.tree_structure(back["opt_state"])
            == jax.tree_util.tree_structure(template["opt_state"])
            == jax.tree_util.tree_structure(want["opt_state"]))
    for got, ref in zip(jax.tree_util.tree_leaves((back["params"], back["opt_state"])),
                        jax.tree_util.tree_leaves((want["params"], want["opt_state"]))):
        assert np.asarray(got).dtype == np.asarray(ref).dtype and np.array_equal(got, ref)
    assert back["step_count"] == 2

    # the port resumed from either backend takes the same next step
    resumed = []
    for source in (path, pkl):
        fresh = _port_trainer(argv)
        fresh.load_model_from_checkpoint(source)
        _port_step(fresh, batches[2])
        resumed.append(_port_state(fresh))
    _assert_port_equal(*resumed)

    # the JAX trainer resumes it
    monkeypatch.chdir(tmp_path / "jax")
    jt = JT.create_trainer_from_args(jargs, resolved_config=jcfg)
    jt.params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64), jt.params)
    jt.opt_state = jt.tx.init(jt.params)
    jt.load_model_from_checkpoint(path)
    assert jt.step_count == 2
    for got, ref in zip(jax.tree_util.tree_leaves((jt.params, jt.opt_state)),
                        jax.tree_util.tree_leaves((want["params"], want["opt_state"]))):
        assert np.array_equal(np.asarray(got), ref)
    if flags != "all":
        return
    js = JScene(*(jnp.asarray(a) for a in batches[2][:4]))
    jt.params, jt.opt_state, jt._rng, _ = jt._train_step(jt.params, jt.opt_state, js,
                                                         jnp.asarray(batches[2][4]), jt._rng)
    ref = weights.params_from_jax(jt.params)
    for name, p in resumed[0][0].items():
        w = ref[name].numpy()
        assert np.abs(p.numpy() - w).max() <= RTOL * np.abs(w).max(), name


def _canonical(node):
    """A pickled state tree in the shape of an untemplated orbax load: optax's
    states as dicts of their fields, tuples as lists, empty states as None."""
    fields = getattr(type(node), "_fields", None)
    if isinstance(node, tuple) and fields is not None:
        return {f: _canonical(v) for f, v in zip(fields, node)} if fields else None
    if isinstance(node, dict):
        return {k: _canonical(v) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return [_canonical(v) for v in node]
    return node


def test_committed_fixture_equals_its_pickle():
    orbax_dir = os.path.join(FIXTURE, "model.orbax")
    got = TCK.load_checkpoint(orbax_dir)
    want = JCK.load_checkpoint(orbax_dir)
    with open(os.path.join(FIXTURE, "model.ckpt"), "rb") as f:
        pkl = pickle.load(f)
    for tree in (want, {k: _canonical(v) for k, v in pkl.items()}):
        _assert_same_tree(got["params"], tree["params"])
        _assert_same_tree(got["opt_state"], tree["opt_state"])
        assert got["step_count"] == tree["step_count"]
    # the files are tensorstore's: zstd-compressed nodes, values in ocdbt.process_0
    assert os.path.isdir(os.path.join(orbax_dir, "ocdbt.process_0", "d"))
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(FIXTURE) for f in fs)
    assert size < 200_000


def test_load_run_and_the_mains_read_an_orbax_run_dir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trainer = cli.train_main(["--device", "cpu", "--trainer.checkpoint_backend", "orbax",
                              "--trainer.save_checkpoint_params", "true",
                              "--trainer.train_steps", "1", "--trainer.steps_per_epoch", "2",
                              "--trainer.test_macros_every", "1",
                              "--trainer.self_feed_limit_steps", "6",
                              "--dataloader.batch_size", "4",
                              "--dataloader.gravity_dataset.sim_length", "100"] + SMALL)
    run = trainer.save_dir_path
    assert os.path.isdir(os.path.join(run, "model.orbax"))
    assert not os.path.exists(os.path.join(run, "model.ckpt"))
    epoch_dir = os.path.join(run, "checkpoints", str(trainer.step_count), "model.orbax")
    assert os.path.isfile(os.path.join(epoch_dir, "_METADATA"))
    model, _, _ = restore.load_run(run, checkpoint="model.orbax", device="cpu")
    live = trainer.model.state_dict()
    assert all(torch.equal(v, live[k]) for k, v in model.state_dict().items())
    payload = TCK.load_checkpoint(os.path.join(run, "model.orbax"))
    assert payload["step_count"] == trainer.step_count
    cli.self_feed_main(["--device", "cpu", "--run_dir", run, "--checkpoint", "model.orbax",
                        "--steps", "5"])
    assert os.path.exists(os.path.join(run, "generated_trajectories", "self_feed_draws.json"))
    cli.validate_main(["--device", "cpu", "--run_dir", run, "--checkpoint", "model.orbax",
                       "--batches", "1"])


def _meta(path):
    with open(os.path.join(path, "_METADATA")) as f:
        return json.load(f)


@pytest.mark.parametrize("layout, match", [("use_zarr3", "use_zarr3: true"),
                                           ("use_ocdbt", "use_ocdbt: False"),
                                           ("aggregate", "aggregate msgpack")])
def test_layouts_the_jax_save_does_not_write_are_refused(layout, match, tmp_path):
    params = {"params": {"k": np.ones((2, 2), np.float32)}}
    path = TCK.save_checkpoint(str(tmp_path), params, (), 0, backend="orbax")
    meta = _meta(path)
    if layout == "aggregate":
        open(os.path.join(path, "checkpoint"), "wb").write(b"\x81\xa6params\x80")
    else:
        meta[layout] = layout == "use_zarr3"
        with open(os.path.join(path, "_METADATA"), "w") as f:
            json.dump(meta, f)
    with pytest.raises(ValueError, match=match):
        TCK.load_checkpoint(path)


def write_fixture(dest: str) -> None:
    """The committed fixture: a JAX EGNN-MC at depth 2 and width 16 (float32,
    all three optimizer flags, two updates so the moments are nonzero),
    written by the JAX package's ``save_checkpoint`` as ``model.orbax``
    (orbax and tensorstore) and as ``model.ckpt`` (pickle)."""
    params, state = _jax_state(SMALL + FLAGS["all"], seed=11)
    for backend in ("orbax", "pickle"):
        JCK.save_checkpoint(dest, params, state, 2, {"macro_combined_p": 0.25}, backend=backend)


def write_n100(dest: str) -> None:
    """The committed N=100 checkpoint (6 x 128, AdamW's trained moments)
    rewritten by the JAX package's orbax backend."""
    payload = JCK.load_checkpoint(N100)
    JCK.save_checkpoint(dest, payload["params"], payload["opt_state"], payload["step_count"],
                        payload["best_metrics"], backend="orbax")


if __name__ == "__main__":
    {"fixture": write_fixture, "n100": write_n100}[sys.argv[1]](os.path.abspath(sys.argv[2]))
