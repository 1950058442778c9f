"""The port's trainer as a whole against the JAX package's ``Trainer``.

Both trainers are built from the same argv (a small EGNN-MC: 2 layers, width
16, N=5, B=4, float64) with the same frame seed, after both dataset classes
are made to return the same numpy trajectory batch, so that the batch each
trainer's constructor draws leaves the two frame orders aligned.  They start
from the same parameters (the JAX ones, cast to float64, carried across with
``params_from_jax``) and take three training steps (three epochs of one
step): each step's loss, recomputed in float64 on the batch it drew, agrees
within 1e-10 relative, and the parameters after the three steps within 1e-9
of each tensor's largest value.  Then ``run_self_feed_eval`` writes the same
set of artifact files in both run dirs (the figures included), and
each package's ``load_run`` reads the other's run dir.

Also here: the refusals of the trainer (a float64 run on the card without
the dense edge stage, on a stand-in for the card), and the CLI, imported and
run for a tiny training in a process where JAX cannot be imported.
"""

import importlib
import json
import os
import subprocess
import sys
import textwrap

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
jgraph = importlib.import_module(TPU + ".core.graph")
TOTF = importlib.import_module(PORT + ".data.gravity_otf")
TT = importlib.import_module(PORT + ".train.trainer")
TDL = importlib.import_module(PORT + ".data.dataloaders")
TCFG = importlib.import_module(PORT + ".utils.config")
TR = importlib.import_module(PORT + ".train.restore")
tgraph = importlib.import_module(PORT + ".core.graph")
tmodels = importlib.import_module(PORT + ".models")
physics = importlib.import_module(PORT + ".core.physics")
weights = importlib.import_module(PORT + ".weights")
_build = importlib.import_module(PORT + ".ops._build")
Scene = importlib.import_module(PORT + ".core.scene").Scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N, FRAMES = 4, 5, 20
ARGV = ["--model.num_layers", "2", "--model.hidden_node_dim", "16",
        "--model.hidden_edge_dim", "16", "--model.hidden_coord_dim", "16",
        "--dataloader.batch_size", str(B), "--dataloader.gravity_dataset.sim_length",
        str(FRAMES * 10), "--dataloader.seed", "5", "--dataloader.double_precision", "true",
        "--trainer.precision_mode", "double", "--trainer.steps_per_epoch", "1",
        "--trainer.self_feed_limit_steps", "12", "--trainer.learning_rate_warmup_steps", "4"]
LOSS_RTOL, PARAM_RTOL = 1e-10, 1e-9


def _batch():
    """One float64 GT batch from the plain integrator, as numpy arrays."""
    loc, vel, force, mass = physics.sample_trajectory_batch(
        B, N, T=FRAMES * 10, sample_freq=10, dtype=torch.float64, device="cpu",
        generator=torch.Generator().manual_seed(0))
    return {"loc": loc.numpy(), "vel": vel.numpy(), "force": force.numpy(), "mass": mass.numpy()}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The two trainers after three steps, with the batches they drew and the
    losses of each step."""
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("slice")
    traj = _batch()
    mp.setattr(JOTF.GravityDatasetOtf, "generate_trajectories",
               lambda self, bs: {k: jnp.asarray(v) for k, v in traj.items()})
    mp.setattr(TOTF.GravityDatasetOtf, "generate_trajectories",
               lambda self, bs: {k: torch.from_numpy(v.copy()) for k, v in traj.items()})
    try:
        for name in ("jax", "torch"):
            (root / name).mkdir()
        mp.chdir(root / "jax")
        jargs, jcfg = JCFG.parse_args(ARGV + ["--trainer.run_name", "jax"])
        jt = JT.create_trainer_from_args(jargs, resolved_config=jcfg)
        jt.params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64), jt.params)
        jt.opt_state = jt.tx.init(jt.params)

        mp.chdir(root / "torch")
        targs, tcfg = TCFG.parse_args(ARGV + ["--trainer.run_name", "torch"])
        model = tmodels.create_model("egnn_mc", device="cpu", dtype=torch.float64,
                                     **targs.model_kwargs)
        model.load_state_dict(weights.params_from_jax(jt.params))
        dataset = TDL.create_dataloader(targs, device="cpu").dataset
        tt = TT.Trainer(model, dataset, targs, resolved_config=tcfg, device="cpu")

        drawn = {"jax": [], "torch": []}
        for name, ds in (("jax", jt.dataset), ("torch", tt.dataset)):
            def recorded(get=ds.get_batch, out=drawn[name]):
                out.append(get())
                return out[-1]
            mp.setattr(ds, "get_batch", recorded)
        losses, logs = [], []
        for _ in range(3):
            # host copies: the JAX step donates its parameter buffers
            before = (jax.tree_util.tree_map(np.array, jt.params),
                      {k: v.clone() for k, v in tt.model.state_dict().items()})
            mp.chdir(root / "jax")
            jlog = jt.train_one_epoch()
            mp.chdir(root / "torch")
            tlog = tt.train_one_epoch()
            losses.append(_step_losses(jt, tt, before, drawn["jax"][-1], drawn["torch"][-1]))
            logs.append((jlog, tlog))
        for t in (jt, tt):
            t.step_count = 3
        mp.chdir(root / "jax")
        jsurv = jt.run_self_feed_eval()
        mp.chdir(root / "torch")
        tsurv = tt.run_self_feed_eval()
        yield dict(jt=jt, tt=tt, losses=losses, logs=logs, drawn=drawn, root=root,
                   survived=(jsurv, tsurv))
    finally:
        mp.undo()


def _step_losses(jt, tt, before, jbatch, tbatch):
    """The loss each step computed, recomputed in float64 from the parameters
    before it and the batch it drew."""
    jparams, tstate = before
    js, jy = jbatch
    jpred = jt.model.apply(jparams, js, jgraph.knn_mask(js.pos, N - 1))
    jloss = float(jt.loss_fn(jpred, js, jy)[0])
    model = tmodels.create_model("egnn_mc", device="cpu", dtype=torch.float64,
                                 **tt.args.model_kwargs)
    model.load_state_dict(tstate)
    ts, ty = tbatch
    with torch.no_grad():
        tpred = model(ts, tgraph.knn_mask(ts.pos, N - 1), edge_impl="dense")
    return jloss, float(tt.loss_fn(tpred, ts, ty)[0])


def test_three_steps_draw_the_same_batches(pair):
    for (js, jy), (ts, ty) in zip(pair["drawn"]["jax"], pair["drawn"]["torch"]):
        np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def test_three_steps_losses_agree(pair):
    for (jloss, tloss), (jlog, tlog) in zip(pair["losses"], pair["logs"]):
        assert abs(tloss - jloss) <= LOSS_RTOL * abs(jloss)
        # the logged metric vectors are float32, in both packages
        assert set(tlog) == set(jlog)
        for k in jlog:
            if "per_sec" not in k:
                assert tlog[k] == pytest.approx(jlog[k], rel=1e-6), k


def test_parameters_after_three_steps_agree(pair):
    want = weights.params_from_jax(pair["jt"].params)
    for name, p in pair["tt"].model.state_dict().items():
        w = want[name].numpy()
        assert np.abs(p.numpy() - w).max() <= PARAM_RTOL * np.abs(w).max(), name
    assert pair["tt"].optim.count == 3
    adam = pair["jt"].opt_state[0][0]
    assert int(adam.count) == 3


def _files(run_dir):
    out = set()
    for base, _, names in os.walk(run_dir):
        out |= {os.path.relpath(os.path.join(base, n), run_dir) for n in names}
    return out


def test_self_feed_eval_writes_the_same_artifacts(pair):
    root = pair["root"]
    jdir = root / "jax" / pair["jt"].save_dir_path
    tdir = root / "torch" / pair["tt"].save_dir_path
    ck = os.path.join("checkpoints", "3")
    jfiles, tfiles = _files(jdir / ck), _files(tdir / ck)
    assert tfiles == jfiles and "sticking_distributions.json" in tfiles
    assert _files(tdir) - {"metrics.jsonl"} >= {f for f in _files(jdir) if "restor" not in f} - {
        "metrics.jsonl"}
    jsurv, tsurv = pair["survived"]
    assert tsurv == jsurv
    with open(tdir / ck / "nbody_macro_metrics.json") as f:
        got = json.load(f)
    with open(jdir / ck / "nbody_macro_metrics.json") as f:
        want = json.load(f)
    assert set(got["ks_pvalues"]) == set(want["ks_pvalues"])
    np.testing.assert_allclose(got["energies"]["self_feed_total"],
                               want["energies"]["self_feed_total"], rtol=1e-8)


def test_each_package_loads_the_others_run(pair):
    root = pair["root"]
    tdir = str(root / "torch" / pair["tt"].save_dir_path)
    jdir = str(root / "jax" / pair["jt"].save_dir_path)
    ckpt = os.path.join("checkpoints", "3", "model.ckpt")  # the evaluated parameters
    jmodel, jparams, jds, jargs = JR.load_run(tdir, checkpoint=ckpt, seed=0)
    model, ds, args = TR.load_run(jdir, checkpoint=ckpt, seed=0, device="cpu")
    assert jds.get_serializable_attributes() == ds.get_serializable_attributes()
    assert vars(args)["model_kwargs"] == vars(jargs)["model_kwargs"]
    want = weights.params_from_jax(jparams)  # the port's final parameters, read by JAX
    for name, p in pair["tt"].model.state_dict().items():
        assert torch.equal(want[name].to(p.dtype), p)
    back = weights.params_from_jax(pair["jt"].params)
    for name, p in model.state_dict().items():
        assert torch.equal(p, back[name].to(p.dtype))


# --------------------------------------------------------------- refusals

class _NoBatch(Exception):
    pass


class _Dataset:
    """Stands in for a dataset: the trainer's first draw ends the test."""

    def get_batch(self):
        raise _NoBatch


@pytest.mark.parametrize("mode", ["bfloat16", "double", "autocast"])
def test_non_float32_on_the_card_needs_the_dense_edge_stage(mode, monkeypatch):
    """On a stand-in for the card (``wants_kernel`` true), a float64 run raises
    before it launches anything unless the model runs the dense edge stage (the
    edge kernels compute no float64).  A ``bfloat16`` or ``autocast`` run builds
    with the kernel edge stage: the kernels take a bf16 scene's geometry as
    float32.  float32 passes."""
    args, _ = TCFG.parse_args(["--trainer.precision_mode", mode])
    monkeypatch.setattr(_build, "wants_kernel", lambda t: True)
    kernel = tmodels.create_model("egnn_mc", device="cpu", num_layers=1)
    if mode == "double":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TT.Trainer(kernel, _Dataset(), args, device="cpu")
    else:
        with pytest.raises(_NoBatch):
            TT.Trainer(kernel, _Dataset(), args, device="cpu")
    dense = tmodels.create_model("egnn_mc", device="cpu", num_layers=1, edge_impl="dense")
    with pytest.raises(_NoBatch):
        TT.Trainer(dense, _Dataset(), args, device="cpu")
    args.precision_mode = "single"
    with pytest.raises(_NoBatch):
        TT.Trainer(kernel, _Dataset(), args, device="cpu")


class _OneBatch(_Dataset):
    """Stands in for a dataset: one float64 batch of a small scene, then the
    next draw ends the test."""

    def __init__(self):
        rng = np.random.default_rng(2)
        self.batch = (Scene(*(torch.from_numpy(rng.normal(size=(2, 5, 3))) for _ in range(3)),
                            torch.ones(2, 5, 1, dtype=torch.float64)), None)

    def get_batch(self):
        batch, self.batch = self.batch, None
        if batch is None:
            raise _NoBatch
        return batch

    def get_serializable_attributes(self):
        return {}


@pytest.mark.parametrize("argv,match", [
    # ported since (evaluation/layer_stats.py): the trainer builds and draws
    pytest.param(["--trainer.debug_layer_stats_every", "5"], None, id="argv0-layer_stats"),
    # ported since (models/ponita.py): the trainer builds, calibrates PONITA on
    # its first batch and draws the next
    pytest.param(["--main.model_type", "ponita", "--model.num_layers", "2",
                  "--model.hidden_features", "16", "--model.num_ori", "6",
                  "--model.basis_dim", "16", "--trainer.precision_mode", "double"],
                 "PONITA", id="argv1-PONITA"),
])
def test_unported_trainer_options_raise(argv, match, tmp_path, monkeypatch):
    args, _ = TCFG.parse_args(argv)
    if match is None:
        model = tmodels.create_model("egnn_mc", device="cpu", num_layers=1)
        with pytest.raises(_NoBatch):
            TT.Trainer(model, _Dataset(), args, device="cpu")
        return
    monkeypatch.chdir(tmp_path)  # the run dir lands there
    model = tmodels.create_model(args.model_type, device="cpu", **args.model_kwargs)
    before = model.blocks[0].conv.spatial.kernel.detach().clone()
    trainer = TT.Trainer(model, _OneBatch(), args, device="cpu")
    conv = model.blocks[0].conv
    assert float(conv.std_in) != 1.0 and not torch.equal(conv.spatial.kernel, before)
    assert trainer.n_params == sum(p.numel() for p in model.parameters()) + 3 * 2
    with pytest.raises(_NoBatch):
        trainer.train_one_epoch()


def test_training_step_launches_no_edge_kernel(monkeypatch):
    """The step chooses the dense edge stage: the kernel wrapper is never called
    with gradients on (its refusal, F2, would raise)."""
    EM = importlib.import_module(PORT + ".ops.egnn_messages")

    def refuse(*a, **k):
        raise AssertionError("the training step reached the edge kernel's wrapper")

    monkeypatch.setattr(EM, "fused_egnn_messages", refuse)
    args, _ = TCFG.parse_args(["--model.num_layers", "1"])
    model = tmodels.create_model("egnn_mc", device="cpu", num_layers=1)
    opt = TT.create_optimizer(model.parameters(), 0.5, 128)
    step, names = TT.make_train_step(model, opt, TT.build_loss_fn(args), ["pos_dt", "vel"], 4,
                                     torch.float32)
    rng = np.random.default_rng(0)
    scene = Scene(*(torch.from_numpy(rng.normal(size=(2, 5, 3))).float() for _ in range(3)),
                  torch.ones(2, 5, 1))
    vec = step(scene, torch.from_numpy(rng.normal(size=(2, 5, 6))).float())
    assert vec.shape == (len(names),) and torch.isfinite(vec).all() and opt.count == 1


_CHILD = textwrap.dedent(
    """
    import sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "chex", {tpu!r}):
                raise ImportError("blocked in this test: " + name)
            return None

    sys.meta_path.insert(0, Block())
    import {port}.cli as cli
    import {port}.train.trainer  # noqa: F401
    trainer = cli.train_main(sys.argv[1:])
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax"))
    print("LOADED", loaded, trainer.step_count)
    """
)


def test_cli_trains_on_the_cpu_without_jax(tmp_path):
    argv = ["--device", "cpu", "--model.num_layers", "1", "--model.hidden_node_dim", "8",
            "--dataloader.batch_size", "2", "--dataloader.gravity_dataset.sim_length", "100",
            "--trainer.train_steps", "1", "--trainer.steps_per_epoch", "3",
            "--trainer.test_macros_every", "1", "--trainer.self_feed_limit_steps", "5"]
    code = _CHILD.format(port=PORT, tpu=TPU)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code, *argv], capture_output=True, text=True,
                         cwd=tmp_path, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOADED [] 1" in res.stdout
    assert "Self feed: survived=" in res.stdout
    (run,) = (tmp_path / "runs" / "egnn_mc").iterdir()
    assert {"config.yaml", "model.ckpt", "metrics.jsonl", "training_args.json"} <= set(
        os.listdir(run))
