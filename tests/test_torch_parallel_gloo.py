"""The port's multi-GPU paths on gloo ranks on the CPU, against the JAX
package's on conftest's virtual CPU mesh.

Two spawns of ranks (``parallel.launch.spawn_ranks``), each run once for the
module; the parametrised tests below assert on what they return:

* four ranks: the ring force (``body`` = 4) against
  ``make_ring_acceleration``; the body-ring rollout of a small EGNN-MC over
  ``(sim, body)`` = (1, 4) and (2, 2) against ``make_body_ring_rollout_fn``
  at ``make_mesh(4, body_parallel=4|2)``, with an ``explosion_threshold``
  that freezes one sim mid-run, in float64 and in ``compute_dtype=
  "bfloat16"``; ``sharded_datagen``'s rows against the single-process batch,
  bitwise; the sharded evaluation rollout (``make_sharded_rollout_fn``, and
  ``run_self_feed(..., mesh=...)`` on a sharded dataset) gathered, against
  the single-process one; the body-sharded training step
  (``make_sharded_train_step(..., shard_bodies=True)``) of a small EGNN-MC at
  N=8 over (1, 4) and (2, 2), three steps each on a fully connected mask
  with the centre-of-mass, energy and momentum losses on and on a kNN mask
  below it, against the JAX package's body-sharded step on the virtual CPU
  mesh and its unsharded step (with the first step's averaged gradients
  against the port's single-process gradient of the whole batch's loss),
  the ops' shapes of one kNN step (no ``[*, N, N, *]`` tensor on any rank), PaiNN's
  gathered step against the port's single-process one, and the gradient of
  ``EGNNMC(body_ring=True)`` summed over the ranks against the dense model's;
* two ranks: three data-parallel steps of the port's ``Trainer`` (each rank
  its half of every batch) against the JAX package's ``Trainer`` on the whole
  batch, built as ``tests/test_torch_train_slice.py`` builds it, then its
  self-feed evaluation.

Tolerances, each with its reason:
* the ring force, float64: 1e-12 of the largest value (the same sums, in
  the same ring order);
* the float64 ring rollouts: 1e-10 of the largest value over 8 frames (the
  JAX ring's float32 parts are read as float64 for the reference, as in
  ``test_torch_parallel.py``; 1e-12 a step, grown by the closed loop);
* the bf16 ring rollouts: 1e-2 of the largest displacement from frame 0 and
  of the largest velocity (``tests/test_torch_bf16.py``'s ``MODEL_RTOL``:
  the two frameworks round bf16 at other points);
* the data-parallel steps: ``LOSS_RTOL`` and ``PARAM_RTOL`` of
  ``tests/test_torch_train_slice.py`` (the gradient of each half's mean,
  averaged, is the whole batch's up to the order of the sums); the ranks'
  parameters bitwise equal after every step;
* the sharded evaluation rollout against the single-process one, float64:
  1e-12 (the same arithmetic on fewer sims), survived equal;
* the body-sharded steps: each step's float64 loss within ``LOSS_RTOL`` and
  the parameters after three steps within ``PARAM_RTOL`` of the JAX steps'
  (the data-parallel steps' tolerances: the same float64 sums in another
  order); the first step's gradients within ``GRAD_RTOL`` of each tensor's
  largest value (the same), which AdamW's normalised update would hide if
  a reduction scaled them; the ranks' parameters bitwise equal; PaiNN's
  gathered steps within the same tolerances of the single-process ones;
* the ring's gradient summed over the ranks against the dense model's,
  float64: ``RING_GRAD_RTOL`` = 1e-12 of each tensor's largest value (the
  same sums, in the ring's order).
"""

import importlib
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

TPU = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu"
PORT = TPU + "_torch"
launch = importlib.import_module(PORT + ".parallel.launch")
Scene = importlib.import_module(PORT + ".core.scene").Scene

B, N, T = 4, 16, 8
SMALL = dict(num_layers=2, hidden_node_dim=16, hidden_edge_dim=16, hidden_coord_dim=16)
MESHES = {"1x4": 4, "2x2": 2}  # (sim, body) -> body_parallel
FORCE_RTOL, RING_RTOL, BF16_RTOL, EVAL_RTOL = 1e-12, 1e-10, 1e-2, 1e-12
DATAGEN = dict(batch_size=4, n_bodies=5, T=200, sample_freq=10)
DATAGEN_RTOL = 1e-14  # a few float64 ulps over 20 frames
RANK_TIMEOUT = 240.0
# the data-parallel trainer: test_torch_train_slice.py's argv and tolerances
TB, TN, FRAMES = 4, 5, 20
ARGV = ["--model.num_layers", "2", "--model.hidden_node_dim", "16",
        "--model.hidden_edge_dim", "16", "--model.hidden_coord_dim", "16",
        "--dataloader.batch_size", str(TB), "--dataloader.gravity_dataset.sim_length",
        str(FRAMES * 10), "--dataloader.seed", "5", "--dataloader.double_precision", "true",
        "--trainer.precision_mode", "double", "--trainer.steps_per_epoch", "1",
        "--trainer.self_feed_limit_steps", "12", "--trainer.learning_rate_warmup_steps", "4"]
LOSS_RTOL, PARAM_RTOL = 1e-10, 1e-9
STEPS = 3
# the body-sharded steps: B=4 sims of N=8 at SMALL width, float64; case ->
# (num_neighbors, the com / energy / momentum losses on)
SB, SN = 4, 8
STEP_CASES = {"fc": (SN - 1, True), "knn": (3, False)}
OPT = dict(learning_rate=0.5, model_size=16, warmup=4)
GRAD_RTOL, RING_GRAD_RTOL = 1e-10, 1e-12
PAINN = dict(hidden_features=8, num_layers=2, num_rbf=6)


def _scene_arrays(seed=0):
    """A float64 scene whose sim 0 sits far out, so that a threshold on |pos|
    can freeze it alone."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(B, N, 3))
    pos[0] += 40.0
    vel = rng.normal(size=(B, N, 3)) * 0.3
    mass = rng.uniform(0.5, 1.5, size=(B, N, 1))
    return pos, vel, np.zeros((B, N, 3)), mass


def _tscene(arrays, dtype=torch.float64):
    return Scene(*(torch.from_numpy(a).to(dtype) for a in arrays))


def _step_arrays(seed=11):
    """The body-sharded steps' float64 ``(pos, vel, force, mass, y)``."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(SB, SN, 3)), rng.normal(size=(SB, SN, 3)) * 0.3,
            rng.normal(size=(SB, SN, 3)), rng.uniform(0.5, 1.5, size=(SB, SN, 1)),
            rng.normal(size=(SB, SN, 6)) * 0.1)


def _loss_args(phys: bool):
    from types import SimpleNamespace

    return SimpleNamespace(target="pos_dt+vel", com_loss=phys, energy_loss=phys,
                           momentum_loss=phys)


class _Shapes(TorchDispatchMode):
    """Records the shape of every op's tensor output."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.seen.add(tuple(t.shape))
        return out


def _body_sharded_steps(mesh, name, state, painn_state):
    """Three body-sharded steps of each case (and of PaiNN at (2, 2)): each
    step's float64 loss, the first step's averaged gradients, the parameters
    after; the shapes of one rows-form step at (1, 4); the ring's gradient of
    ``sum(pred * w)`` on this rank's block."""
    par = importlib.import_module(PORT + ".parallel")
    pmesh = importlib.import_module(PORT + ".parallel.mesh")
    models = importlib.import_module(PORT + ".models")
    losses = importlib.import_module(PORT + ".train.losses")
    optim = importlib.import_module(PORT + ".train.optim")
    pos, vel, force, mass, y = (torch.from_numpy(a) for a in _step_arrays())
    rows = [pmesh.local_rows(t, mesh, shard_bodies=True) for t in (pos, vel, force, mass, y)]
    scene, y_rows = Scene(*rows[:4]), rows[4]
    out = {}
    runs = [(case, "egnn_mc", state, {}) for case in STEP_CASES]
    if name == "2x2":
        runs.append(("painn", "painn", painn_state, PAINN))
    for case, family, st, kw in runs:
        k, phys = STEP_CASES.get(case, (SN - 1, False))
        model = models.create_model(family, device="cpu", dtype=torch.float64,
                                    **(kw or SMALL))
        model.load_state_dict({n: torch.from_numpy(v) for n, v in st.items()})
        opt = optim.create_optimizer(model.parameters(), **OPT)
        base, seen = losses.build_loss_fn(_loss_args(phys)), []

        def loss_fn(pred, s, yy, base=base, seen=seen):
            total, terms = base(pred, s, yy)
            seen.append(float(total.detach()))
            return total, terms

        step, _ = par.make_sharded_train_step(model, opt, loss_fn, ["pos_dt", "vel"], k, mesh,
                                              torch.float64, shard_bodies=True)
        rec = {"losses": seen}
        for i in range(STEPS):
            if case == "knn" and name == "1x4" and i == 0:
                with _Shapes() as mode:
                    step(scene, y_rows)
                out["shapes"] = sorted(mode.seen)
            else:
                step(scene, y_rows)
            if i == 0:
                rec["grads"] = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
        rec["params"] = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
        out[f"step_{case}_{name}"] = rec
    ring = models.create_model("egnn_mc", device="cpu", dtype=torch.float64, body_ring=True,
                               **SMALL)
    ring.load_state_dict({n: torch.from_numpy(v) for n, v in state.items()})
    w = pmesh.local_rows(torch.from_numpy(np.random.default_rng(12).normal(size=(SB, SN, 6))),
                         mesh, shard_bodies=True)
    (ring(scene, None, ring=pmesh.axis_group(mesh, "body")) * w).sum().backward()
    out[f"ring_grad_{name}"] = {n: p.grad.numpy().copy() for n, p in ring.named_parameters()}
    return out


# ------------------------------------------------------------ the ranks' work

def _ring_ranks(rank, arrays, state, threshold, painn_state):
    """Four ranks: the ring force, the ring rollouts, the body-sharded steps
    and the ring's gradient, sharded datagen and the sharded evaluation
    rollout; this rank's blocks and coordinates."""
    par = importlib.import_module(PORT + ".parallel")
    pmesh = importlib.import_module(PORT + ".parallel.mesh")
    models = importlib.import_module(PORT + ".models")
    physics = importlib.import_module(PORT + ".core.physics")
    otf = importlib.import_module(PORT + ".data.gravity_otf")
    self_feed = importlib.import_module(PORT + ".rollout.self_feed")
    out = {}
    scene = _tscene(arrays)
    for name, bp in MESHES.items():
        mesh = par.make_mesh(4, body_parallel=bp)
        out[f"coord_{name}"] = (mesh.get_local_rank("sim"), mesh.get_local_rank("body"))
        if name == "1x4":
            local = par.shard_scene(scene, mesh, shard_bodies=True)
            out["force"] = par.make_ring_acceleration(mesh, physics.GravityParams())(
                local.pos, local.mass).numpy()
        for dt, kw in (("f64", {}), ("bf16", dict(compute_dtype="bfloat16"))):
            dtype = torch.float64 if dt == "f64" else torch.float32
            model = models.create_model("egnn_mc", device="cpu", dtype=dtype, body_ring=True,
                                        **kw, **SMALL)
            model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
            s = scene if dt == "f64" else scene.astype(torch.float32)
            fn = par.make_body_ring_rollout_fn(model, T, mesh, explosion_threshold=threshold)
            out[f"ring_{dt}_{name}"] = tuple(t.numpy() for t in fn(s))
        out.update(_body_sharded_steps(mesh, name, state, painn_state))
    mesh = par.make_mesh(4)  # (4, 1): the sims over the ranks
    out["sim_rank"] = mesh.get_local_rank("sim")
    for noise in (0.0, 0.01):
        params = physics.GravityParams(noise_var=noise)
        out[f"datagen_{noise}"] = tuple(t.numpy() for t in par.sharded_datagen(
            torch.Generator().manual_seed(7), mesh, params=params, dtype=torch.float64,
            device="cpu", **DATAGEN))
    dense = models.create_model("egnn_mc", device="cpu", dtype=torch.float64, **SMALL)
    dense.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    out["sharded_rollout"] = tuple(t.numpy() for t in par.make_sharded_rollout_fn(
        dense, T, mesh)(scene))
    ds = otf.GravityDatasetOtf(batch_size=B, sim_length=60, num_nodes=N, double_precision=True,
                               seed=rank, device="cpu")  # the first rank's stream, once sharded
    ds.shard(mesh)
    res = self_feed.run_self_feed(dense, ds, num_steps=5, mesh=mesh)
    out["run_self_feed"] = tuple(t.numpy() for t in res[:4]) + (res[4],)
    out["sim_group_size"] = pmesh.axis_size(mesh, "sim")
    return out


def _dp_ranks(rank, root, state, argv):
    """Two ranks: the data-parallel trainer's three steps and its evaluation,
    each rank in its own working directory."""
    tcfg = importlib.import_module(PORT + ".utils.config")
    tdl = importlib.import_module(PORT + ".data.dataloaders")
    tt_mod = importlib.import_module(PORT + ".train.trainer")
    models = importlib.import_module(PORT + ".models")
    cwd = os.path.join(root, f"rank{rank}")
    os.makedirs(cwd)
    os.chdir(cwd)
    args, cfg = tcfg.parse_args(argv + ["--trainer.run_name", "torch"])
    model = models.create_model("egnn_mc", device="cpu", dtype=torch.float64, **args.model_kwargs)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    dataset = tdl.create_dataloader(args, device="cpu").dataset
    trainer = tt_mod.Trainer(model, dataset, args, resolved_config=cfg, device="cpu")
    drawn, before, after, logs = [], [], [], []

    def recorded(get=dataset.get_batch):
        b = get()
        drawn.append((b[0].pos.numpy().copy(), b[1].numpy().copy()))
        return b

    dataset.get_batch = recorded
    for _ in range(STEPS):
        before.append({k: v.numpy().copy() for k, v in model.state_dict().items()})
        logs.append(trainer.train_one_epoch())
        after.append({k: v.numpy().copy() for k, v in model.state_dict().items()})
    trainer.step_count = STEPS
    survived = trainer.run_self_feed_eval()
    files = sorted(os.path.relpath(os.path.join(b, n), cwd)
                   for b, _, ns in os.walk(cwd) for n in ns)
    return dict(drawn=drawn, before=before, after=after, logs=logs, survived=survived,
                files=files, save_dir=trainer.save_dir_path, mesh=trainer.mesh is not None,
                count=trainer.optim.count)


# --------------------------------------------------------------- references

def _jax():
    import jax
    import jax.numpy as jnp

    return jax, jnp


def _jax_params():
    jax, jnp = _jax()
    jmodels = importlib.import_module(TPU + ".models")
    jgraph = importlib.import_module(TPU + ".core.graph")
    JScene = importlib.import_module(TPU + ".core.scene").Scene
    js = JScene(*(jnp.asarray(a) for a in _scene_arrays()))
    params = jmodels.create_model("egnn_mc", **SMALL).init(
        jax.random.PRNGKey(2), js, jgraph.knn_mask(js.pos, N - 1))
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)


def _threshold(dense):
    """A |pos| threshold that sim 0 of the dense float64 rollout first passes
    halfway through, and no other sim passes."""
    sf = importlib.import_module(PORT + ".rollout.self_feed")
    loc, _, _ = sf.make_rollout_fn(dense, T, explosion_threshold=1e300)(_tscene(_scene_arrays()))
    m = loc.abs().amax(dim=(2, 3)).numpy()  # [B, T]
    k = T // 2
    prefix = m[0, 1:k].max()
    later = [v for v in m[0, k:] if v > prefix]
    assert later and m[1:].max() < prefix, "the scene does not give a mid-run freeze"
    return float((prefix + min(later)) / 2.0)


@pytest.fixture(scope="module")
def ring_run():
    models = importlib.import_module(PORT + ".models")
    weights = importlib.import_module(PORT + ".weights")
    jparams = _jax_params()
    state = {k: v.numpy() for k, v in weights.params_from_jax(jparams).items()}
    dense = models.create_model("egnn_mc", device="cpu", dtype=torch.float64, **SMALL)
    dense.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    threshold = _threshold(dense)
    torch.manual_seed(13)
    painn = models.create_model("painn", device="cpu", dtype=torch.float64, **PAINN)
    painn_state = {k: v.numpy() for k, v in painn.state_dict().items()}
    with ThreadPoolExecutor(1) as pool:  # the ranks run while the JAX references compile
        job = pool.submit(launch.spawn_ranks, _ring_ranks, 4,
                          (_scene_arrays(), state, threshold, painn_state),
                          timeout=RANK_TIMEOUT)
        jax_force = _jax_ring_force()
        jax_rollouts = _jax_ring_rollouts(jparams, threshold)
        jax_steps = _jax_body_sharded_steps(jparams)
        ranks = job.result()
    return dict(ranks=ranks, jparams=jparams, dense=dense, threshold=threshold, state=state,
                jax_force=jax_force, jax_rollouts=jax_rollouts, jax_steps=jax_steps,
                painn_state=painn_state)


def _assemble(ranks, key, name, index, sims, bodies_axis):
    """The whole array from the ranks' blocks at their mesh coordinates."""
    bp = MESHES[name]
    S = 4 // bp
    parts = {}
    for r in ranks:
        s, b = r[f"coord_{name}"]
        parts[(s, b)] = r[key][index]
    rows = [np.concatenate([parts[(s, b)] for b in range(bp)], axis=bodies_axis)
            for s in range(S)]
    return np.concatenate(rows, axis=0)


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale, (err, scale)


def _jax_ring_force():
    jax, jnp = _jax()
    jmesh = importlib.import_module(TPU + ".parallel.mesh")
    jring = importlib.import_module(TPU + ".parallel.ring")
    jphys = importlib.import_module(TPU + ".core.physics")
    pos, _, _, mass = _scene_arrays()
    return np.asarray(jring.make_ring_acceleration(jmesh.make_mesh(4, body_parallel=4),
                                                   jphys.GravityParams())(jnp.asarray(pos),
                                                                          jnp.asarray(mass)))


def test_ring_force_matches_jax(ring_run):
    want = ring_run["jax_force"]
    parts = sorted((r["coord_1x4"][1], r["force"]) for r in ring_run["ranks"])
    got = np.concatenate([p for _, p in parts], axis=1)
    _close(got, want, FORCE_RTOL)


class WideJnp:
    """``jax.numpy`` with ``float32`` read as ``float64`` (see the module note)."""

    def __init__(self, jnp):
        self._jnp = jnp
        self.float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(self._jnp, name)


def _jax_ring_rollouts(jparams, threshold):
    jax, jnp = _jax()
    jmesh = importlib.import_module(TPU + ".parallel.mesh")
    jsharded = importlib.import_module(TPU + ".parallel.sharded")
    jre = importlib.import_module(TPU + ".parallel.ring_egnn")
    jmodels = importlib.import_module(TPU + ".models")
    JScene = importlib.import_module(TPU + ".core.scene").Scene
    arrays = _scene_arrays()
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for dt in ("f64", "bf16"):
            if dt == "f64":
                mp.setattr(jre, "jnp", WideJnp(jnp))
                js = JScene(*(jnp.asarray(a) for a in arrays))
                params, kw = jparams, {}
            else:
                mp.undo()
                js = JScene(*(jnp.asarray(a, jnp.float32) for a in arrays))
                params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), jparams)
                kw = dict(compute_dtype="bfloat16")
            model = jmodels.create_model("egnn_mc", body_ring=True, **kw, **SMALL)
            for name, bp in MESHES.items():
                fn = jsharded.make_body_ring_rollout_fn(
                    model, T, jmesh.make_mesh(4, body_parallel=bp),
                    explosion_threshold=threshold)
                out[(dt, name)] = tuple(np.asarray(t) for t in fn(params, js))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("name", list(MESHES))
def test_ring_rollout_matches_jax_f64(ring_run, name):
    jloc, jvel, jsurv = ring_run["jax_rollouts"][("f64", name)]
    loc = _assemble(ring_run["ranks"], f"ring_f64_{name}", name, 0, B, 2)
    vel = _assemble(ring_run["ranks"], f"ring_f64_{name}", name, 1, B, 2)
    surv = np.concatenate([r[f"ring_f64_{name}"][2] for r in sorted(
        ring_run["ranks"], key=lambda r: r[f"coord_{name}"]) if r[f"coord_{name}"][1] == 0])
    _close(loc, jloc, RING_RTOL)
    _close(vel, jvel, RING_RTOL)
    np.testing.assert_array_equal(surv, jsurv)
    assert 0 < surv[0] < T - 1 and (surv[1:] == T - 1).all()  # sim 0 froze mid-run
    for r in ring_run["ranks"]:  # each body shard of a sim holds the same count
        s = r[f"coord_{name}"][0]
        S = 4 // MESHES[name]
        np.testing.assert_array_equal(r[f"ring_f64_{name}"][2], jsurv[s * B // S:(s + 1) * B // S])


@pytest.mark.parametrize("name", list(MESHES))
def test_ring_rollout_matches_jax_bf16(ring_run, name):
    jloc, jvel, jsurv = ring_run["jax_rollouts"][("bf16", name)]
    loc = _assemble(ring_run["ranks"], f"ring_bf16_{name}", name, 0, B, 2)
    vel = _assemble(ring_run["ranks"], f"ring_bf16_{name}", name, 1, B, 2)
    assert loc.dtype == np.float32
    _close(loc - loc[:, :1], jloc - jloc[:, :1], BF16_RTOL)
    _close(vel, jvel, BF16_RTOL)
    surv = np.concatenate([r[f"ring_bf16_{name}"][2] for r in sorted(
        ring_run["ranks"], key=lambda r: r[f"coord_{name}"]) if r[f"coord_{name}"][1] == 0])
    np.testing.assert_array_equal(surv, jsurv)


@pytest.mark.parametrize("noise", [0.0, 0.01])
def test_sharded_datagen_rows_are_the_single_process_rows(ring_run, noise):
    """The initial states, masses and observation noise are the whole batch's
    rows bitwise; the integrated frames within DATAGEN_RTOL, since the CPU's
    plain integrator sums in an order that depends on the batch's shape (on
    the card K2-leapfrog sums each sim alike at any batch size, which
    ``chip_smoke.py`` ``[dp-train]`` holds bitwise)."""
    physics = importlib.import_module(PORT + ".core.physics")
    want = physics.sample_trajectory_batch(
        DATAGEN["batch_size"], DATAGEN["n_bodies"], T=DATAGEN["T"],
        sample_freq=DATAGEN["sample_freq"], params=physics.GravityParams(noise_var=noise),
        dtype=torch.float64, device="cpu", generator=torch.Generator().manual_seed(7))
    for r in ring_run["ranks"]:
        s = r["sim_rank"]
        got = r[f"datagen_{noise}"]
        np.testing.assert_array_equal(got[3], want[3][s:s + 1].numpy())
        for g, w in zip(got[:3], want[:3]):
            w = w[s:s + 1].numpy()
            if not noise:
                np.testing.assert_array_equal(g[:, 0], w[:, 0])
            _close(g, w, DATAGEN_RTOL)


def test_sharded_rollout_gathered_equals_single_process(ring_run):
    sf = importlib.import_module(PORT + ".rollout.self_feed")
    want = sf.make_rollout_fn(ring_run["dense"], T)(_tscene(_scene_arrays()))
    for r in ring_run["ranks"]:
        loc, vel, surv = r["sharded_rollout"]
        _close(loc, want[0].numpy(), EVAL_RTOL)
        _close(vel, want[1].numpy(), EVAL_RTOL)
        np.testing.assert_array_equal(surv, want[2].numpy())


def test_run_self_feed_on_a_sharded_dataset(ring_run):
    """Every rank's GT is the first rank's stream, gathered whole; the rollout
    of its sims, gathered, is the single-process one."""
    otf = importlib.import_module(PORT + ".data.gravity_otf")
    sf = importlib.import_module(PORT + ".rollout.self_feed")
    ds = otf.GravityDatasetOtf(batch_size=B, sim_length=60, num_nodes=N, double_precision=True,
                               seed=0, device="cpu")
    want = sf.run_self_feed(ring_run["dense"], ds, num_steps=5)
    assert ring_run["ranks"][0]["sim_group_size"] == 4
    for r in ring_run["ranks"]:
        got = r["run_self_feed"]
        np.testing.assert_array_equal(got[0], want[0].numpy())  # the GT, bitwise
        np.testing.assert_array_equal(got[1], want[1].numpy())
        _close(got[2], want[2].numpy(), EVAL_RTOL)
        _close(got[3], want[3].numpy(), EVAL_RTOL)
        assert got[4] == want[4]


# ------------------------------------------------------ body-sharded steps

def _jax_body_sharded_steps(jparams):
    """The JAX package's ``make_sharded_train_step(..., shard_bodies=True)``
    at each mesh and case, and its unsharded step (a one-device mesh): each
    step's loss and the parameters after."""
    jax, jnp = _jax()
    jmesh = importlib.import_module(TPU + ".parallel.mesh")
    jsharded = importlib.import_module(TPU + ".parallel.sharded")
    jmodels = importlib.import_module(TPU + ".models")
    jlosses = importlib.import_module(TPU + ".train.losses")
    joptim = importlib.import_module(TPU + ".train.optim")
    JScene = importlib.import_module(TPU + ".core.scene").Scene
    arrs = _step_arrays()
    js, jy = JScene(*(jnp.asarray(a) for a in arrs[:4])), jnp.asarray(arrs[4])
    model = jmodels.create_model("egnn_mc", **SMALL)
    tx = joptim.create_optimizer(**OPT)
    meshes = {name: jmesh.make_mesh(4, body_parallel=bp) for name, bp in MESHES.items()}
    meshes["single"] = jmesh.make_mesh(1)
    out = {}
    for case, (k, phys) in STEP_CASES.items():
        loss_fn = jlosses.build_loss_fn(_loss_args(phys))
        for name, mesh in meshes.items():
            bodies = name != "single"
            step = jsharded.make_sharded_train_step(model, tx, loss_fn, k, mesh,
                                                    shard_bodies=bodies)
            scene = jsharded.shard_scene(js, mesh, shard_bodies=bodies)
            y = jax.device_put(jy, scene.pos.sharding)
            # placed as the step's outputs are, so that its first call's
            # compile serves the later ones
            params = jax.device_put(jparams, jmesh.replicate(mesh))
            opt_state, seen = jax.device_put(tx.init(params), jmesh.replicate(mesh)), []
            for _ in range(STEPS):
                params, opt_state, loss = step(params, opt_state, scene, y, jax.random.PRNGKey(0))
                seen.append(float(loss))
            out[(name, case)] = (seen, jax.tree_util.tree_map(np.asarray, params))
    return out


def _rank_steps(ring_run, key):
    return [r[key] for r in ring_run["ranks"] if key in r]


@pytest.mark.parametrize("case", list(STEP_CASES))
@pytest.mark.parametrize("name", list(MESHES))
def test_body_sharded_step_matches_jax(ring_run, name, case):
    """Three steps' losses and the parameters after them against the JAX
    package's body-sharded step and its unsharded step; the first step's
    averaged gradients against the port's single-process gradient of the
    whole batch's loss; the ranks of a sim row hold the same loss, and every
    rank, bitwise, the same parameters."""
    weights = importlib.import_module(PORT + ".weights")
    models = importlib.import_module(PORT + ".models")
    losses_mod = importlib.import_module(PORT + ".train.losses")
    tgraph = importlib.import_module(PORT + ".core.graph")
    recs = _rank_steps(ring_run, f"step_{case}_{name}")
    assert len(recs) == 4
    # a rank's loss is its sims' (every body rank of a sim row holds it); the
    # sim rows' mean is the batch's
    losses = np.mean([r["losses"] for r in recs], axis=0)
    for ref in (name, "single"):
        jloss, jparams = ring_run["jax_steps"][(ref, case)]
        for got, want in zip(losses, jloss):
            assert abs(got - want) <= LOSS_RTOL * abs(want), (ref, got, want)
        want = weights.params_from_jax(jparams)
        for n, p in recs[0]["params"].items():
            w = want[n].numpy()
            assert np.abs(p - w).max() <= PARAM_RTOL * np.abs(w).max(), (ref, n)
    k, phys = STEP_CASES[case]
    dense = models.create_model("egnn_mc", device="cpu", dtype=torch.float64, **SMALL)
    dense.load_state_dict({n: torch.from_numpy(v) for n, v in ring_run["state"].items()})
    arrs = [torch.from_numpy(a) for a in _step_arrays()]
    scene = Scene(*arrs[:4])
    pred = dense(scene, tgraph.knn_mask(scene.pos, k), edge_impl="dense")
    losses_mod.build_loss_fn(_loss_args(phys))(pred, scene, arrs[4])[0].backward()
    for n, p in dense.named_parameters():
        w = p.grad.numpy()
        assert np.abs(recs[0]["grads"][n] - w).max() <= GRAD_RTOL * np.abs(w).max(), n
    row_first = {}
    for r, (sim, _) in zip(recs, _rank_steps(ring_run, f"coord_{name}")):
        assert r["losses"] == row_first.setdefault(sim, r)["losses"]
        for n, p in r["params"].items():
            np.testing.assert_array_equal(p, recs[0]["params"][n])


def test_body_sharded_step_makes_no_whole_edge_tensor(ring_run):
    """One kNN step at (1, 4), forward and backward: no op on a rank outputs
    a tensor whose receiver and sender dimensions are both N (the edge shape
    ``[B, N, N, *]``, the mask's ``[B, N, N]`` too); the receiver rows ``[B,
    N/4, N, He]`` are there."""
    shapes = _rank_steps(ring_run, "shapes")
    assert len(shapes) == 4
    n_local, he = SN // 4, SMALL["hidden_edge_dim"]
    for seen in shapes:
        seen = [tuple(s) for s in seen]
        assert (SB, n_local, SN, he) in seen
        # [N, N, ...] or [B, N, N, ...] (a feature dim of width N may follow)
        whole = [s for s in seen if any(a == b == SN for a, b in zip(s[:2], s[1:3]))]
        assert not whole, whole


def test_gathered_step_of_another_family(ring_run):
    """PaiNN's body-sharded step (its sims gathered whole) at (2, 2) against
    the port's single-process step on the whole batch."""
    models = importlib.import_module(PORT + ".models")
    losses = importlib.import_module(PORT + ".train.losses")
    optim = importlib.import_module(PORT + ".train.optim")
    trainer = importlib.import_module(PORT + ".train.trainer")
    model = models.create_model("painn", device="cpu", dtype=torch.float64, **PAINN)
    model.load_state_dict({n: torch.from_numpy(v) for n, v in ring_run["painn_state"].items()})
    opt = optim.create_optimizer(model.parameters(), **OPT)
    base, seen = losses.build_loss_fn(_loss_args(False)), []

    def loss_fn(pred, s, yy):
        total, terms = base(pred, s, yy)
        seen.append(float(total.detach()))
        return total, terms

    step, _ = trainer.make_train_step(model, opt, loss_fn, ["pos_dt", "vel"], SN - 1,
                                      torch.float64)
    arrs = [torch.from_numpy(a) for a in _step_arrays()]
    for _ in range(STEPS):
        step(Scene(*arrs[:4]), arrs[4])
    recs = _rank_steps(ring_run, "step_painn_2x2")
    assert len(recs) == 4
    for got, want in zip(np.mean([r["losses"] for r in recs], axis=0), seen):
        assert abs(got - want) <= LOSS_RTOL * abs(want)
    for r in recs:
        for n, p in model.named_parameters():
            w = p.detach().numpy()
            assert np.abs(r["params"][n] - w).max() <= PARAM_RTOL * np.abs(w).max(), n
            np.testing.assert_array_equal(r["params"][n], recs[0]["params"][n])


@pytest.mark.parametrize("name", list(MESHES))
def test_ring_gradient_matches_the_dense_model(ring_run, name):
    """The gradient of ``sum(pred * w)`` through ``EGNNMC(body_ring=True)``,
    each rank's share summed over the ranks, against the dense model's on the
    whole batch."""
    tgraph = importlib.import_module(PORT + ".core.graph")
    dense = importlib.import_module(PORT + ".models").create_model(
        "egnn_mc", device="cpu", dtype=torch.float64, **SMALL)
    dense.load_state_dict({n: torch.from_numpy(v) for n, v in ring_run["state"].items()})
    arrs = [torch.from_numpy(a) for a in _step_arrays()]
    scene = Scene(*arrs[:4])
    w = torch.from_numpy(np.random.default_rng(12).normal(size=(SB, SN, 6)))
    (dense(scene, tgraph.knn_mask(scene.pos, SN - 1), edge_impl="dense") * w).sum().backward()
    shares = _rank_steps(ring_run, f"ring_grad_{name}")
    assert len(shares) == 4
    for n, p in dense.named_parameters():
        got = sum(share[n] for share in shares)
        want = p.grad.numpy()
        assert np.abs(got - want).max() <= RING_GRAD_RTOL * np.abs(want).max(), n


# ------------------------------------------------------- data-parallel trainer

def _halves_batch(ds):
    """The first GT batch of ``ds`` as two ranks integrate it: the whole batch's
    initial states, each half integrated alone (on the CPU the plain
    integrator's sums depend on the batch's shape; see
    ``test_sharded_datagen_rows_are_the_single_process_rows``)."""
    physics = importlib.import_module(PORT + ".core.physics")
    pos, vel, mass = physics.sample_initial_conditions(TB, ds.num_nodes, 3, ds.dtype, "cpu",
                                                       ds.generator)
    halves = [physics.simulate(pos[h], vel[h], mass[h], ds.sim_length, ds.sample_freq,
                               ds.params) for h in (slice(0, TB // 2), slice(TB // 2, TB))]
    loc, v, force = (torch.cat([h[i] for h in halves]).numpy() for i in range(3))
    return {"loc": loc, "vel": v, "force": force, "mass": mass.numpy()}


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The JAX Trainer's three steps on the whole batch (its first GT batch the
    port's, as ``test_torch_train_slice.py`` aligns them) and the port's
    Trainer on two gloo ranks from the same parameters."""
    jax, jnp = _jax()
    jotf = importlib.import_module(TPU + ".data.gravity_otf")
    jt_mod = importlib.import_module(TPU + ".train.trainer")
    jcfg = importlib.import_module(TPU + ".utils.config")
    tcfg = importlib.import_module(PORT + ".utils.config")
    tdl = importlib.import_module(PORT + ".data.dataloaders")
    weights = importlib.import_module(PORT + ".weights")
    root = tmp_path_factory.mktemp("dp")
    targs, _ = tcfg.parse_args(ARGV)
    traj = _halves_batch(tdl.create_dataloader(targs, device="cpu").dataset)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jotf.GravityDatasetOtf, "generate_trajectories",
                   lambda self, bs: {k: jnp.asarray(v) for k, v in traj.items()})
        (root / "jax").mkdir()
        mp.chdir(root / "jax")
        jargs, jc = jcfg.parse_args(ARGV + ["--trainer.run_name", "jax"])
        jt = jt_mod.create_trainer_from_args(jargs, resolved_config=jc)
        assert jt.mesh is None  # B=4 on 8 virtual devices: the JAX trainer runs unsharded
        jt.params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64), jt.params)
        jt.opt_state = jt.tx.init(jt.params)
        state = {k: v.numpy() for k, v in weights.params_from_jax(jt.params).items()}
        pool = ThreadPoolExecutor(1)  # the ranks run while the JAX trainer steps
        job = pool.submit(launch.spawn_ranks, _dp_ranks, 2, (str(root / "torch"), state, ARGV),
                          timeout=RANK_TIMEOUT)
        drawn, jbefore, jlogs = [], [], []
        get = jt.dataset.get_batch

        def recorded():
            drawn.append(get())
            return drawn[-1]

        mp.setattr(jt.dataset, "get_batch", recorded)
        for _ in range(STEPS):
            jbefore.append(jax.tree_util.tree_map(np.array, jt.params))
            jlogs.append(jt.train_one_epoch())
        ranks = job.result()
        pool.shutdown()
        return dict(ranks=ranks, jt=jt, drawn=drawn, jbefore=jbefore, jlogs=jlogs, root=root,
                    traj=traj)
    finally:
        mp.undo()


@pytest.mark.parametrize("step", range(STEPS))
def test_dp_ranks_draw_the_halves_of_the_jax_batch(dp_run, step):
    js, jy = dp_run["drawn"][step]
    r0, r1 = (r["drawn"][step] for r in dp_run["ranks"])
    np.testing.assert_array_equal(np.concatenate([r0[0], r1[0]]), np.asarray(js.pos))
    np.testing.assert_array_equal(np.concatenate([r0[1], r1[1]]), np.asarray(jy))
    assert r0[0].shape[0] == TB // 2


@pytest.mark.parametrize("step", range(STEPS))
def test_dp_losses_agree(dp_run, step):
    """Each step's loss recomputed in float64 on the whole batch from the
    parameters before it, the port's against the JAX trainer's; the logged
    metrics (the ranks' means) against the JAX trainer's."""
    jgraph = importlib.import_module(TPU + ".core.graph")
    tgraph = importlib.import_module(PORT + ".core.graph")
    models = importlib.import_module(PORT + ".models")
    jt = dp_run["jt"]
    js, jy = dp_run["drawn"][step]
    jpred = jt.model.apply(dp_run["jbefore"][step], js, jgraph.knn_mask(js.pos, TN - 1))
    jloss = float(jt.loss_fn(jpred, js, jy)[0])
    tcfg = importlib.import_module(PORT + ".utils.config")
    tlosses = importlib.import_module(PORT + ".train.losses")
    targs, _ = tcfg.parse_args(ARGV)
    model = models.create_model("egnn_mc", device="cpu", dtype=torch.float64,
                                **targs.model_kwargs)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in dp_run["ranks"][0]["before"][step].items()})
    ts = Scene(*(torch.from_numpy(np.array(x)) for x in (js.pos, js.vel, js.force, js.mass)))
    with torch.no_grad():
        tpred = model(ts, tgraph.knn_mask(ts.pos, TN - 1), edge_impl="dense")
    tloss = float(tlosses.build_loss_fn(targs)(tpred, ts, torch.from_numpy(np.array(jy)))[0])
    assert abs(tloss - jloss) <= LOSS_RTOL * abs(jloss)
    jlog = dp_run["jlogs"][step]
    for r in dp_run["ranks"]:
        tlog = r["logs"][step]
        assert set(tlog) == set(jlog)
        for k in jlog:
            if "per_sec" not in k:
                assert tlog[k] == pytest.approx(jlog[k], rel=1e-6), k


def test_dp_parameters_after_three_steps_agree(dp_run):
    weights = importlib.import_module(PORT + ".weights")
    want = weights.params_from_jax(dp_run["jt"].params)
    for name, p in dp_run["ranks"][0]["after"][-1].items():
        w = want[name].numpy()
        assert np.abs(p - w).max() <= PARAM_RTOL * np.abs(w).max(), name
    assert all(r["count"] == STEPS and r["mesh"] for r in dp_run["ranks"])


@pytest.mark.parametrize("step", range(STEPS))
def test_dp_ranks_hold_bitwise_equal_parameters(dp_run, step):
    a, b = (r["after"][step] for r in dp_run["ranks"])
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    if step:  # and the step moved them
        assert any(not np.array_equal(a[k], dp_run["ranks"][0]["after"][step - 1][k]) for k in a)


def test_dp_only_the_first_rank_writes(dp_run):
    r0, r1 = dp_run["ranks"]
    assert r1["files"] == [] and r0["save_dir"] == r1["save_dir"]
    ck = os.path.join(r0["save_dir"], "checkpoints", str(STEPS))
    assert {os.path.join(r0["save_dir"], f) for f in ("metrics.jsonl", "config.yaml",
                                                      "training_args.json")} <= set(r0["files"])
    assert os.path.join(ck, "sticking_distributions.json") in r0["files"]
    assert any(f.startswith("saved_simulations") for f in r0["files"])  # the GT cache


def test_dp_evaluation_is_the_same_on_both_ranks(dp_run):
    r0, r1 = dp_run["ranks"]
    assert r0["survived"] == r1["survived"] and 0 <= r0["survived"] <= 11
