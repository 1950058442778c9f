"""The port's ``parallel/`` in one process: the mesh helpers and their
refusals, ``initialize_distributed``'s failure rule, the ring's block
functions against the JAX package's, a world-size-1 ring against the dense
stage, and a JAX checkpoint in ``EGNNMC(body_ring=True)``.

Tolerances, each with its reason:
* ``_block_acceleration`` and ``_block_sums`` against the JAX functions in
  float64, on a diagonal block (step 0's, the self pairs left out) and an
  off-diagonal one: 1e-12 of the largest value (the same arithmetic; only
  the order of the sums differs).  The JAX ``_block_sums`` computes its
  geometry and ``trans`` in float32 whatever its inputs' dtype; the port
  widens those parts to float64 for a float64 model, so the JAX function
  runs here with ``jnp.float32`` read as ``jnp.float64`` (the JAX package's
  module is not edited; its attribute is patched for the call);
* the world-size-1 ring against the dense edge stage in float64: 1e-12;
* the committed N=100 checkpoint in the ring against the JAX dense model,
  float64: 1e-12 of the largest output.

The multi-process cases (gloo ranks) are in ``test_torch_parallel_gloo.py``.
"""

import datetime
import importlib
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

TPU = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu"
PORT = TPU + "_torch"
JRING = importlib.import_module(TPU + ".parallel.ring")
JRE = importlib.import_module(TPU + ".parallel.ring_egnn")
jmodels = importlib.import_module(TPU + ".models")
jgraph = importlib.import_module(TPU + ".core.graph")
JScene = importlib.import_module(TPU + ".core.scene").Scene
pmesh = importlib.import_module(PORT + ".parallel.mesh")
ring = importlib.import_module(PORT + ".parallel.ring")
ring_egnn = importlib.import_module(PORT + ".parallel.ring_egnn")
sharded = importlib.import_module(PORT + ".parallel.sharded")
tmodels = importlib.import_module(PORT + ".models")
tgraph = importlib.import_module(PORT + ".core.graph")
Scene = importlib.import_module(PORT + ".core.scene").Scene
weights = importlib.import_module(PORT + ".weights")
self_feed = importlib.import_module(PORT + ".rollout.self_feed")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "docs", "results", "fidelity_n100", "egnn_n100_ckpt_30_model.ckpt")
BLOCK_RTOL = 1e-12
SMALL = dict(num_layers=2, hidden_node_dim=16, hidden_edge_dim=16, hidden_coord_dim=16)
MARKERS = ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE", "MASTER_ADDR", "RANK",
           "LOCAL_RANK", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK", "SLURM_LOCALID",
           "OMPI_COMM_WORLD_LOCAL_RANK")


class WideJnp:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= rtol * np.abs(want).max(), np.abs(got - want).max()


# ------------------------------------------------------------------ world 1

@pytest.fixture(scope="module")
def world1():
    """A gloo group of one rank (a file store, no port) and its mesh."""
    assert not dist.is_initialized()
    store = tempfile.mktemp(prefix="world1-")
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        yield pmesh.make_mesh()
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.unlink(store)


def test_mesh_shape_and_refusals(world1):
    assert world1.mesh_dim_names == ("sim", "body") and tuple(world1.shape) == (1, 1)
    assert pmesh.axis_size(world1, "sim") == pmesh.axis_size(world1, "body") == 1
    with pytest.raises(ValueError, match="1 rank"):
        pmesh.make_mesh(2)
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.make_mesh(body_parallel=2)
    x = torch.arange(24.0).reshape(2, 4, 3)
    assert torch.equal(pmesh.local_rows(x, world1, shard_bodies=True), x)
    assert pmesh.local_rows(None, world1) is None
    # the collectives of a group of one give their inputs back
    assert torch.equal(pmesh.psum(x), x)
    assert torch.equal(pmesh.all_gather_rows(x), x)
    assert all(torch.equal(a, b) for a, b in zip(pmesh.ring_shift([x, x + 1]), [x, x + 1]))
    assert pmesh.ring_shift_grad([x])[0] is x and pmesh.all_gather_rows_grad(x, dim=1) is x
    assert pmesh.broadcast_object({"a": 1}) == {"a": 1}


class FakeMesh:
    """Stands in for a ``DeviceMesh`` at a coordinate of a larger mesh."""

    mesh_dim_names = ("sim", "body")

    def __init__(self, shape, coord):
        self.shape, self.coord = shape, coord

    def size(self, dim):
        return self.shape[dim]

    def get_local_rank(self, mesh_dim):
        return self.coord[self.mesh_dim_names.index(mesh_dim)]


@pytest.mark.parametrize("coord", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_local_rows_on_a_2x2_mesh(coord):
    x = torch.arange(4 * 6 * 3).reshape(4, 6, 3)
    got = pmesh.local_rows(x, FakeMesh((2, 2), coord), shard_bodies=True)
    s, b = coord
    assert torch.equal(got, x[2 * s:2 * s + 2, 3 * b:3 * b + 3])
    assert torch.equal(pmesh.local_rows(x, FakeMesh((2, 2), coord)), x[2 * s:2 * s + 2])
    with pytest.raises(ValueError, match="do not split"):
        pmesh.local_rows(x[:3], FakeMesh((2, 2), coord))


def test_make_mesh_needs_a_group(monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(ValueError, match="no process group"):
        pmesh.make_mesh()


# ------------------------------------------------------ initialize_distributed

@pytest.fixture()
def failing_init(monkeypatch):
    """``init_process_group`` that fails as a bad address does, and records its
    arguments; no group up; no launcher variable set."""
    calls = []

    def boom(**kwargs):
        calls.append(kwargs)
        raise RuntimeError("bad rendezvous")

    monkeypatch.setattr(dist, "init_process_group", boom)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    for name in MARKERS:
        monkeypatch.delenv(name, raising=False)
    return calls


def test_initialize_distributed_single_process_goes_on_alone(failing_init, monkeypatch):
    with pytest.warns(UserWarning, match="skipped"):
        assert pmesh.initialize_distributed(backend="gloo") is False
    assert failing_init[-1]["backend"] == "gloo"
    monkeypatch.setenv("SLURM_NTASKS", "1")  # a marker of one process stays single
    with pytest.warns(UserWarning):
        assert pmesh.initialize_distributed(
            backend="gloo", timeout=datetime.timedelta(seconds=5)) is False
    assert failing_init[-1]["timeout"].total_seconds() == 5.0


@pytest.mark.parametrize("name,value", [("WORLD_SIZE", "2"), ("SLURM_NTASKS", "2"),
                                        ("OMPI_COMM_WORLD_SIZE", "4"),
                                        ("MASTER_ADDR", "10.0.0.1")])
def test_initialize_distributed_raises_under_a_launcher(failing_init, monkeypatch, name, value):
    monkeypatch.setenv(name, value)
    with pytest.raises(RuntimeError, match="bad rendezvous"):
        pmesh.initialize_distributed(backend="gloo")


@pytest.mark.parametrize("kwargs", [dict(world_size=2, rank=0),
                                    dict(init_method="tcp://10.0.0.1:1234")])
def test_initialize_distributed_raises_on_explicit_multi_process(failing_init, kwargs):
    with pytest.raises(RuntimeError, match="bad rendezvous"):
        pmesh.initialize_distributed(backend="gloo", **kwargs)


def test_initialize_distributed_reads_slurm_rank_and_size(failing_init, monkeypatch):
    monkeypatch.setenv("SLURM_NTASKS", "4")
    monkeypatch.setenv("SLURM_PROCID", "3")
    with pytest.raises(RuntimeError):
        pmesh.initialize_distributed(backend="gloo")
    assert failing_init[-1]["world_size"] == 4 and failing_init[-1]["rank"] == 3


def test_nccl_ranks_past_the_cards_raise_before_any_work(failing_init, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(ValueError, match="NCCL"):
        pmesh.initialize_distributed(backend="nccl")
    assert failing_init == []
    monkeypatch.setenv("LOCAL_RANK", "0")  # one rank a card passes on to the init
    with pytest.raises(RuntimeError):
        pmesh.initialize_distributed(backend="nccl", world_size=2, rank=0)
    assert failing_init[-1]["backend"] == "nccl"


# ------------------------------------------------------------ block functions

def _blocks(seed, ni=5, nj=7, B=2):
    rng = np.random.default_rng(seed)
    dst, src = rng.normal(size=(B, ni, 3)), rng.normal(size=(B, nj, 3))
    mass = rng.uniform(0.5, 1.5, size=(B, nj, 1))
    return dst, src, mass


@pytest.mark.parametrize("diagonal", [True, False])
def test_block_acceleration_matches_jax(diagonal):
    dst, src, mass = _blocks(1)
    if diagonal:  # a block visiting itself: the r2 == 0 self pairs contribute nothing
        src, mass = dst, mass[:, :dst.shape[1]]
    want = JRING._block_acceleration(jnp.asarray(dst), jnp.asarray(src), jnp.asarray(mass),
                                     2.0, 0.2)
    got = ring._block_acceleration(torch.from_numpy(dst), torch.from_numpy(src),
                                   torch.from_numpy(mass), 2.0, 0.2)
    _close(got.numpy(), want, BLOCK_RTOL)


def _edge_inputs(seed, ni, nj, He=16, Hc=16, B=2):
    rng = np.random.default_rng(seed)
    hA, hB = rng.normal(size=(B, ni, He)), rng.normal(size=(B, nj, He))
    nd_i, nd_v = rng.normal(size=(B, ni, 10)), rng.normal(size=(B, nj, 10))
    nd_i[..., 6], nd_v[..., 6] = rng.uniform(0.5, 1.5, (B, ni)), rng.uniform(0.5, 1.5, (B, nj))
    w = (rng.normal(size=(5, He)) * 0.3, rng.normal(size=(He, He)) * 0.3, rng.normal(size=He),
         rng.normal(size=(He, Hc)) * 0.3, rng.normal(size=Hc), rng.normal(size=Hc))
    return hA, hB, nd_i, nd_v, w


@pytest.mark.parametrize("diagonal", [True, False])
@pytest.mark.parametrize("norm_diff,tanh", [(True, True), (False, False)])
def test_block_sums_match_jax(diagonal, norm_diff, tanh, monkeypatch):
    ni = 6
    hA, hB, nd_i, nd_v, w = _edge_inputs(2, ni, ni if diagonal else 9)
    if diagonal:
        hB, nd_v = hA.copy(), nd_i.copy()
    nj = hB.shape[1]
    keep = np.ones((ni, nj)) - (np.eye(ni) if diagonal else 0.0)
    monkeypatch.setattr(JRE, "jnp", WideJnp())
    want = JRE._block_sums(*(jnp.asarray(a) for a in (hA, hB, nd_i, nd_v, *w, keep)),
                           tanh, norm_diff)
    got = ring_egnn._block_sums(*(torch.from_numpy(a) for a in (hA, hB, nd_i, nd_v, *w, keep)),
                                tanh, norm_diff)
    for g, j in zip(got, want):
        assert g.dtype == torch.float64
        _close(g.numpy(), j, BLOCK_RTOL)


def test_geometry_dtype():
    assert ring_egnn.geometry_dtype(torch.bfloat16) == torch.float32
    assert ring_egnn.geometry_dtype(torch.float32) == torch.float32
    assert ring_egnn.geometry_dtype(torch.float64) == torch.float64


# ---------------------------------------------------------------- the ring

def _scene(seed, B=2, N=7):
    rng = np.random.default_rng(seed)
    return Scene(torch.from_numpy(rng.normal(size=(B, N, 3))),
                 torch.from_numpy(rng.normal(size=(B, N, 3)) * 0.3),
                 torch.zeros(B, N, 3, dtype=torch.float64),
                 torch.from_numpy(rng.uniform(0.5, 1.5, size=(B, N, 1))))


@pytest.mark.parametrize("norm_diff", [True, False])
def test_world1_ring_matches_the_dense_stage(world1, norm_diff):
    torch.manual_seed(3)
    dense = tmodels.create_model("egnn_mc", device="cpu", dtype=torch.float64,
                                 norm_diff=norm_diff, **SMALL)
    rmodel = tmodels.create_model("egnn_mc", device="cpu", dtype=torch.float64,
                                  norm_diff=norm_diff, body_ring=True, **SMALL)
    rmodel.load_state_dict(dense.state_dict())
    scene = _scene(4)
    body = pmesh.axis_group(world1, "body")
    with torch.no_grad():
        want = dense(scene, tgraph.knn_mask(scene.pos, 6), edge_impl="dense")
        got = rmodel(scene, None, ring=body)
    _close(got.numpy(), want.numpy(), BLOCK_RTOL)
    loc, vel, surv = sharded.make_body_ring_rollout_fn(rmodel, 6, world1)(scene)
    jloc, jvel, jsurv = self_feed.make_rollout_fn(dense, 6)(scene)
    _close(loc.numpy(), jloc.numpy(), BLOCK_RTOL)
    _close(vel.numpy(), jvel.numpy(), BLOCK_RTOL)
    assert torch.equal(surv, jsurv)
    acc = ring.make_ring_acceleration(world1, ring.GravityParams())(scene.pos, scene.mass)
    want_acc = importlib.import_module(PORT + ".core.physics").compute_acceleration(
        scene.pos, scene.mass, 2.0, 0.2)
    _close(acc.numpy(), want_acc.numpy(), BLOCK_RTOL)


def test_body_ring_model_refusals(world1):
    """What the ring refuses (no ``ring=``, an activation other than silu, a
    data mask in the body-sharded step); and what it no longer refuses: the
    ring under autograd, whose gradient is the dense model's, and the
    body-sharded step (``shard_bodies=True``), whose three steps are the
    single-process step's, both in a world-size-1 ring in float64
    (``BLOCK_RTOL``)."""
    rmodel = tmodels.create_model("egnn_mc", device="cpu", body_ring=True, **SMALL)
    scene = _scene(5).astype(torch.float32)
    with torch.no_grad(), pytest.raises(ValueError, match="ring="):
        rmodel(scene, None)
    with pytest.raises(ValueError, match="silu"):
        tmodels.create_model("egnn_mc", device="cpu", body_ring=True, activation="relu", **SMALL)
    scene = _scene(5)
    torch.manual_seed(4)
    dense = tmodels.create_model("egnn_mc", device="cpu", dtype=torch.float64, **SMALL)
    rmodel = tmodels.create_model("egnn_mc", device="cpu", dtype=torch.float64, body_ring=True,
                                  **SMALL)
    rmodel.load_state_dict(dense.state_dict())
    # the ring under autograd
    w = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 7, 6)))
    (dense(scene, tgraph.knn_mask(scene.pos, 6), edge_impl="dense") * w).sum().backward()
    (rmodel(scene, None, ring=pmesh.axis_group(world1, "body")) * w).sum().backward()
    for (n, p), q in zip(dense.named_parameters(), rmodel.parameters()):
        _close(q.grad.numpy(), p.grad.numpy(), BLOCK_RTOL)
    # the body-sharded step against the single-process one, on a kNN mask
    losses = importlib.import_module(PORT + ".train.losses")
    trainer = importlib.import_module(PORT + ".train.trainer")
    optim = importlib.import_module(PORT + ".train.optim")
    loss_fn = losses.build_loss_fn(type("A", (), {"target": "pos_dt+vel"})())
    y = torch.from_numpy(np.random.default_rng(7).normal(size=(2, 7, 6)))
    got = []
    for shard in (True, False):
        model = tmodels.create_model("egnn_mc", device="cpu", dtype=torch.float64, **SMALL)
        model.load_state_dict(rmodel.state_dict())
        opt = optim.create_optimizer(model.parameters(), 0.5, 16, warmup=4)
        if shard:
            step, _ = sharded.make_sharded_train_step(model, opt, loss_fn, ["pos_dt", "vel"], 3,
                                                      world1, torch.float64, shard_bodies=True)
            with pytest.raises(ValueError, match="no data mask"):
                step(scene, y, torch.ones(2, 7, 7, dtype=torch.bool))
        else:
            step, _ = trainer.make_train_step(model, opt, loss_fn, ["pos_dt", "vel"], 3,
                                              torch.float64)
        vecs = [step(scene, y) for _ in range(3)]
        got.append((vecs, dict(model.named_parameters())))
    for a, b in zip(got[0][0], got[1][0]):
        _close(a.numpy(), b.numpy(), BLOCK_RTOL)
    for n, p in got[1][1].items():
        _close(got[0][1][n].detach().numpy(), p.detach().numpy(), BLOCK_RTOL)


@pytest.mark.parametrize("k", [1, 3, 6, 11])
@pytest.mark.parametrize("blocks", [1, 2, 4])
def test_knn_mask_rows_are_the_whole_masks_rows(k, blocks):
    """``knn_mask(..., rows)`` (the body-sharded step's mask) gives the rows
    of the whole mask, bitwise, coincident bodies (tied distances) included."""
    pos = torch.from_numpy(np.random.default_rng(k).normal(size=(3, 12, 3)))
    pos[0, 3] = pos[0, 5]
    pos[1, 7] = pos[1, 0]
    whole = tgraph.knn_mask(pos, k)
    n = 12 // blocks
    for b in range(blocks):
        rows = slice(b * n, (b + 1) * n)
        assert torch.equal(tgraph.knn_mask(pos, k, rows), whole[:, rows])


def test_jax_checkpoint_runs_in_the_ring(world1):
    """The committed N=100 checkpoint (L6, width 128) loads into
    ``EGNNMC(body_ring=True)`` through the converter unchanged and, in a
    world-size-1 ring in float64, gives the JAX dense model's output."""
    params = weights.read_jax_checkpoint(CKPT)
    rmodel = tmodels.create_model("egnn_mc", device="cpu", dtype=torch.float64, body_ring=True)
    rmodel.load_state_dict(weights.params_from_jax(params))
    scene = _scene(6, B=2, N=9)
    js = JScene(*(jnp.asarray(t.numpy()) for t in (scene.pos, scene.vel, scene.force, scene.mass)))
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
    want = jmodels.create_model("egnn_mc").apply(jparams, js, jgraph.knn_mask(js.pos, 8))
    with torch.no_grad():
        got = rmodel(scene, None, ring=pmesh.axis_group(world1, "body"))
    _close(got.numpy(), np.asarray(want), BLOCK_RTOL)
    # the dense model's parameter tree: the ring adds no parameter
    dense = tmodels.create_model("egnn_mc", device="cpu")
    assert {k: v.shape for k, v in rmodel.state_dict().items()} == {
        k: v.shape for k, v in dense.state_dict().items()}


class WholeBatches:
    """Stands in for a dataset with no ``shard`` (the offline one's kind): whole
    ``(scene, y, mask)`` batches."""

    def __init__(self):
        rng = np.random.default_rng(7)
        self.batch = (Scene(*(torch.from_numpy(rng.normal(size=(4, 5, 3))) for _ in range(3)),
                            torch.ones(4, 5, 1, dtype=torch.float64)),
                      torch.from_numpy(rng.normal(size=(4, 5, 6))), torch.ones(4, 5, 5))

    def get_batch(self):
        return self.batch


@pytest.mark.parametrize("sim", [0, 1])
def test_trainer_takes_its_rows_of_a_whole_batch(sim):
    """A data-parallel trainer whose dataset serves whole batches takes its
    rank's rows of every item (the JAX trainer's sharded batch)."""
    trainer_mod = importlib.import_module(PORT + ".train.trainer")
    ds = WholeBatches()
    fake = type("T", (), {"dataset": ds, "_rows": FakeMesh((2, 1), (sim, 0))})()
    scene, y, mask = trainer_mod.Trainer._next_batch(fake)
    rows = slice(2 * sim, 2 * sim + 2)
    whole = ds.batch
    for got, want in zip((scene.pos, scene.vel, scene.force, scene.mass, y, mask),
                         (whole[0].pos, whole[0].vel, whole[0].force, whole[0].mass, whole[1],
                          whole[2])):
        assert torch.equal(got, want[rows])
    assert scene.charge is None
    fake._rows = None  # not data parallel: the batch as it is
    assert trainer_mod.Trainer._next_batch(fake) is whole
