"""The offline charged-systems data of the port against the JAX package's.

* Datagen (``data/offline_datagen.py``): the integrator from the JAX
  package's own draws (reproduced here from the key as ``simulate_system``
  draws them) gives ``simulate_system``'s trajectories, edges and charges in
  float64 within 1e-10 of the largest value, for isolated bodies, sticks,
  hinges and all three in one system, the constraint-consistent initial
  velocities included; the hinge's closed-form solve equals
  ``numpy.linalg.solve``; sticks and hinges keep their lengths.  The sampler
  draws the JAX sampler's distribution (charge frequency, two-sample KS tests
  of the positions and speeds).  ``generate_offline_dataset`` writes the JAX
  package's file names, shapes, dtypes and ``cfg`` lists; ``main`` runs on the
  CPU with ``--device cpu``.
* Loader (``data/offline_dataset.py``, ``data/dataloaders.py``): each package
  reads the files the other wrote, and from the same files and seed the two
  give bitwise the same batches, test-split rotations and cutoff masks, at
  cutoff rates 0, 0.3 and 0.95 (rows with no sender), ties at the cutoff
  included; the metadata too; ``create_dataloader``
  with ``segnn_nbody_offline`` gives the port's loader, whose
  ``preprocess_batch`` mask is the JAX loader's.
"""

import importlib
import os
import pickle
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

TPU = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu"
PORT = TPU + "_torch"
JD = importlib.import_module(TPU + ".data.offline_datagen")
JDS = importlib.import_module(TPU + ".data.offline_dataset")
JDL = importlib.import_module(TPU + ".data.dataloaders")
TD = importlib.import_module(PORT + ".data.offline_datagen")
TDS = importlib.import_module(PORT + ".data.offline_dataset")
TDL = importlib.import_module(PORT + ".data.dataloaders")

RTOL = 1e-10
COMPOSITIONS = [(5, 0, 0), (1, 2, 0), (0, 0, 2), (3, 2, 1)]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _jax_draws(key, n, params=JD.OfflineParams()):
    """``simulate_system``'s initial arrays for ``key``, as it draws them."""
    k_c, k_x, k_v = jax.random.split(key, 3)
    charges = jnp.where(jax.random.bernoulli(k_c, 0.5, (n, 1)), 1.0, -1.0)
    loc_std = params.loc_std * (n / 5.0) ** (1.0 / 3.0) + 0.1
    X = jax.random.normal(k_x, (n, 3)) * loc_std
    V = jax.random.normal(k_v, (n, 3))
    V = V / jnp.linalg.norm(V, axis=-1, keepdims=True) * params.vel_norm
    return np.asarray(X), np.asarray(V), np.asarray(charges)


@pytest.mark.parametrize("comp", COMPOSITIONS, ids=lambda c: "_".join(map(str, c)))
def test_integrator_matches_jax(comp):
    n = comp[0] + 2 * comp[1] + 3 * comp[2]
    keys = jax.random.split(jax.random.PRNGKey(sum(comp) + 7), 2)
    want = [JD.simulate_system(k, *comp, T=400, sample_freq=40) for k in keys]
    X, V, q = (torch.from_numpy(np.stack(a)) for a in zip(*(_jax_draws(k, n) for k in keys)))
    got = TD.integrate_systems(X, V, q, *comp, T=400, sample_freq=40)
    assert got[0].shape == (2, 10, n, 3) and got[0].dtype == torch.float64
    for i, name in enumerate(("loc", "vel", "edges", "charges")):
        w = np.stack([np.asarray(j[i]) for j in want])
        assert _rel(got[i], w) <= RTOL, name


def test_closed_form_solve_equals_numpy():
    rng = np.random.default_rng(0)
    e = rng.normal(size=(2, 64, 3))
    e /= np.linalg.norm(e, axis=-1, keepdims=True)
    A = np.eye(3) + e[0][:, :, None] * e[0][:, None] + e[1][:, :, None] * e[1][:, None]
    a = rng.normal(size=(64, 3))
    got = TD._solve3(torch.from_numpy(A), torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, np.linalg.solve(A, a[..., None])[..., 0], rtol=0, atol=1e-13)


def test_sticks_and_hinges_keep_their_lengths():
    X, V, q = TD.sample_initial_state(3, 8, generator=torch.Generator().manual_seed(1),
                                      dtype=torch.float64, device="cpu")
    loc, _, edges, q = TD.integrate_systems(X, V, q, 1, 2, 1, T=500, sample_freq=10)
    loc = loc.numpy()
    for a, b in [(1, 2), (3, 4), (5, 6), (5, 7)]:  # sticks (1,2), (3,4); the hinge's beams
        lengths = np.linalg.norm(loc[:, :, a] - loc[:, :, b], axis=-1)
        np.testing.assert_allclose(lengths, lengths[:, :1].repeat(50, 1), rtol=1e-8)
    np.testing.assert_array_equal(edges.numpy(), (q @ q.transpose(1, 2)).numpy())


def test_the_samplers_draw_the_same_distribution():
    n, S = 10, 400
    keys = jax.random.split(jax.random.PRNGKey(31), S)
    jx, jv, jq = (np.stack(a) for a in zip(*(_jax_draws(k, n) for k in keys)))
    tx, tv, tq = (t.numpy() for t in TD.sample_initial_state(
        S, n, generator=torch.Generator().manual_seed(31), dtype=torch.float64, device="cpu"))
    assert set(np.unique(tq)) == set(np.unique(jq)) == {-1.0, 1.0}
    assert abs(tq.mean()) < 0.03
    np.testing.assert_allclose(np.linalg.norm(tv, axis=-1), 0.5, rtol=1e-12)
    assert stats.ks_2samp(tx.ravel(), jx.ravel()).pvalue >= 0.01
    assert stats.ks_2samp(tv.ravel(), jv.ravel()).pvalue >= 0.01


SMALL = dict(num_train=6, num_valid=3, num_test=4, length=400, length_test=400, sample_freq=40)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """One 3_2_1 dataset written by each package."""
    root = tmp_path_factory.mktemp("offline")
    jtag = JD.generate_offline_dataset(str(root / "jax"), 3, 2, 1, seed=0, **SMALL)
    ttag = TD.generate_offline_dataset(str(root / "torch"), 3, 2, 1, seed=0, device="cpu",
                                       **SMALL)
    assert jtag == ttag == "_charged3_2_1"
    return root


def test_files_are_the_jax_packages(files):
    names = sorted(os.listdir(files / "jax"))
    assert sorted(os.listdir(files / "torch")) == names and len(names) == 15
    for name in names:
        if name.endswith(".pkl"):
            with open(files / "jax" / name, "rb") as f, open(files / "torch" / name, "rb") as g:
                assert pickle.load(f) == pickle.load(g)
            continue
        j, t = np.load(files / "jax" / name), np.load(files / "torch" / name)
        assert t.shape == j.shape and t.dtype == np.float32, name
        assert np.isfinite(t).all()
    assert np.load(files / "torch" / "loc_train_charged3_2_1.npy").shape == (6, 10, 10, 3)


def test_main_writes_on_the_cpu(tmp_path, capsys):
    TD.main(["--path", str(tmp_path), "--num-train", "2", "--num-valid", "1", "--num-test", "1",
             "--length", "200", "--length_test", "200", "--sample-freq", "50", "--device", "cpu"])
    assert "wrote dataset _charged5_0_0" in capsys.readouterr().out
    assert np.load(tmp_path / "loc_test_charged5_0_0.npy").shape == (1, 4, 5, 3)


def _pair(root, partition, cutoff, seed=3, batch_size=4):
    kw = dict(partition=partition, frame_0=2, frame_T=7, cutoff_rate=cutoff,
              batch_size=batch_size, seed=seed)
    return (JDS.OfflineNBodyDataset("3_2_1", str(root), **kw),
            TDS.OfflineNBodyDataset("3_2_1", str(root), device="cpu", **kw))


def _same_batch(jb, tb):
    (js, jy, jm), (ts, ty, tm) = jb, tb
    for a, b in ((ts.pos, js.pos), (ts.vel, js.vel), (ts.force, js.force), (ts.mass, js.mass),
                 (ts.charge, js.charge), (ty, jy), (tm, jm)):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("partition", ["train", "test"])
@pytest.mark.parametrize("cutoff", [0.0, 0.3, 0.95])
def test_each_package_reads_the_others_files_bitwise(files, writer, partition, cutoff):
    jds, tds = _pair(files / writer, partition, cutoff)
    for name in ("loc_0", "loc_t", "vel_0", "vel_t", "charges"):  # the rotations too
        np.testing.assert_array_equal(getattr(tds, name), getattr(jds, name))
    for _ in range(3):
        _same_batch(jds.get_batch(), tds.get_batch())
    assert tds.get_serializable_attributes() == jds.get_serializable_attributes()
    deg = tds.get_batch()[2].sum(-1)
    n = tds.num_nodes
    if cutoff == 0.0:
        assert bool((deg == n - 1).all())
    if cutoff == 0.95:
        assert bool((deg == 0).any())  # receivers with no sender


def test_ties_at_the_cutoff_break_as_the_jax_dataset_breaks_them(tmp_path):
    """Bodies on a unit lattice: many pairs lie at the cutoff's distance."""
    grid = np.stack(np.meshgrid(*[np.arange(2.0)] * 3, indexing="ij"), -1).reshape(8, 3)
    loc = np.broadcast_to(grid, (3, 4, 8, 3)).astype(np.float32).copy()
    loc[1] += 0.5
    for name, a in (("loc", loc), ("vel", np.ones_like(loc)),
                    ("charges", np.ones((3, 8, 1), np.float32))):
        np.save(tmp_path / f"{name}_train_charged8_0_0.npy", a)
    for cutoff in (0.2, 0.5, 0.7):
        kw = dict(frame_0=0, frame_T=1, cutoff_rate=cutoff, batch_size=3, seed=1)
        jds = JDS.OfflineNBodyDataset("8_0_0", str(tmp_path), **kw)
        tds = TDS.OfflineNBodyDataset("8_0_0", str(tmp_path), device="cpu", **kw)
        _same_batch(jds.get_batch(), tds.get_batch())
        m = tds.edge_mask(tds.loc_0)
        assert 0 < int(m.sum()) < 3 * 8 * 7


def test_the_dataloader_is_the_ports_and_masks_its_scene(files):
    args = SimpleNamespace(model_type="segnn", dataloader_type="segnn_nbody_offline",
                           dataset_name="3_2_1", data_directory=str(files / "jax"),
                           target="pos_dt+vel", batch_size=3, frame_0=1, frame_T=4,
                           cutoff_rate=0.3, data_seed=2)
    tdl, jdl = TDL.create_dataloader(args, device="cpu"), JDL.create_dataloader(args)
    assert isinstance(tdl, TDL.OfflineSegnnDataLoader)
    assert isinstance(tdl.dataset, TDS.OfflineNBodyDataset) and tdl.get_num_nodes() == 10
    (ts, ty), (js, jy) = tdl.get_batch(), jdl.get_batch()
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    moved = ts.pos + torch.tensor([0.0, 0.0, 3.0]) * torch.arange(10.0)[:, None]
    from_port = tdl.preprocess_batch(type(ts)(moved, ts.vel, ts.force, ts.mass))
    want = np.asarray(jdl.preprocess_batch(type(js)(jnp.asarray(moved.numpy()), js.vel,
                                                    js.force, js.mass)))
    assert from_port.dtype == torch.bool
    np.testing.assert_array_equal(from_port.numpy(), want)
    assert tdl.postprocess_batch(ty) is ty
    valid = TDL.create_dataloader(args, partition="valid", device="cpu").dataset
    assert valid.partition == "valid" and len(valid) == 3
