"""The training data and the config of the port against the JAX package's.

Data (``data/gravity_otf.py``, ``data/dataloaders.py``): for the same seed the
frame-pair order equals the JAX dataset's over a whole GT batch and into the
next (both datasets fed the same trajectory batch); ``_build_target`` equals
the JAX one on the same arrays for all six targets, with int frames and with
a gathered index of frames; the ``.npz`` cache round-trips and its folder name
equals the JAX package's; the metadata dict equals the JAX package's and
``from_metadata`` round-trips; the valid partition never caches and is
reseeded; the offline loader refuses a directory without its files and
loads one with them.

Config (``utils/config.py``): the port's own defaults equal
``default_config.yaml`` as the JAX package reads it, ``parse_args`` gives the
same flat namespace for the same argv, and the resolved config the port
writes reads back to the same dict through the JAX package's YAML reader.
"""

import importlib
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

TPU = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu"
PORT = TPU + "_torch"
JOTF = importlib.import_module(TPU + ".data.gravity_otf")
JDL = importlib.import_module(TPU + ".data.dataloaders")
JCFG = importlib.import_module(TPU + ".utils.config")
TOTF = importlib.import_module(PORT + ".data.gravity_otf")
TDL = importlib.import_module(PORT + ".data.dataloaders")
TCFG = importlib.import_module(PORT + ".utils.config")

TARGETS = ("pos", "force", "pos_dt+vel_dt", "pos_dt+vel", "pos+vel", "pos_com+vel")
B, T, N = 2, 30, 5


def _traj(seed=0, frame_marked=False):
    rng = np.random.default_rng(seed)
    traj = {k: rng.normal(size=(B, T, N, 3)) for k in ("loc", "vel", "force")}
    if frame_marked:  # loc[b, t] = t: a drawn scene names its frame
        traj["loc"] = np.broadcast_to(np.arange(T, dtype=np.float64)[None, :, None, None],
                                      (B, T, N, 3)).copy()
    traj["mass"] = np.ones((B, N, 1))
    return traj


def _feed(monkeypatch, traj):
    """Both dataset classes generate ``traj`` (as their arrays) from now on."""
    monkeypatch.setattr(JOTF.GravityDatasetOtf, "generate_trajectories",
                        lambda self, bs: {k: jnp.asarray(v) for k, v in traj.items()})
    monkeypatch.setattr(TOTF.GravityDatasetOtf, "generate_trajectories",
                        lambda self, bs: {k: torch.from_numpy(v.copy()) for k, v in traj.items()})


KW = dict(batch_size=B, sim_length=T * 10, num_nodes=N, double_precision=True, cache_data=False)


@pytest.mark.parametrize("seed", [0, 11])
def test_frame_order_equals_jax_into_the_next_batch(monkeypatch, seed):
    _feed(monkeypatch, _traj(frame_marked=True))
    jds = JOTF.GravityDatasetOtf(seed=seed, **KW)
    tds = TOTF.GravityDatasetOtf(seed=seed, device="cpu", **KW)
    draws = T - 1 + 20  # a whole batch of pairs, then into the next
    jframes = [int(jds.get_batch()[0].pos[0, 0, 0]) for _ in range(draws)]
    tframes = [int(tds.get_batch()[0].pos[0, 0, 0]) for _ in range(draws)]
    assert tframes == jframes
    assert sorted(tframes[:T - 1]) == list(range(T - 1))


@pytest.mark.parametrize("target", TARGETS)
def test_build_target_matches_jax(monkeypatch, target):
    traj = _traj(1)
    _feed(monkeypatch, traj)
    jds = JOTF.GravityDatasetOtf(target=target, seed=0, **KW)
    tds = TOTF.GravityDatasetOtf(target=target, seed=0, device="cpu", **KW)
    jt = {k: jnp.asarray(v) for k, v in traj.items()}
    tt = {k: torch.from_numpy(v) for k, v in traj.items()}
    frames = [3, 17, 0]
    idx = torch.tensor(frames)
    gathered = tds._build_target(tt, idx, idx + 1)  # [B, k, N, 3k]: the prefetch's form
    for i, f in enumerate(frames):
        want = np.asarray(jds._build_target(jt, f, f + 1))
        for got in (tds._build_target(tt, f, f + 1).numpy(), gathered[:, i].numpy()):
            _same(got, want, target)


def _same(got, want, target):
    """Equal; pos_com's centre-of-mass mean sums in another order than XLA's, so
    there within a few ulp of the largest value."""
    if target == "pos_com+vel":
        np.testing.assert_allclose(got, want, rtol=0, atol=4e-16 * np.abs(want).max())
    else:
        np.testing.assert_array_equal(got, want)


def test_batches_hold_the_targets_of_their_frames(monkeypatch):
    traj = _traj(2)
    _feed(monkeypatch, traj)
    jds = JOTF.GravityDatasetOtf(seed=4, **KW)
    tds = TOTF.GravityDatasetOtf(seed=4, device="cpu", **KW)
    for _ in range(20):
        (js, jy), (ts, ty) = jds.get_batch(), tds.get_batch()
        for a, b in ((ts.pos, js.pos), (ts.vel, js.vel), (ts.force, js.force),
                     (ts.mass, js.mass), (ty, jy)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cache_round_trips_and_is_named_as_jax(tmp_path):
    kw = dict(batch_size=B, sim_length=60, num_nodes=N, cache_dir=str(tmp_path / "sims"),
              seed=5, device="cpu")
    first = TOTF.GravityDatasetOtf(cache_data=True, **kw)
    first.get_batch()
    folder = first._cache_folder()
    assert sorted(os.listdir(folder)) == [".claim-0", "0.npz"]
    again = TOTF.GravityDatasetOtf(use_cached=True, cache_data=False, **kw)
    again.get_batch()
    assert again.cache_index == 1
    for k, v in first._traj.items():
        assert torch.equal(again._traj[k], v)
    jkw = {k: v for k, v in kw.items() if k != "device"}
    jds = JOTF.GravityDatasetOtf(cache_data=False, **jkw)
    assert os.path.basename(folder) == os.path.basename(jds._cache_folder())
    assert first._cache_folder() == jds._cache_folder()


def test_ground_truth_never_reads_the_cache(tmp_path, monkeypatch):
    kw = dict(batch_size=B, sim_length=60, num_nodes=N, cache_dir=str(tmp_path), seed=6,
              device="cpu")
    TOTF.GravityDatasetOtf(cache_data=True, **kw).get_batch()
    ds = TOTF.GravityDatasetOtf(use_cached=True, cache_data=False, **kw)
    monkeypatch.setattr(ds, "_load_batch_from_cache", lambda i: pytest.fail("read the cache"))
    loc, vel, force, mass = ds.get_ground_truth_trajectories()
    assert loc.shape == (B, 6, N, 3) and ds.cache_index == 0


def test_metadata_equals_jax_and_round_trips():
    kw = dict(dataset_name="nbody_x", target="pos+vel", batch_size=3, sim_length=57,
              sample_freq=5, noise_var=0.1, num_nodes=7, vel_norm=1e-3, interaction_strength=1.5,
              dt=0.02, softening=0.3, center_of_mass=True, cache_data=False, seed=1)
    want = JOTF.GravityDatasetOtf(**kw).get_serializable_attributes()
    got = TOTF.GravityDatasetOtf(device="cpu", **kw).get_serializable_attributes()
    assert got == want
    again = TOTF.GravityDatasetOtf.from_metadata(got, device="cpu")
    assert again.get_serializable_attributes() == got
    assert TOTF.GravityDatasetOtf.from_metadata(got, n_bodies=9, device="cpu").num_nodes == 9


def _loader_args(**kw):
    args, _ = TCFG.parse_args([])
    for k, v in kw.items():
        setattr(args, k, v)
    return args


@pytest.mark.parametrize("data_seed", [None, 3])
@pytest.mark.parametrize("model_path", [None, "x.ckpt"])
def test_partitions_as_jax(data_seed, model_path, tmp_path, monkeypatch):
    args = _loader_args(data_seed=data_seed, model_path=model_path, sim_length=50, batch_size=2)
    for name in ("torch", "jax"):
        (tmp_path / name).mkdir()
    for part in ("train", "valid"):
        # each package caches its train partition under its own working directory
        monkeypatch.chdir(tmp_path / "torch")
        t = TDL.create_dataloader(args, partition=part, device="cpu").dataset
        t.get_batch()  # the JAX dataset loads its first batch in its constructor
        monkeypatch.chdir(tmp_path / "jax")
        j = JDL.create_dataloader(args, partition=part).dataset
        assert (t.cache_data, t.use_cached, t.cache_index, t._explicit_seed) == (
            j.cache_data, j.use_cached, j.cache_index, j._explicit_seed)
    valid = TDL.create_dataloader(args, partition="valid", device="cpu").dataset
    assert not valid.cache_data and not valid.use_cached
    if data_seed is not None:
        assert valid._explicit_seed == data_seed + 7919


def test_offline_loader_is_refused(tmp_path):
    """Without its files the offline loader refuses, naming the file it
    misses; with them it is the port's loader."""
    args = _loader_args(dataloader_type="segnn_nbody_offline", data_directory=str(tmp_path),
                        dataset_name="5_0_0")
    with pytest.raises(FileNotFoundError, match="loc_train_charged5_0_0.npy"):
        TDL.create_dataloader(args, device="cpu")
    for name in ("loc", "vel"):
        np.save(tmp_path / f"{name}_train_charged5_0_0.npy", np.zeros((2, 50, 5, 3), np.float32))
    np.save(tmp_path / "charges_train_charged5_0_0.npy", np.ones((2, 5, 1), np.float32))
    loader = TDL.create_dataloader(args, device="cpu")
    assert isinstance(loader, TDL.OfflineSegnnDataLoader) and loader.get_num_nodes() == 5


def test_default_config_equals_jax():
    assert TCFG.load_config() == JCFG.load_config(JCFG.DEFAULT_CONFIG_PATH)


ARGVS = [
    [],
    ["--trainer.learning_rate", "1", "--dataloader.batch_size", "16",
     "--dataloader.gravity_dataset.sim_length", "2500",
     "--dataloader.gravity_dataset.num_atoms", "100", "--trainer.clip_gradients_norm", "1",
     "--model.num_layers", "2", "--trainer.run_name", "n100_resume", "--dataloader.seed", "3",
     "--trainer.model_path", "runs/x/model.ckpt", "--trainer.self_feed_limit_steps", "249"],
    ["--main.model_type", "painn"],
    ["--main.dataloader_type", "segnn_nbody_offline", "--dataloader.offline_dataset.frame_0=20"],
    ["--trainer.validation.do_validation=true", "--trainer.validation.validation_frequency",
     "2", "--trainer.unknown_key", "3", "--trainer.discard_nan_gradients", "yes"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_parse_args_equals_jax(argv, tmp_path):
    jns, jcfg = JCFG.parse_args(argv)
    tns, tcfg = TCFG.parse_args(argv)
    assert vars(tns) == vars(jns)
    assert {k: type(v) for k, v in vars(tns).items()} == {k: type(v) for k, v in vars(jns).items()}
    assert tcfg == jcfg
    TCFG.save_config(tcfg, str(tmp_path))
    assert JCFG.load_config(str(tmp_path / "config.yaml")) == tcfg


def test_config_files_json_and_yaml(tmp_path, monkeypatch):
    cfg = JCFG.load_config(JCFG.DEFAULT_CONFIG_PATH)
    cfg["trainers"]["trainer_nbody"]["learning_rate"] = 0.25
    cfg["dataloaders"]["egnn_mc_nbody"]["gravity_dataset"]["vel_norm"] = 1e-20
    path = tmp_path / "c.json"
    path.write_text(json.dumps(cfg))
    tns, tcfg = TCFG.parse_args(["--config", str(path)])
    assert tcfg == cfg and tns.learning_rate == 0.25 and tns.vel_norm == 1e-20
    TCFG.save_config(cfg, str(tmp_path))
    yaml_path = str(tmp_path / "config.yaml")
    assert vars(TCFG.parse_args(["--config", yaml_path])[0]) == vars(
        JCFG.parse_args(["--config", yaml_path])[0])
    monkeypatch.setitem(sys.modules, "yaml", None)  # as where PyYAML is not installed
    with pytest.raises(SystemExit, match="PyYAML"):
        TCFG.parse_args(["--config", yaml_path])


def test_wrong_field_types_raise():
    with pytest.raises(ValueError, match="batch_size"):
        TCFG.parse_args(["--dataloader.batch_size", "1.5"])
    with pytest.raises(ValueError, match="com_loss"):
        TCFG.parse_args(["--trainer.com_loss", "maybe"])
