"""Training on the offline charged systems: the port's trainer against the JAX Trainer.

Both packages read one small dataset the JAX package wrote (``5_0_0`` and
``3_2_1``), with the same data seed, so their batches are bitwise the same
(``tests/test_torch_offline_data.py``), and each trains on the mask its
batches carry.

* One Trainer step of SEGNN (cutoff rate 0), of EGNN-MC under cutoff-rate
  masks (0.3, and 0.95, where most receivers have no sender), and of GMN on
  ``3_2_1`` (three isolated bodies, two sticks and a hinge, the charges as
  inputs): from the same float64 parameters (crossing through ``weights.py``)
  every parameter agrees within 1e-12 of the model's largest parameter value,
  and every tensor's update within 1e-9 of its largest update plus two
  float64 ulps of the parameter, the tolerances of the families' own step
  tests.  The GMN case failed while the trainer's cast dropped the charge.
* Validation on the valid split's own batches and masks gives the JAX
  Trainer's losses within 1e-12 (EGNN-MC's through the edge kernel's
  wrapper, the plain masked means on the CPU).
* The data mask, never the kNN mask, reaches the layer statistics and
  PONITA's calibration; the cast keeps the charge; an offline run's
  self-feed raises a ``ValueError`` naming the reason, which ``train()``
  reports and survives; ``cli train`` trains on the offline data on the CPU.
"""

import importlib
import json
import os

import numpy as np
import pytest
import torch

TPU = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu"
PORT = TPU + "_torch"
JD = importlib.import_module(TPU + ".data.offline_datagen")
JT = importlib.import_module(TPU + ".train.trainer")
JCFG = importlib.import_module(TPU + ".utils.config")
TT = importlib.import_module(PORT + ".train.trainer")
TCFG = importlib.import_module(PORT + ".utils.config")
TDL = importlib.import_module(PORT + ".data.dataloaders")
TDS = importlib.import_module(PORT + ".data.offline_dataset")
tmodels = importlib.import_module(PORT + ".models")
weights = importlib.import_module(PORT + ".weights")
cli = importlib.import_module(PORT + ".cli")
Scene = importlib.import_module(PORT + ".core.scene").Scene

STEP_RTOL, UPDATE_RTOL, VALID_RTOL = 1e-12, 1e-9, 1e-12
ULP = 2.0**-52

CASES = {
    "segnn": (["--main.model_type", "segnn", "--model.num_layers", "2",
               "--model.hidden_features", "16"], "5_0_0", 0.0),
    "egnn_mc_cutoff_0.3": (["--main.model_type", "egnn_mc", "--model.num_layers", "2",
                            "--model.hidden_node_dim", "16", "--model.hidden_edge_dim", "16",
                            "--model.hidden_coord_dim", "16"], "5_0_0", 0.3),
    "egnn_mc_cutoff_0.95": (["--main.model_type", "egnn_mc", "--model.num_layers", "2",
                             "--model.hidden_node_dim", "16", "--model.hidden_edge_dim", "16",
                             "--model.hidden_coord_dim", "16"], "5_0_0", 0.95),
    "gmn_3_2_1": (["--main.model_type", "gmn", "--model.num_layers", "2",
                   "--model.hidden_features", "8", "--model.n_isolated", "3",
                   "--model.n_stick", "2", "--model.n_hinge", "1"], "3_2_1", 0.0),
}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("offline_data")
    for comp in ((5, 0, 0), (3, 2, 1)):
        JD.generate_offline_dataset(str(root), *comp, num_train=6, num_valid=4, num_test=2,
                                    length=400, length_test=400, sample_freq=40, seed=0)
    return str(root)


def _argv(case, data_dir, *extra, precision="double"):
    model, name, cutoff = CASES[case]
    return model + [
        "--main.dataloader_type", "segnn_nbody_offline", "--dataloader.batch_size", "3",
        "--dataloader.offline_dataset.dataset_name", name,
        "--dataloader.offline_dataset.data_directory", data_dir,
        "--dataloader.offline_dataset.frame_0", "2", "--dataloader.offline_dataset.frame_T", "6",
        "--dataloader.offline_dataset.cutoff_rate", str(cutoff), "--dataloader.seed", "5",
        "--trainer.precision_mode", precision, "--trainer.steps_per_epoch", "1",
        "--trainer.test_macros_every", "1000", "--trainer.validation.do_validation=true",
        *extra]


def _port_trainer(argv, run_name):
    args, cfg = TCFG.parse_args(argv + ["--trainer.run_name", run_name])
    torch.manual_seed(0)
    model = tmodels.create_model(args.model_type, device="cpu", dtype=torch.float64,
                                 **args.model_kwargs)
    return TT.Trainer(model, TDL.create_dataloader(args, device="cpu").dataset, args,
                      resolved_config=cfg,
                      valid_dataset=TDL.create_dataloader(args, "valid", device="cpu").dataset,
                      device="cpu")


@pytest.fixture(scope="module", params=list(CASES))
def pair(request, data_dir, tmp_path_factory):
    """One training step and one validation of each package from the same
    float64 parameters on the same batches."""
    case = request.param
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp(case)
    argv = _argv(case, data_dir)
    try:
        for name in ("jax", "torch"):
            (root / name).mkdir()
        mp.chdir(root / "jax")
        jargs, jcfg = JCFG.parse_args(argv + ["--trainer.run_name", "jax"])
        jt = JT.create_trainer_from_args(jargs, resolved_config=jcfg)
        mp.chdir(root / "torch")
        tt = _port_trainer(argv, "torch")
        assert tt._data_masks and jt._data_masks
        init = {k: v.clone() for k, v in tt.model.state_dict().items()}
        jt.params = weights.params_to_jax(tt.model.state_dict())
        jt.opt_state = jt.tx.init(jt.params)
        logs = {}
        for name, t in (("jax", jt), ("torch", tt)):
            mp.chdir(root / name)
            t.train_one_epoch()
            t.step_count = 1
            logs[name] = t.validate_one_epoch(num_batches=2)
        yield dict(case=case, jt=jt, tt=tt, init=init, logs=logs)
    finally:
        mp.undo()


def test_offline_step_matches_jax(pair):
    model, family = pair["tt"].model, pair["tt"].args.model_type
    want = weights.params_from_jax(pair["jt"].params, family)
    scale = max(v.abs().max().item() for v in want.values())
    moved = 0
    for name, p in model.named_parameters():
        got, w, b = p.detach(), want[name], pair["init"][name]
        assert (got - w).abs().max().item() <= STEP_RTOL * scale, name
        du, dw = got - b, w - b
        allowed = UPDATE_RTOL * dw.abs().max() + 2 * ULP * b.abs()
        assert bool(((du - dw).abs() <= allowed).all()), f"{name}'s update"
        moved += bool(dw.abs().max() > 0)
    assert moved > 0


def test_validation_on_the_valid_split_matches_jax(pair):
    jlog, tlog = pair["logs"]["jax"], pair["logs"]["torch"]
    assert sorted(tlog) == sorted(jlog)
    for k, v in jlog.items():
        assert abs(tlog[k] - v) <= VALID_RTOL * max(abs(v), 1e-300), k
    assert np.isfinite(tlog["valid/loss"])


def test_the_cast_keeps_the_charge():
    """The training step casts the whole scene, its charges included, to the
    run's dtype before the model reads it."""
    seen = []

    class Probe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones((), dtype=torch.float64))

        def forward(self, scene, mask):
            seen.append(scene)
            return torch.cat([scene.pos, scene.vel], dim=-1) * self.w * scene.charge

    args, _ = TCFG.parse_args([])
    model = Probe()
    optim = TT.create_optimizer(model.parameters(), learning_rate=0.1, model_size=8)
    step, _ = TT.make_train_step(model, optim, TT.build_loss_fn(args), ["pos_dt", "vel"], 1,
                                 torch.float64)
    q = torch.tensor([[[1.0], [-1.0]]])
    s = Scene(pos=torch.ones(1, 2, 3), vel=torch.ones(1, 2, 3), force=torch.zeros(1, 2, 3),
              mass=torch.ones(1, 2, 1), charge=q)
    step(s, torch.zeros(1, 2, 6))
    assert seen[0].charge is not None and seen[0].charge.dtype == torch.float64
    assert torch.equal(seen[0].charge, q.double()) and seen[0].pos.dtype == torch.float64


def _recording(ds):
    """Wraps ``ds.get_batch`` to keep every batch it hands out."""
    drawn, get = [], ds.get_batch

    def get_batch():
        drawn.append(get())
        return drawn[-1]

    ds.get_batch = get_batch
    return drawn


def test_layer_stats_read_the_data_mask(data_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tt = _port_trainer(_argv("egnn_mc_cutoff_0.3", data_dir, "--trainer.debug_layer_stats_every",
                             "1"), "stats")
    drawn = _recording(tt.dataset)
    seen = []
    capture = TT.layer_stats.capture
    monkeypatch.setattr(TT.layer_stats, "capture",
                        lambda m, s, mask: seen.append(mask) or capture(m, s, mask))
    tt.train_one_epoch()
    assert len(seen) == 1 and torch.equal(seen[0], drawn[0][2])
    assert not torch.equal(seen[0], TT.G.knn_mask(drawn[0][0].pos, tt.num_neighbors))
    assert os.path.exists(os.path.join(tt.save_dir_path, "layer_stats.jsonl"))


def test_ponita_calibrates_on_the_data_mask(data_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args, cfg = TCFG.parse_args(_argv("segnn", data_dir) + [
        "--main.model_type", "ponita", "--model.num_layers", "1", "--model.hidden_features",
        "8", "--model.num_ori", "4", "--model.basis_dim", "8",
        "--dataloader.offline_dataset.cutoff_rate", "0.5"])
    ds = TDL.create_dataloader(args, device="cpu").dataset
    drawn = _recording(ds)
    seen = []
    calibrate = TT.calibrate_params
    monkeypatch.setattr(TT, "calibrate_params",
                        lambda m, s, mask: seen.append((s, mask)) or calibrate(m, s, mask))
    model = tmodels.create_model("ponita", device="cpu", dtype=torch.float64, **args.model_kwargs)
    TT.Trainer(model, ds, args, resolved_config=cfg, device="cpu")
    assert len(drawn) == 1 and len(seen) == 1
    scene, mask = seen[0]
    assert torch.equal(mask, drawn[0][2]) and int(mask.sum()) == 3 * 10
    assert torch.equal(scene.charge, drawn[0][0].charge.double())


def test_offline_self_feed_raises_and_training_goes_on(data_dir, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    argv = _argv("gmn_3_2_1", data_dir, "--trainer.test_macros_every", "1",
                 "--trainer.train_steps", "1", "--trainer.save_model_every", "1",
                 "--trainer.validation.do_validation=false")
    tt = _port_trainer(argv, "sf")
    with pytest.raises(ValueError, match="ground-truth trajectories"):
        tt.run_self_feed_eval()
    tt.train()
    out = capsys.readouterr().out
    assert "Couldn't run self-feed" in out and "test_macros_every" in out
    assert tt.step_count == 1 and os.path.exists(os.path.join(tt.save_dir_path, "model.ckpt"))


def test_cli_train_on_offline_data(data_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cli.main(["train", "--device", "cpu"] + _argv(
        "egnn_mc_cutoff_0.3", data_dir, "--trainer.steps_per_epoch", "2",
        "--trainer.train_steps", "2", "--trainer.save_model_every", "1",
        "--trainer.run_name", "cli", precision="single"))
    run = os.path.join("runs", "egnn_mc", os.listdir(os.path.join("runs", "egnn_mc"))[0])
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["train/loss"] for r in recs if "train/loss" in r]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert any("valid/loss" in r for r in recs)
    with open(os.path.join(run, "5_0_0_dataset", "metadata.json")) as f:
        meta = json.load(f)
    assert meta["partition"] == "train" and meta["cutoff_rate"] == 0.3
    assert isinstance(TDL.create_dataloader(TCFG.parse_args(_argv("segnn", data_dir))[0],
                                            device="cpu").dataset, TDS.OfflineNBodyDataset)
