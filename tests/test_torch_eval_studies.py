"""The port's GT-vs-GT studies (``evaluation/studies.py``) against the JAX
package's, and the two packages' initial-condition samplers against each
other.

The studies draw their own GT: here both packages' datasets return the same
list of numpy trajectory batches (the port's plain integrator, float64, on
the CPU) in the same order, so each statistic is computed from the same
arrays.  KL, JS, KS and Fisher are host-side numpy and scipy: they agree to
1e-12 relative (in practice exactly).

The cross-package test draws GT from each package's own sampler (the port's
``torch.Generator``, the JAX package's ``jax.random``), from fixed seeds, and
holds the 16 cross pairs to the class of the within-package floor: no parity
test that feeds both packages the same arrays can see a sampler that draws
from another distribution.
"""

import importlib
import json
import warnings

import numpy as np
import pytest
import torch

TPU = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu"
PORT = TPU + "_torch"
JST = importlib.import_module(TPU + ".evaluation.studies")
TST = importlib.import_module(PORT + ".evaluation.studies")
JOTF = importlib.import_module(TPU + ".data.gravity_otf")
TOTF = importlib.import_module(PORT + ".data.gravity_otf")
JM = importlib.import_module(TPU + ".metrics.macros")
TM = importlib.import_module(PORT + ".metrics.macros")
JKS = importlib.import_module(TPU + ".metrics.ks")
physics = importlib.import_module(PORT + ".core.physics")

RTOL = 1e-12
B, N, FRAMES = 6, 6, 30


def _batches(count, seed=0, frames=FRAMES):
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(count):
        loc, vel, force, mass = physics.sample_trajectory_batch(
            B, N, T=frames * 10, sample_freq=10, dtype=torch.float64, device="cpu",
            generator=gen)
        out.append(tuple(t.numpy() for t in (loc, vel, force, mass)))
    return out


def _serve(monkeypatch, batches):
    """Both dataset classes return ``batches`` in order from
    ``get_ground_truth_trajectories`` (each package from its own copy of the
    list); the JAX constructor's own first batch is a cheap stand-in."""
    queues = {"jax": list(batches), "torch": list(batches)}
    stand_in = {k: v for k, v in zip(("loc", "vel", "force", "mass"), batches[0])}

    def jax_gt(self, batch_size=None):
        return queues["jax"].pop(0)

    def torch_gt(self, batch_size=None):
        return tuple(torch.from_numpy(a.copy()) for a in queues["torch"].pop(0))

    monkeypatch.setattr(JOTF.GravityDatasetOtf, "generate_trajectories", lambda self, bs: stand_in)
    monkeypatch.setattr(JOTF.GravityDatasetOtf, "get_ground_truth_trajectories", jax_gt)
    monkeypatch.setattr(TOTF.GravityDatasetOtf, "get_ground_truth_trajectories", torch_gt)
    return queues


def _close(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b)
    elif isinstance(a, float):
        assert b == pytest.approx(a, rel=RTOL, abs=1e-300)
    else:
        assert a == b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hist_divergences_match(seed):
    rng = np.random.default_rng(seed)
    a, b = rng.normal(size=40), rng.normal(0.3, 1.2, size=35)
    for x, y in ((a, b), (a, a), (np.zeros(5), np.zeros(7))):
        got, want = TST._hist_divergences(x, y), JST._hist_divergences(x, y)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert TST.MACRO_KEYS == JST.MACRO_KEYS


def test_baseline_metamacros_matches(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    queues = _serve(monkeypatch, _batches(4))
    jds = JOTF.GravityDatasetOtf(batch_size=B, num_nodes=N, sim_length=FRAMES * 10,
                                 cache_data=False, seed=0)
    tds = TOTF.GravityDatasetOtf(batch_size=B, num_nodes=N, sim_length=FRAMES * 10,
                                 cache_data=False, seed=0, device="cpu")
    want = JST.baseline_metamacros(jds, num_batches=4, save_dir=str(tmp_path / "jax"))
    got = TST.baseline_metamacros(tds, num_batches=4, save_dir=str(tmp_path / "torch"))
    assert queues == {"jax": [], "torch": []}
    assert len(got["combined_pvalues"]) == 6
    _close(got, want)
    with open(tmp_path / "jax" / "baseline_metamacros.json") as f:
        jfile = json.load(f)
    with open(tmp_path / "torch" / "baseline_metamacros.json") as f:
        tfile = json.load(f)
    _close(tfile, jfile)


def test_compare_dt_matches(tmp_path, monkeypatch):
    """The default dt list at the base dt 0.01, sample_freq 10: the same
    variants (sim_length, sample_freq, frame spacing), the same warnings
    (none: every default dt divides the frame spacing 0.1), and the same KS
    on the same arrays."""
    monkeypatch.chdir(tmp_path)
    dts = (0.001, 0.002, 0.005, 0.01, 0.02, 0.05)
    queues = _serve(monkeypatch, _batches(1 + len(dts)))
    jds = JOTF.GravityDatasetOtf(batch_size=B, num_nodes=N, sim_length=FRAMES * 10,
                                 cache_data=False, seed=0)
    tds = TOTF.GravityDatasetOtf(batch_size=B, num_nodes=N, sim_length=FRAMES * 10,
                                 cache_data=False, seed=0, device="cpu")
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = JST.compare_dt(jds, save_dir=str(tmp_path / "jax"))
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = TST.compare_dt(tds, save_dir=str(tmp_path / "torch"))
    assert queues == {"jax": [], "torch": []}
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert list(got["results"]) == [str(d) for d in dts]
    for d, r in got["results"].items():
        assert r["sim_length"] // r["sample_freq"] == FRAMES
        assert abs(r["sample_freq"] * float(d) - 0.1) < 1e-9
    _close(got, want)
    with open(tmp_path / "torch" / "compare_dt.json") as f:
        _close(json.load(f), json.load(open(tmp_path / "jax" / "compare_dt.json")))


def test_compare_dt_warns_where_dt_does_not_divide_the_spacing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _serve(monkeypatch, _batches(3))
    jds = JOTF.GravityDatasetOtf(batch_size=B, num_nodes=N, sim_length=FRAMES * 10,
                                 cache_data=False, seed=0)
    tds = TOTF.GravityDatasetOtf(batch_size=B, num_nodes=N, sim_length=FRAMES * 10,
                                 cache_data=False, seed=0, device="cpu")
    with pytest.warns(UserWarning) as jw:
        want = JST.compare_dt(jds, dt_values=(0.03,))
    with pytest.warns(UserWarning) as tw:
        got = TST.compare_dt(tds, dt_values=(0.03,))
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert "confounded" in str(tw[0].message)
    _close(got, want)


def test_studies_main_runs_on_the_cpu(tmp_path, capsys):
    out = TST.main(["metamacros", "--device", "cpu", "--num-batches", "2", "--batch-size", "3",
                    "--sim-length", "200", "--out", str(tmp_path)])
    assert (tmp_path / "baseline_metamacros.json").exists()
    assert len(out["combined_pvalues"]) == 1 and 0 < out["combined_pvalues"][0] <= 1
    assert "ks_p_median" in capsys.readouterr().out


# ------------------------------------------- the two samplers' distributions

GT_B, GT_N, GT_LEN, GT_BATCHES = 16, 10, 1000, 4


def _floor(macros):
    """Combined p of every pair within one package's batches."""
    return [JKS.macro_ks_pvalues(macros[i], macros[j])[1]
            for i in range(len(macros)) for j in range(i + 1, len(macros))]


def test_the_two_samplers_draw_the_same_distribution(tmp_path, monkeypatch):
    """Four batches (B=16, N=10, 1000 substeps) from each package's own
    sampler on the CPU, fixed seeds: over the 16 cross pairs the median
    combined p is at least 0.05, the class of the within-package floors
    (printed if it fails).  Deterministic: the seeds are fixed."""
    monkeypatch.chdir(tmp_path)
    jds = JOTF.GravityDatasetOtf(batch_size=GT_B, num_nodes=GT_N, sim_length=GT_LEN,
                                 cache_data=False, seed=11)
    tds = TOTF.GravityDatasetOtf(batch_size=GT_B, num_nodes=GT_N, sim_length=GT_LEN,
                                 cache_data=False, seed=11, device="cpu")
    jm, tm = [], []
    for _ in range(GT_BATCHES):
        loc, vel, *_ = jds.get_ground_truth_trajectories()
        jm.append(JM.compute_all_macros(np.asarray(loc), np.asarray(vel)))
        loc, vel, *_ = tds.get_ground_truth_trajectories()
        assert loc.dtype == torch.float32 and loc.shape == (GT_B, GT_LEN // 10, GT_N, 3)
        tm.append(TM.compute_all_macros(loc.numpy(), vel.numpy()))
    cross = [JKS.macro_ks_pvalues(a, b)[1] for a in jm for b in tm]
    floors = {"jax": _floor(jm), "torch": _floor(tm)}
    assert len(cross) == 16
    assert np.median(cross) >= 0.05, (
        f"cross-package median combined p {np.median(cross):.3g} (all: {np.round(cross, 4)}); "
        f"within-package floors: JAX median {np.median(floors['jax']):.3g} "
        f"{np.round(floors['jax'], 4)}, port median {np.median(floors['torch']):.3g} "
        f"{np.round(floors['torch'], 4)}")
