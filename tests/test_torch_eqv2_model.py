"""The port's EquiformerV2 against the JAX package's, float64 on the CPU.

A small model (2 blocks, 8 sphere channels, 2 heads, edge channels 8) gets
the port's seeded float64 initialisation, carried to the JAX model with
``weights.params_to_jax`` (whose tree has the shapes of the JAX model's own
``init``, checked through ``jax.eval_shape``); both packages then run on the
same scene, made with numpy from a seed.

* Eval-mode forwards agree within 1e-9 of the largest output, on N=8 with a
  k=3 nearest-neighbour mask that is not symmetric (a transposed graph or a
  receiver-first message would show), for every option set of the JAX
  package's ``tests/test_models.py`` (gate, grid MLP with and without the
  separable activation, the plain S2 activation, ``use_m_share_rad``, no
  attention renorm), the three ``distance_function``s,
  ``share_atom_edge_embedding``, no atom-edge embeddings,
  ``equivariant_embedding``, ``weight_init="uniform"``, ``remat`` and a scene
  with ``charge``; and fully connected at N=5.
* Training mode with both dropout rates at 0 needs no generator and equals
  the JAX model's training mode.
* With ``equivariant_embedding`` a rotation of the inputs turns both output
  vectors within 1e-4 of the largest output: the SiLU on the S2 grid (18 x 36
  points) aliases the frequencies above the band it projects back to, so the
  model is equivariant only that far (the JAX package's own test allows
  2e-4); the reference's velocity lift is off by more than 1e-2.  A
  permutation of the bodies permutes the outputs within 1e-12.
* Gradients are finite through the dense diagonal's zero edge vector.
* ``layer_stats.capture`` gives the keys of the JAX trainer's
  ``_build_layer_stats_fn`` and its values within 1e-9.
* lmax other than 2 and mmax other than 1 raise.
"""

import functools
import importlib
from types import SimpleNamespace

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
JT = importlib.import_module(TPU + ".train.trainer")
tgraph = importlib.import_module(PORT + ".core.graph")
Scene = importlib.import_module(PORT + ".core.scene").Scene
tmodels = importlib.import_module(PORT + ".models")
weights = importlib.import_module(PORT + ".weights")
TLS = importlib.import_module(PORT + ".evaluation.layer_stats")

SMALL = dict(num_layers=2, sphere_channels=8, attn_hidden_channels=8, ffn_hidden_channels=8,
             num_heads=2, edge_channels=8)
OUT_RTOL, ROT_RTOL, PERM_RTOL, STATS_RTOL = 1e-9, 1e-4, 1e-12, 1e-9
B = 3
GRAPHS = {"fc5": (5, 4), "knn8": (8, 3)}  # N, k
CASES = {
    "default": {},
    "gate": dict(use_gate_act=True),
    "grid_mlp": dict(use_grid_mlp=True),
    "grid_mlp_s2": dict(use_grid_mlp=True, use_sep_s2_act=False),
    "s2": dict(use_sep_s2_act=False),
    "m_share_rad": dict(use_m_share_rad=True),
    "no_renorm": dict(use_attn_renorm=False),
    "gaussian": dict(distance_function="gaussian", max_radius=12.0),
    "exponential_decay": dict(distance_function="exponential_decay"),
    "shared_atom_edge": dict(share_atom_edge_embedding=True),
    "no_atom_edge": dict(use_atom_edge_embedding=False),
    "equivariant_embedding": dict(equivariant_embedding=True),
    "uniform_init": dict(weight_init="uniform"),
    "remat": dict(remat=True),
}


def _arrays(n, seed=0, b=B, charge=False):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(b, n, 3)) * (n / 5.0) ** (1 / 3)
    vel = rng.normal(size=(b, n, 3))
    force = rng.normal(size=(b, n, 3))
    mass = np.ones((b, n, 1))
    arrs = [pos, vel, force, mass]
    if charge:
        arrs.append(rng.integers(-1, 4, size=(b, n, 1)).astype(np.float64) + 0.7)
    return arrs


def _scenes(arrs):
    return JScene(*(jnp.asarray(a) for a in arrs)), Scene(*(torch.from_numpy(a) for a in arrs))


@functools.lru_cache(maxsize=None)
def _pair(graph="knn8", seed=0, **kw):
    """The JAX model, the port's model (seeded float64 init), its params as the
    JAX tree, and the masks."""
    n, k = GRAPHS[graph]
    cfg = {**SMALL, **kw}
    arrs = _arrays(n, seed)
    js, ts = _scenes(arrs)
    jm = jmodels.create_model("equiformer_v2", **cfg)
    torch.manual_seed(seed)
    tm = tmodels.create_model("equiformer_v2", device="cpu", dtype=torch.float64, **cfg).eval()
    params = weights.params_to_jax(tm.state_dict(), "equiformer_v2")
    return jm, params, tm, arrs, jgraph.knn_mask(js.pos, k), tgraph.knn_mask(ts.pos, k)


def _assert_rel(got, want, rtol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale, f"{what}: max abs err {err}, max |want| {scale}"


def _shapes(tree):
    return {jax.tree_util.keystr(p): tuple(np.shape(v))
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    jm, params, tm, arrs, jmask, tmask = _pair("knn8", **CASES[case])
    js, ts = _scenes(arrs)
    init = jax.eval_shape(jm.init, jax.random.PRNGKey(0), js, jmask)
    assert _shapes(init["params"]) == _shapes(params["params"]), case
    want = np.asarray(jm.apply(params, js, jmask))
    with torch.no_grad():
        got = tm(ts, tmask).numpy()
    assert got.shape == (B, 8, 6) and np.isfinite(got).all()
    _assert_rel(got, want, OUT_RTOL, case)


def test_knn8_mask_is_not_symmetric():
    *_, tmask = _pair("knn8")
    assert not torch.equal(tmask, tmask.transpose(1, 2))


def test_fully_connected_forward_matches_jax():
    jm, params, tm, arrs, jmask, tmask = _pair("fc5")
    js, ts = _scenes(arrs)
    with torch.no_grad():
        _assert_rel(tm(ts, tmask).numpy(), np.asarray(jm.apply(params, js, jmask)), OUT_RTOL)


def test_a_scene_with_charge_embeds_it():
    """``int(charge)`` truncates toward zero and is clipped to [0, 89]; the
    charges here (-0.3 .. 3.7) reach 0..3, not the mass's 1."""
    jm, params, tm, _, _, _ = _pair("knn8")
    arrs = _arrays(8, seed=4, charge=True)
    js, ts = _scenes(arrs)
    jmask, tmask = jgraph.knn_mask(js.pos, 3), tgraph.knn_mask(ts.pos, 3)
    with torch.no_grad():
        got = tm(ts, tmask).numpy()
        plain = tm(Scene(ts.pos, ts.vel, ts.force, ts.mass), tmask).numpy()
    _assert_rel(got, np.asarray(jm.apply(params, js, jmask)), OUT_RTOL, "charge")
    assert np.abs(got - plain).max() > 1e-6


def test_train_mode_without_dropout_equals_jax_train_mode():
    jm, params, tm, arrs, jmask, tmask = _pair("knn8", alpha_drop=0.0, drop_path_rate=0.0)
    js, ts = _scenes(arrs)
    want = np.asarray(jm.apply(params, js, jmask, True, rngs={"dropout": jax.random.PRNGKey(1)}))
    tm.train()
    assert not tmodels.needs_generator(tm)
    try:
        with torch.no_grad():
            got = tm(ts, tmask).numpy()
    finally:
        tm.eval()
    _assert_rel(got, want, OUT_RTOL, "train mode")


def _rotation(seed):
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    return q if np.linalg.det(q) > 0 else -q


def test_rotation_equivariance_with_the_equivariant_embedding():
    *_, tm, arrs, _, _ = _pair("knn8", equivariant_embedding=True)
    pos, vel, force, mass = (torch.from_numpy(a) for a in arrs)
    R = torch.from_numpy(_rotation(5))
    with torch.no_grad():
        out = tm(Scene(pos, vel, force, mass), tgraph.knn_mask(pos, 3))
        rot = Scene(pos @ R.T, vel @ R.T, force @ R.T, mass)
        out_r = tm(rot, tgraph.knn_mask(rot.pos, 3))
    want = torch.cat([out[..., :3] @ R.T, out[..., 3:] @ R.T], dim=-1)
    _assert_rel(out_r.numpy(), want.numpy(), ROT_RTOL, "rotation")


def test_the_reference_velocity_lift_is_not_rotation_equivariant():
    *_, tm, arrs, _, _ = _pair("knn8")
    pos, vel, force, mass = (torch.from_numpy(a) for a in arrs)
    R = torch.from_numpy(_rotation(5))
    with torch.no_grad():
        out = tm(Scene(pos, vel, force, mass), tgraph.knn_mask(pos, 3))
        out_r = tm(Scene(pos @ R.T, vel @ R.T, force @ R.T, mass), tgraph.knn_mask(pos @ R.T, 3))
    want = torch.cat([out[..., :3] @ R.T, out[..., 3:] @ R.T], dim=-1)
    assert (out_r - want).abs().max() > 1e-2 * want.abs().max()


def test_permutation_equivariance():
    *_, tm, arrs, _, _ = _pair("knn8")
    perm = torch.tensor([3, 0, 7, 1, 6, 2, 5, 4])
    pos, vel, force, mass = (torch.from_numpy(a) for a in arrs)
    with torch.no_grad():
        out = tm(Scene(pos, vel, force, mass), tgraph.knn_mask(pos, 3))
        moved = Scene(pos[:, perm], vel[:, perm], force[:, perm], mass[:, perm])
        out_p = tm(moved, tgraph.knn_mask(moved.pos, 3))
    _assert_rel(out_p.numpy(), out[:, perm].numpy(), PERM_RTOL, "permutation")


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_gradients_are_finite_through_the_zero_diagonal(graph):
    *_, tm, arrs, _, tmask = _pair(graph)
    pos, vel, force, mass = (torch.from_numpy(a).clone().requires_grad_(True) for a in arrs)
    out = tm(Scene(pos, vel, force, mass), tmask)
    (out**2).sum().backward()
    for t in (pos, vel):
        assert torch.isfinite(t.grad).all() and t.grad.abs().max() > 0
    assert all(torch.isfinite(p.grad).all() for p in tm.parameters())
    tm.zero_grad(set_to_none=True)


@pytest.mark.parametrize("case", ["default", "equivariant_embedding", "shared_atom_edge"])
def test_layer_stats_match_the_jax_trainers(case):
    jm, params, tm, arrs, jmask, tmask = _pair("fc5", **CASES[case])
    js, ts = _scenes(arrs)
    stand_in = SimpleNamespace(model=jm, num_neighbors=4, _data_masks=False)
    want = {k: float(v) for k, v in JT.Trainer._build_layer_stats_fn(stand_in)(params, js).items()}
    got = {k: float(v) for k, v in TLS.capture(tm, ts, tmask).items()}
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k] == pytest.approx(w, rel=STATS_RTOL, abs=1e-300), k


def test_the_models_sizes_and_refusals():
    *_, tm, _, _, _ = _pair("knn8")
    assert tm.get_model_size() == 8 and len(tm.blocks) == 2
    assert type(tm.blocks[0].SO2Attention_0.act).__name__ == "SeparableS2Act"
    with pytest.raises(NotImplementedError, match="lmax=2"):
        tmodels.create_model("equiformer_v2", device="cpu", lmax=3, **SMALL)
    with pytest.raises(NotImplementedError, match="mmax=1"):
        tmodels.create_model("equiformer_v2", device="cpu", mmax=2, **SMALL)
    with pytest.raises(ValueError):
        tmodels.create_model("equiformer_v2", device="cpu", distance_function="cosine", **SMALL)
