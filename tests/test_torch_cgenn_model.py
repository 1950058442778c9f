"""The port's CGENN against the JAX package's, float64 on the CPU.

A small model (2-3 layers, width 6-8) gets the port's seeded float64
initialisation, carried to the JAX model with ``weights.params_to_jax``; both
packages then run on the same scene, made with numpy from a seed, with masses
other than one.

* Forwards agree within 1e-10 of the largest output, on N=8 with a k=3
  nearest-neighbour mask that is not symmetric (the message ``h_i - h_j``
  and the mean over senders would show reversed) and fully connected at
  N=5, with the default options, without the residual, at another metric
  seed, with ``remat``, without the product's normalisation (through the
  classes: ``create_model`` reads None as the default in both packages),
  and with a charge that differs from the mass (the charge is read first).
* ``remat`` gives the plain path's outputs and gradients, bit for bit, with
  the same parameter tree.
* CGENN is only near-equivariant: its algebra's signature is the frozen
  metric's eigenvalues, not (1, 1, 1).  A rotation of the scene leaves the
  same residual in both packages (within 1e-9 of the largest output), and
  it is not zero.  A shift changes nothing (1e-12) and a permutation of the
  bodies permutes the output (1e-12).
* Its float32 gradients round as the JAX model's do: the largest error
  against float64 (each tensor relative to its largest gradient) within 4x
  of the JAX model's, the float64 gradients of both within 1e-10.
* CGENN has no dropout: training mode equals eval mode and needs no
  generator.  ``layer_stats.capture`` gives the JAX trainer's keys and values
  within 1e-9.
"""

import importlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

TPU = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu"
PORT = TPU + "_torch"
jgraph = importlib.import_module(TPU + ".core.graph")
JScene = importlib.import_module(TPU + ".core.scene").Scene
jmodels = importlib.import_module(TPU + ".models")
JC = importlib.import_module(TPU + ".models.cgenn")
JT = importlib.import_module(TPU + ".train.trainer")
tgraph = importlib.import_module(PORT + ".core.graph")
Scene = importlib.import_module(PORT + ".core.scene").Scene
tmodels = importlib.import_module(PORT + ".models")
TC = importlib.import_module(PORT + ".models.cgenn")
weights = importlib.import_module(PORT + ".weights")
TLS = importlib.import_module(PORT + ".evaluation.layer_stats")

SMALL = dict(hidden_features=6, num_layers=2)
OUT_RTOL, RESIDUAL_ATOL, EQUIV_RTOL, STATS_RTOL = 1e-10, 1e-9, 1e-12, 1e-9
B = 3
GRAPHS = {"fc5": (5, 4), "knn8": (8, 3)}  # N, k
CASES = {
    "default": {},
    "no_residual": dict(residual=False),
    "metric_seed_3": dict(metric_seed=3),
    "remat_l3": dict(remat=True, num_layers=3, hidden_features=8),
}


def _arrays(n, seed=0, b=B, charge=False):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(b, n, 3)) * (n / 5.0) ** (1 / 3)
    arrs = [pos, rng.normal(size=(b, n, 3)), np.zeros((b, n, 3)),
            rng.uniform(0.5, 2.0, size=(b, n, 1))]
    if charge:
        arrs.append(rng.choice([-1.0, 1.0], size=(b, n, 1)))
    return arrs


def _model(kw, seed=0):
    torch.manual_seed(seed)
    model = tmodels.create_model("cgenn", device="cpu", dtype=torch.float64, **{**SMALL, **kw})
    with torch.no_grad():  # move the gates' and norms' ones and zeros off their init
        for name, p in model.named_parameters():
            if name.endswith((".a", ".b", ".bias")):
                p.add_(0.2 * torch.randn_like(p))
    return model.eval()


def _scenes(arrs):
    return (JScene(*(jnp.asarray(a) for a in arrs)), Scene(*(torch.from_numpy(a) for a in arrs)))


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max()


def _both(model, kw, arrs, k):
    jm = jmodels.create_model("cgenn", **{**SMALL, **kw})
    tree = weights.params_to_jax(model.state_dict())
    js, ts = _scenes(arrs)
    want = np.asarray(jm.apply(tree, js, jgraph.knn_mask(js.pos, k)))
    with torch.no_grad():
        got = model(ts, tgraph.knn_mask(ts.pos, k)).numpy()
    return got, want


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case, graph):
    n, k = GRAPHS[graph]
    got, want = _both(_model(CASES[case]), CASES[case], _arrays(n, seed=n), k)
    assert got.shape == (B, n, 6) and np.isfinite(got).all()
    assert _rel(got, want) <= OUT_RTOL


def test_without_the_products_normalisation():
    """``normalization_init=None`` (which ``create_model`` reads as "the
    default" in both packages) through the classes themselves."""
    kw = dict(SMALL, normalization_init=None)
    torch.manual_seed(0)
    model = TC.CGENN(**kw).double().eval()
    assert not any("_Normalization" in k for k in model.state_dict())
    arrs = _arrays(8, seed=12)
    js, ts = _scenes(arrs)
    want = np.asarray(JC.CGENN(**kw).apply(weights.params_to_jax(model.state_dict()), js,
                                           jgraph.knn_mask(js.pos, 3)))
    with torch.no_grad():
        got = model(ts, tgraph.knn_mask(ts.pos, 3)).numpy()
    assert _rel(got, want) <= OUT_RTOL


def test_the_charge_is_read_before_the_mass():
    arrs = _arrays(6, seed=11, charge=True)
    model = _model({})
    got, want = _both(model, {}, arrs, 3)
    assert _rel(got, want) <= OUT_RTOL
    no_charge, _ = _both(model, {}, arrs[:4], 3)
    assert _rel(no_charge, got) > 1e-6


def test_remat_gives_the_plain_outputs_and_gradients():
    _, ts = _scenes(_arrays(8, seed=2))
    mask = tgraph.knn_mask(ts.pos, 3)
    plain, remat = _model(dict(num_layers=3)), _model(dict(num_layers=3, remat=True))
    assert list(plain.state_dict()) == list(remat.state_dict())
    outs, grads = [], []
    for m in (plain, remat):
        m.train()
        out = m(ts, mask)
        out.square().sum().backward()
        outs.append(out.detach())
        grads.append([p.grad for p in m.parameters()])
    assert torch.equal(outs[0], outs[1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    assert all(torch.isfinite(g).all() for g in grads[0])


def _rotation(seed):
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    return q if np.linalg.det(q) > 0 else -q


def test_rotation_residual_equals_the_jax_models():
    """Both packages leave the same residual, ``out(R x) - R out(x)``."""
    model = _model(dict(num_layers=3, hidden_features=8))
    kw = dict(num_layers=3, hidden_features=8)
    arrs = _arrays(5, seed=3)
    R = _rotation(4)
    moved = [arrs[0] @ R.T, arrs[1] @ R.T, arrs[2], arrs[3]]
    out_t, out_j = _both(model, kw, arrs, 4)
    rot_t, rot_j = _both(model, kw, moved, 4)

    def turned(o):
        return np.concatenate([o[..., :3] @ R.T, o[..., 3:] @ R.T], axis=-1)

    res_t, res_j = rot_t - turned(out_t), rot_j - turned(out_j)
    scale = np.abs(out_j).max()
    assert np.abs(res_t - res_j).max() <= RESIDUAL_ATOL * scale
    assert np.abs(res_j).max() > 1e3 * RESIDUAL_ATOL * scale  # near-equivariant only


def test_translation_and_permutation():
    model = _model({})
    arrs = _arrays(6, seed=5)
    _, ts = _scenes(arrs)
    _, shifted = _scenes([arrs[0] + np.array([2.0, -1.0, 0.5]), *arrs[1:]])
    perm = torch.tensor([4, 2, 0, 5, 1, 3])
    permuted = Scene(ts.pos[:, perm], ts.vel[:, perm], ts.force[:, perm], ts.mass[:, perm])
    with torch.no_grad():
        out = model(ts, tgraph.knn_mask(ts.pos, 3))
        got_s = model(shifted, tgraph.knn_mask(shifted.pos, 3))
        got_p = model(permuted, tgraph.knn_mask(permuted.pos, 3))
    assert _rel(got_s.numpy(), out.numpy()) <= EQUIV_RTOL
    assert _rel(got_p.numpy(), out[:, perm].numpy()) <= EQUIV_RTOL


def test_float32_gradients_round_as_the_jax_models():
    """The port's float32 gradients are as far from its float64 ones as the
    JAX model's float32 gradients are from its float64 ones (largest error
    over the tensors, each relative to its largest gradient, within 4x),
    and the float64 gradients of the two packages agree within 1e-10."""
    import jax

    kw = dict(num_layers=3, hidden_features=8)
    model = _model(kw)
    tree = weights.params_to_jax(model.state_dict())
    arrs = _arrays(5, seed=13)
    target = np.random.default_rng(14).normal(size=(B, 5, 6)) * 0.1
    jm = jmodels.create_model("cgenn", **SMALL | kw)

    def jax_grads(dt):
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), tree)
        s = JScene(*(jnp.asarray(a, dt) for a in arrs))
        mask = jgraph.knn_mask(s.pos, 4)
        g = jax.grad(lambda p: jnp.mean((jm.apply(p, s, mask) - target.astype(dt)) ** 2))(p)
        return weights.params_from_jax(jax.tree_util.tree_map(np.asarray, g), "cgenn")

    def port_grads(dt):
        m = _model(kw).to(dt)
        m.load_state_dict(model.state_dict())
        s = Scene(*(torch.tensor(a, dtype=dt) for a in arrs))
        out = m(s, tgraph.knn_mask(s.pos, 4))
        ((out - torch.tensor(target, dtype=dt)) ** 2).mean().backward()
        return {k: p.grad for k, p in m.named_parameters()}

    j32, j64 = jax_grads(np.float32), jax_grads(np.float64)
    t32, t64 = port_grads(torch.float32), port_grads(torch.float64)

    def worst(a, b):
        return max((a[k].double() - b[k].double()).abs().max().item()
                   / (b[k].double().abs().max().item() or 1.0) for k in b)

    assert worst(t64, j64) <= OUT_RTOL
    port_err, jax_err = worst(t32, t64), worst(j32, j64)
    assert 0 < port_err <= 4 * jax_err and 0 < jax_err <= 4 * port_err


def test_no_dropout_so_training_mode_is_eval_mode():
    model = _model({})
    _, ts = _scenes(_arrays(5, seed=6))
    mask = tgraph.knn_mask(ts.pos, 4)
    with torch.no_grad():
        out = model(ts, mask)
        model.train()
        assert not tmodels.needs_generator(model)
        assert tmodels.generator_kwargs(model, 3, "cpu") == {}
        assert torch.equal(model(ts, mask, train=True), out)


def test_layer_stats_match_the_jax_trainers():
    model = _model({})
    tree = weights.params_to_jax(model.state_dict())
    js, ts = _scenes(_arrays(5, seed=7))
    holder = SimpleNamespace(model=jmodels.create_model("cgenn", **SMALL), num_neighbors=4,
                             _data_masks=False)
    want = {k: float(v) for k, v in JT.Trainer._build_layer_stats_fn(holder)(tree, js).items()}
    got = {k: float(v) for k, v in TLS.capture(model, ts, tgraph.knn_mask(ts.pos, 4)).items()}
    assert set(got) == set(want) and "MVLinear_0.absmax" in got
    for k, v in want.items():
        assert abs(got[k] - v) <= STATS_RTOL * max(abs(v), 1.0), k
