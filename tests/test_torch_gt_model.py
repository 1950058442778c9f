"""The port's GraphTransformer against the JAX package's, float64 on the CPU.

A small model gets the port's seeded float64 initialisation, carried to the
JAX model with ``weights.params_to_jax`` (whose tree has the shapes of the
JAX model's own ``init``); both packages then run on the same scene, made
with numpy from a seed.

* Eval-mode forwards agree within 1e-9 of the largest output, at N=5 and
  N=8 (the neighbour mask is unused: full attention), with 1, 2 and 4 heads
  (head sizes 12, 6, 3), 5 heads of 3 (an odd head size, as the committed
  model's 31) and three layers with a narrow feed-forward.
* Training mode with the dropout rate at 0 needs no generator and equals
  the JAX model's training mode.
* Live dropout: the port's masks, handed to the JAX model in place of its
  own draws (``jax.random.bernoulli`` patched to return them in order), give
  the JAX model's training-mode output within 1e-9.  So the masks have flax's
  shapes and order: the attention weights' one ``[1, 1, N, N]`` mask a
  layer, shared by every simulation and head (flax's broadcast dropout),
  then the three dropouts' full masks.
* A training-mode forward with a rate above 0 and no generator raises; the
  same generator seed gives the same forward, bit for bit, another seed
  another.
* A permutation of the bodies permutes the outputs within 1e-12; a
  translation changes them (the model sees raw positions).
* Gradients are finite; ``layer_stats.capture`` gives the JAX trainer's
  keys and values within 1e-9; a width the heads do not divide raises.
"""

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
TG = importlib.import_module(PORT + ".models.graph_transformer")
weights = importlib.import_module(PORT + ".weights")
TLS = importlib.import_module(PORT + ".evaluation.layer_stats")

SMALL = dict(hidden_features=12, num_layers=2, num_heads=2, dim_feedforward=24)
OUT_RTOL, PERM_RTOL, STATS_RTOL = 1e-9, 1e-12, 1e-9
B = 3
CASES = {
    "default": {},
    "one_head": dict(num_heads=1),
    "four_heads": dict(num_heads=4),
    "odd_head_size": dict(hidden_features=15, num_heads=5, dim_feedforward=20),
    "three_layers": dict(num_layers=3, dim_feedforward=8),
}


def _arrays(n, seed=0, b=B):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, n, 3)) * 2.0, rng.normal(size=(b, n, 3)), np.zeros((b, n, 3)),
            np.ones((b, n, 1))]


def _pair(kw, seed=0, dropout=0.1):
    """The port's float64 model (eval mode) and the JAX model with its tree."""
    kw = {**SMALL, **kw, "dropout": dropout}
    torch.manual_seed(seed)
    model = tmodels.create_model("graph_transformer", device="cpu", dtype=torch.float64, **kw)
    return model.eval(), jmodels.create_model("graph_transformer", **kw), \
        weights.params_to_jax(model.state_dict())


def _scenes(arrs):
    return (JScene(*(jnp.asarray(a) for a in arrs)), Scene(*(torch.from_numpy(a) for a in arrs)))


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max()


@pytest.mark.parametrize("n", [5, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_forward_matches_jax(case, n):
    model, jm, tree = _pair(CASES[case])
    js, ts = _scenes(_arrays(n, seed=n))
    want = np.asarray(jm.apply(tree, js, jgraph.knn_mask(js.pos, 3)))
    with torch.no_grad():
        got = model(ts, tgraph.knn_mask(ts.pos, 3)).numpy()
    assert got.shape == (B, n, 6) and np.isfinite(got).all()
    assert _rel(got, want) <= OUT_RTOL


def test_tree_has_the_jax_shapes():
    model, jm, tree = _pair({})
    js, _ = _scenes(_arrays(5))
    init = jax.eval_shape(jm.init, jax.random.PRNGKey(0), js, jgraph.knn_mask(js.pos, 4))
    assert (jax.tree_util.tree_map(np.shape, tree["params"])
            == jax.tree_util.tree_map(lambda x: tuple(x.shape), init["params"]))


def test_train_mode_without_dropout_equals_jax_train_mode():
    model, jm, tree = _pair({}, dropout=0.0)
    model.train()
    assert not tmodels.needs_generator(model)
    js, ts = _scenes(_arrays(5, seed=3))
    want = np.asarray(jm.apply(tree, js, None, train=True))
    with torch.no_grad():
        got = model(ts, None).numpy()
    assert _rel(got, want) <= OUT_RTOL


@pytest.mark.parametrize("n", [5, 7])
def test_the_ports_masks_give_the_jax_models_dropout(monkeypatch, n):
    """The JAX model draws its masks through ``jax.random.bernoulli``: handed
    the port's masks in the port's order, it computes the port's output, and
    each mask has the shape flax asks for."""
    model, jm, tree = _pair({}, dropout=0.3)
    model.train()
    js, ts = _scenes(_arrays(n, seed=4))
    masks = model.draw_masks(B, n, torch.Generator().manual_seed(9), "cpu")
    queue = [m.numpy() for layer in masks for m in layer]
    asked = []

    def bernoulli(key, p=0.5, shape=None):
        mask = queue.pop(0)
        asked.append((tuple(shape), p))
        assert tuple(shape) == mask.shape
        return jnp.asarray(mask)

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    want = np.asarray(jm.apply(tree, js, None, train=True,
                               rngs={"dropout": jax.random.PRNGKey(0)}))
    assert not queue
    H, F = SMALL["hidden_features"], SMALL["dim_feedforward"]
    layer = [(1, 1, n, n), (B, n, H), (B, n, F), (B, n, H)]
    assert [s for s, _ in asked] == layer * SMALL["num_layers"]
    assert all(abs(p - 0.7) < 1e-12 for _, p in asked)
    with torch.no_grad():
        got = model(ts, None, generator=torch.Generator().manual_seed(9)).numpy()
    assert _rel(got, want) <= OUT_RTOL
    # the dropout acted: the eval-mode output is another
    with torch.no_grad():
        assert _rel(model.eval()(ts, None).numpy(), want) > 1e-3


def test_the_attention_mask_is_shared_by_every_simulation_and_head():
    model, _, _ = _pair({}, dropout=0.5)
    model.train()
    masks = model.draw_masks(B, 5, torch.Generator().manual_seed(2), "cpu")
    attn = masks[0][0]
    assert attn.shape == (1, 1, 5, 5) and attn.dtype == torch.bool
    # a dropped (query, key) pair has weight 0 in every simulation and head
    mha = model.blocks[0].MultiHeadDotProductAttention_0
    x = torch.randn(B, 5, SMALL["hidden_features"], dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        q, k, v = mha.query(x), mha.key(x), mha.value(x)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q / np.sqrt(mha.head_dim), k), dim=-1)
        w = w * attn.double() / 0.5
        want = mha.out(torch.einsum("bhqk,bkhd->bqhd", w, v))
        got = mha(x, attn)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    dropped = ~attn[0, 0]
    assert bool(dropped.any()) and bool((w[:, :, dropped] == 0).all())


def test_live_dropout_needs_a_generator_and_one_seed_gives_one_forward():
    model, _, _ = _pair({})
    _, ts = _scenes(_arrays(5, seed=5))
    model.train()
    assert tmodels.needs_generator(model)
    with pytest.raises(ValueError, match="torch.Generator"):
        model(ts, None)
    with torch.no_grad():
        a, b, c = (model(ts, None, generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kw = tmodels.generator_kwargs(model, 1, "cpu")
    with torch.no_grad():
        assert torch.equal(model(ts, None, **kw), a)
    model.eval()
    assert not tmodels.needs_generator(model) and tmodels.generator_kwargs(model, 1, "cpu") == {}


def test_permutation_and_translation():
    model, _, _ = _pair(CASES["four_heads"])
    arrs = _arrays(6, seed=6)
    _, ts = _scenes(arrs)
    perm = torch.tensor([4, 2, 0, 5, 1, 3])
    moved = Scene(ts.pos[:, perm], ts.vel[:, perm], ts.force[:, perm], ts.mass[:, perm])
    shifted = Scene(ts.pos + 1.5, ts.vel, ts.force, ts.mass)
    with torch.no_grad():
        out = model(ts, None)
        assert _rel(model(moved, None)[:, perm.argsort()].numpy(), out.numpy()) <= PERM_RTOL
        assert _rel(model(shifted, None).numpy(), out.numpy()) > 1e-6


def test_gradients_are_finite():
    model, _, _ = _pair({})
    _, ts = _scenes(_arrays(5, seed=7))
    model.train()
    out = model(ts, None, generator=torch.Generator().manual_seed(0))
    out.square().sum().backward()
    grads = [p.grad for p in model.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)


def test_layer_stats_match_the_jax_trainers():
    model, jm, tree = _pair({})
    arrs = _arrays(5, seed=8)
    js, ts = _scenes(arrs)
    holder = SimpleNamespace(model=jm, num_neighbors=4, _data_masks=False)
    want = {k: float(v) for k, v in JT.Trainer._build_layer_stats_fn(holder)(tree, js).items()}
    got = {k: float(v) for k, v in TLS.capture(model, ts, tgraph.knn_mask(ts.pos, 4)).items()}
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= STATS_RTOL * max(abs(v), 1.0), k


def test_a_width_the_heads_do_not_divide_raises():
    with pytest.raises(ValueError, match="do not split into 5 heads"):
        TG.GraphTransformer(hidden_features=12, num_heads=5)
