"""EquiformerV2's live dropout in the port: explicit generators, no global RNG.

* The masks keep what ``1 - rate`` says within binomial bounds (six
  standard deviations): alpha dropout an entry of ``[B, N, N, heads]`` at a
  time, drop path one simulation at a time (a ``[B]`` draw, broadcast over
  bodies, rows and channels).
* A block whose two drop-path draws both drop a simulation hands that
  simulation's input through unchanged; a kept one is scaled by
  ``1 / keep``, as flax's ``Dropout`` and the JAX block do.
* A training-mode forward with a rate above 0 and no generator raises; eval
  mode, and training mode with both rates at 0, need none.
* The same generator seed gives the same forward and the same self-feed
  rollout (``run_self_feed``, ``make_rollout_fn``, the Inferencer), bit for
  bit; another seed gives another; the rollout draws fresh masks every step.
* ``remat`` draws each block's masks before the block runs, so the
  gradients with ``remat=True`` equal those without under one seed (a
  checkpointed block that drew inside would see other masks on its second
  pass), and two trainers of one seed take the same steps.
"""

import importlib

import numpy as np
import pytest
import torch

PORT = ("extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_"
        "architectures_tpu_torch")
tgraph = importlib.import_module(PORT + ".core.graph")
Scene = importlib.import_module(PORT + ".core.scene").Scene
tmodels = importlib.import_module(PORT + ".models")
TE = importlib.import_module(PORT + ".models.equiformer_v2")
trollout = importlib.import_module(PORT + ".rollout.self_feed")
TOTF = importlib.import_module(PORT + ".data.gravity_otf")

SMALL = dict(num_layers=2, sphere_channels=8, attn_hidden_channels=8, ffn_hidden_channels=8,
             num_heads=2, edge_channels=8)
N = 5


def _model(seed=0, **kw):
    torch.manual_seed(seed)
    return tmodels.create_model("equiformer_v2", device="cpu", dtype=torch.float64,
                                **{**SMALL, **kw})


def _scene(b=3, n=N, seed=0):
    rng = np.random.default_rng(seed)
    pos, vel = rng.normal(size=(b, n, 3)), rng.normal(size=(b, n, 3))
    return Scene(*(torch.from_numpy(a) for a in (pos, vel, np.zeros((b, n, 3)),
                                                  np.ones((b, n, 1)))))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _within_binomial(kept: torch.Tensor, p_keep: float) -> bool:
    n = kept.numel()
    sd = (n * p_keep * (1 - p_keep)) ** 0.5
    return abs(kept.sum().item() - n * p_keep) <= 6 * sd


@pytest.mark.parametrize("alpha_drop,drop_path", [(0.1, 0.05), (0.5, 0.3)])
def test_kept_fractions_are_within_binomial_bounds(alpha_drop, drop_path):
    m = _model(alpha_drop=alpha_drop, drop_path_rate=drop_path).train()
    masks = m.draw_masks(40, 6, _gen(3), "cpu")
    alpha = torch.stack([a for a, _, _ in masks])
    paths = torch.stack([torch.stack([p, f]) for _, p, f in masks])
    assert alpha.shape == (2, 40, 6, 6, 2) and alpha.dtype == torch.bool
    assert paths.shape == (2, 2, 40)  # one draw a simulation
    assert _within_binomial(alpha, 1 - alpha_drop)
    big = m.draw_masks(4000, 1, _gen(4), "cpu")
    assert _within_binomial(torch.stack([torch.stack([p, f]) for _, p, f in big]), 1 - drop_path)


def test_drop_path_drops_whole_simulations():
    m = _model(drop_path_rate=0.5).train()
    blk = m.blocks[0]
    s = _scene()
    mask = tgraph.knn_mask(s.pos, N - 1)
    x = torch.randn(3, N, 9, 8, generator=_gen(1), dtype=torch.float64)
    inputs = _block_inputs(m, s, mask)
    keep = torch.tensor([True, False, True])
    with torch.no_grad():
        out = blk(x, *inputs, None, keep, keep)
        h_attn = blk.SO2Attention_0(blk.RMSNormSH_0(x), *inputs)
        x1 = x + h_attn / 0.5
        want0 = x1 + blk.FeedForward_0(blk.RMSNormSH_1(x1)) / 0.5
    assert torch.equal(out[1], x[1])  # both paths dropped: the input passes
    torch.testing.assert_close(out[0], want0[0], rtol=1e-13, atol=1e-13)
    assert (out[2] - x[2]).abs().max() > 0


def _block_inputs(m, s, mask):
    """``(x_edge, D, D_inv, adj, charges)`` as the model's forward makes them."""
    seen = {}
    hook = m.blocks[0].register_forward_pre_hook(  # returns None: the args stay
        lambda mod, args: seen.update(args=args[1:6]))
    try:
        with torch.no_grad():
            m.eval()(s, mask)
    finally:
        hook.remove()
        m.train()
    return seen["args"]


def test_alpha_dropout_scales_the_kept_weights():
    m = _model().train()
    attn = m.blocks[0].SO2Attention_0
    s = _scene()
    mask = tgraph.knn_mask(s.pos, N - 1)
    x = torch.randn(3, N, 9, 8, generator=_gen(2), dtype=torch.float64)
    inputs = _block_inputs(m, s, mask)
    with torch.no_grad():
        none = attn(x, *inputs, None)
        everything = attn(x, *inputs, torch.ones(3, N, N, 2, dtype=torch.bool))
        nothing = attn(x, *inputs, torch.zeros(3, N, N, 2, dtype=torch.bool))
    bias = attn.SO3Linear_0.bias
    # keeping every weight scales the values by 1/0.9 before the bias
    torch.testing.assert_close(everything[..., 0, :] - bias, (none[..., 0, :] - bias) / 0.9)
    torch.testing.assert_close(everything[..., 1:, :], none[..., 1:, :] / 0.9)
    assert torch.equal(nothing[..., 0, :], bias.expand(3, N, 8)) and not nothing[..., 1:, :].any()


def test_train_mode_needs_a_generator():
    m = _model().train()
    s = _scene()
    mask = tgraph.knn_mask(s.pos, N - 1)
    assert tmodels.needs_generator(m)
    with pytest.raises(ValueError, match="torch.Generator"):
        m(s, mask)
    m.eval()
    assert not tmodels.needs_generator(m)
    with torch.no_grad():
        m(s, mask)
    quiet = _model(alpha_drop=0.0, drop_path_rate=0.0).train()
    assert not tmodels.needs_generator(quiet)
    with torch.no_grad():
        quiet(s, mask)
    assert tmodels.generator_kwargs(m, 3, "cpu") == {}  # eval mode
    kw = tmodels.generator_kwargs(m.train(), 3, "cpu")
    assert torch.equal(kw["generator"].get_state(), _gen(3).get_state())


def test_one_seed_gives_one_forward():
    m = _model(alpha_drop=0.3, drop_path_rate=0.3).train()
    s = _scene()
    mask = tgraph.knn_mask(s.pos, N - 1)
    with torch.no_grad():
        a, b, c = (m(s, mask, generator=_gen(k)) for k in (7, 7, 8))
    assert torch.equal(a, b) and not torch.equal(a, c)


def _dataset():
    return TOTF.GravityDatasetOtf(batch_size=3, sim_length=80, sample_freq=10, num_nodes=N,
                                  double_precision=True, seed=0, device="cpu")


def test_the_same_seed_gives_the_same_rollout_bitwise():
    m = _model(alpha_drop=0.3, drop_path_rate=0.2)
    runs = [trollout.run_self_feed(m, _dataset(), train_mode=True, rng=seed)
            for seed in (5, 5, 6)]
    (_, _, loc_a, vel_a, _), (gt_b, _, loc_b, vel_b, _), (_, _, loc_c, _, _) = runs
    assert loc_a.shape == (3, 8, N, 3) and torch.isfinite(loc_a).all()
    assert torch.equal(loc_a, loc_b) and torch.equal(vel_a, vel_b)
    assert not torch.equal(loc_a, loc_c)
    # an eval-mode rollout draws nothing: any seed gives it
    _, _, loc_e, _, _ = trollout.run_self_feed(m, _dataset(), train_mode=False, rng=5)
    _, _, loc_f, _, _ = trollout.run_self_feed(m, _dataset(), train_mode=False, rng=6)
    assert torch.equal(loc_e, loc_f) and not torch.equal(loc_e, loc_a)


def test_the_rollout_draws_fresh_masks_every_step(monkeypatch):
    m = _model(alpha_drop=0.3, drop_path_rate=0.2).train()
    drawn = []
    draw = m.draw_masks
    monkeypatch.setattr(m, "draw_masks", lambda *a: drawn.append(draw(*a)) or drawn[-1])
    trollout.make_rollout_fn(m, 3)(_scene(b=2), rng=1)
    assert len(drawn) == 2
    assert not torch.equal(drawn[0][0][0], drawn[1][0][0])


def test_remat_gradients_equal_plain_gradients_under_one_seed():
    plain = _model(alpha_drop=0.3, drop_path_rate=0.3).train()
    remat = _model(alpha_drop=0.3, drop_path_rate=0.3, remat=True).train()
    remat.load_state_dict(plain.state_dict())
    s = _scene()
    mask = tgraph.knn_mask(s.pos, N - 1)
    grads = []
    for model in (plain, remat):
        model.zero_grad(set_to_none=True)
        (model(s, mask, generator=_gen(11)) ** 2).sum().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        assert torch.equal(g, grads[1][name]), name
    # masks drawn inside the checkpointed block would differ on its second pass
    other = dict(plain.named_parameters())["blocks.0.SO2Attention_0.alpha_dot"]
    plain.zero_grad(set_to_none=True)
    (plain(s, mask, generator=_gen(12)) ** 2).sum().backward()
    assert not torch.equal(other.grad, grads[0]["blocks.0.SO2Attention_0.alpha_dot"])
