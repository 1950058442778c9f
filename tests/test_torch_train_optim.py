"""The port's losses, Noam schedule and optimizer against the JAX package's.

Losses: every function of ``train/losses.py`` on the same float64 arrays, for
all six targets, within 1e-12 relative.  Schedule: the port's float32 Noam
learning rate equals the JAX one at steps 0, 1, 2, 999, 1000, 1001 and 5000.
Optimizer: from the same float64 parameters and gradients, one and then three
updates of the port's AdamW (``train/optim.py``) against the optax chain that
the JAX package's ``create_optimizer`` builds with the same arguments, within
1e-12 of each tensor's largest value: plain, clipped by value, clipped by
global norm above and below the limit, and with ``discard_nan_gradients``,
where a NaN gradient leaves parameters, moments and schedule as they were and
the next finite update matches optax again.
"""

import importlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

TPU = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu"
PORT = TPU + "_torch"
JL = importlib.import_module(TPU + ".train.losses")
JO = importlib.import_module(TPU + ".train.optim")
JScene = importlib.import_module(TPU + ".core.scene").Scene
TL = importlib.import_module(PORT + ".train.losses")
TO = importlib.import_module(PORT + ".train.optim")
Scene = importlib.import_module(PORT + ".core.scene").Scene

TARGETS = ("pos", "force", "pos_dt+vel_dt", "pos_dt+vel", "pos+vel", "pos_com+vel")
RTOL = 1e-12
B, N = 4, 5


def _case(target, seed=0):
    rng = np.random.default_rng(seed)
    k = len(target.split("+"))
    arrs = dict(pos=rng.normal(size=(B, N, 3)), vel=rng.normal(size=(B, N, 3)),
                force=rng.normal(size=(B, N, 3)), mass=rng.uniform(0.5, 1.5, size=(B, N, 1)),
                pred=rng.normal(size=(B, N, 3 * k)), y=rng.normal(size=(B, N, 3 * k)))
    js = JScene(*(jnp.asarray(arrs[n]) for n in ("pos", "vel", "force", "mass")))
    ts = Scene(*(torch.from_numpy(arrs[n]) for n in ("pos", "vel", "force", "mass")))
    return (jnp.asarray(arrs["pred"]), js, jnp.asarray(arrs["y"]),
            torch.from_numpy(arrs["pred"]), ts, torch.from_numpy(arrs["y"]))


def _close(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert np.abs(got - want).max() <= RTOL * max(np.abs(want).max(), 1e-300)


def _args(target, **kw):
    base = dict(target=target, position_loss_weight=0.7, velocity_loss_weight=1.3,
                force_loss_weight=0.9, com_loss=False, energy_loss=False, momentum_loss=False,
                momentum_loss_weight=0.01, interaction_strength=2.0, softening=0.2)
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.mark.parametrize("target", TARGETS)
def test_losses_match_jax(target):
    jp, js, jy, tp, ts, ty = _case(target)
    targets = target.split("+")
    weights = {"position": 0.7, "velocity": 1.3, "force": 0.9}
    jt, jterms = JL.target_common_loss(jp, js, jy, targets, weights)
    tt, tterms = TL.target_common_loss(tp, ts, ty, targets, weights)
    _close(tt, jt)
    assert sorted(tterms) == sorted(jterms)
    for k in jterms:
        _close(tterms[k], jterms[k])
    for k, v in JL.percentage_errors(jp, jy, targets).items():
        _close(TL.percentage_errors(tp, ty, targets)[k], v)
    if target != "force":
        _close(TL.centre_of_mass_loss(tp, ts, ty, 0.5, target),
               JL.centre_of_mass_loss(jp, js, jy, 0.5, target))
    if len(targets) == 2:
        _close(TL.momentum_loss(tp, ts, ty, 0.01, target),
               JL.momentum_loss(jp, js, jy, 0.01, target))
        _close(TL.energy_loss(tp, ts, ty, 2.0, 0.2, 0.3, target),
               JL.energy_loss(jp, js, jy, 2.0, 0.2, 0.3, target))
        init = TL.dynamic_weighted_loss_init("cpu", torch.float64)
        loss, state = TL.dynamic_weighted_loss(tp, ty, init, 0.9)
        jloss, jstate = JL.dynamic_weighted_loss(jp, jy, JL.dynamic_weighted_loss_init(), 0.9)
        _close(loss, jloss)
        for a, b in zip(state, jstate):
            _close(a, b)


@pytest.mark.parametrize("target", TARGETS)
def test_build_loss_fn_matches_jax(target):
    jp, js, jy, tp, ts, ty = _case(target, seed=1)
    six = len(target.split("+")) == 2
    args = _args(target, com_loss=target != "force", energy_loss=six, momentum_loss=six)
    jt, jterms = JL.build_loss_fn(args)(jp, js, jy)
    tt, tterms = TL.build_loss_fn(args)(tp, ts, ty)
    _close(tt, jt)
    assert sorted(tterms) == sorted(jterms)
    for k in jterms:
        _close(tterms[k], jterms[k])


@pytest.mark.parametrize("kw", [dict(target="pos", energy_loss=True),
                                dict(target="force", momentum_loss=True),
                                dict(target="force", com_loss=True)])
def test_build_loss_fn_refuses_what_jax_refuses(kw):
    args = _args(**kw)
    with pytest.raises(ValueError):
        JL.build_loss_fn(args)
    with pytest.raises(ValueError):
        TL.build_loss_fn(args)


@pytest.mark.parametrize("step", [0, 1, 2, 999, 1000, 1001, 5000])
def test_noam_learning_rate_matches_jax(step):
    want = float(JO.noam_schedule(0.5, 128, 1.0, 1000)(jnp.asarray(step, jnp.int32)))
    assert TO.noam_schedule(0.5, 128, 1.0, 1000)(step) == want
    assert float(TO.noam_lr(step, 0.5, 128, 1.0, 1000)) == want


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(4, 3)), "b": rng.normal(size=(5,)), "c": rng.normal(size=(2, 2, 3))}


def _run(kw, n_updates, nan_at=()):
    """``n_updates`` updates of both optimizers from the same parameters and
    gradients; the gradient of update ``i`` in ``nan_at`` holds a NaN."""
    p0 = _params()
    tx = JO.create_optimizer(0.5, 16, warmup=4, **kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p0[k].copy())) for k in sorted(p0)]
    opt = TO.create_optimizer(tp, 0.5, 16, warmup=4, **kw)
    rng = np.random.default_rng(1)
    history = []
    for i in range(n_updates):
        g = {k: rng.normal(size=v.shape) * 3.0 for k, v in p0.items()}
        if i in nan_at:
            g["b"][2] = np.nan
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for t, k in zip(tp, sorted(p0)):
            t.grad = torch.from_numpy(g[k].copy())
        opt.update()
        history.append((opt.count, float(opt.lr)))
    for t, k in zip(tp, sorted(p0)):
        want = np.asarray(jp[k])
        assert np.abs(t.detach().numpy() - want).max() <= RTOL * np.abs(want).max(), k
    return opt, tp, history


@pytest.mark.parametrize("n_updates", [1, 3])
@pytest.mark.parametrize("kw", [dict(), dict(clip_value=0.5), dict(clip_norm=1.0),
                                dict(clip_norm=1e3), dict(clip_value=2.0, clip_norm=4.0)],
                         ids=["plain", "clip_value", "clip_norm_above", "clip_norm_below",
                              "clip_both"])
def test_optimizer_matches_optax(kw, n_updates):
    opt, _, history = _run(kw, n_updates)
    assert [c for c, _ in history] == list(range(1, n_updates + 1))
    # optax's schedule count: the first two updates both run at s = 1
    assert history[0][1] == TO.noam_schedule(0.5, 16, 1.0, 4)(1)


def test_clip_norm_is_optax_form_not_torch_form():
    g = torch.tensor([3.0, 4.0], dtype=torch.float64)  # norm 5
    p = torch.nn.Parameter(torch.zeros(2, dtype=torch.float64))
    opt = TO.create_optimizer([p], 0.5, 16, clip_norm=5.0)
    p.grad = g.clone()
    opt.optimizer.step = lambda: None  # keep the clipped gradient to look at it
    opt.update()
    assert torch.equal(p.grad, g / 5.0 * 5.0)  # at the limit: t / norm * max_norm
    p.grad = g.clone()
    opt.clip_norm = 5.5
    opt.update()
    assert torch.equal(p.grad, g)  # below it: unchanged (torch's form scales by 5.5 / 5.000001)


@pytest.mark.parametrize("nan_at", [(0,), (1,), (1, 2)])
def test_discard_nan_gradients_skips_the_whole_update(nan_at):
    opt, tp, history = _run(dict(discard_nan_gradients=True), 4, nan_at=nan_at)
    counts = [c for c, _ in history]
    want = []
    for i in range(4):
        want.append((want[-1] if want else 0) + (i not in nan_at))
    assert counts == want
    # the learning rate follows the count of updates taken, not of calls
    assert [lr for _, lr in history] == [TO.noam_schedule(0.5, 16, 1.0, 4)(c) for c in counts]
    assert all(torch.isfinite(t).all() for t in tp)
    exp_avg, exp_avg_sq = opt.moments()
    assert all(torch.isfinite(m).all() for m in exp_avg + exp_avg_sq)


def test_skip_on_a_device_flag_puts_everything_back():
    p = torch.nn.Parameter(torch.tensor([1.0, -2.0], dtype=torch.float64))
    opt = TO.create_optimizer([p], 0.5, 16, warmup=4)
    p.grad = torch.tensor([0.3, 0.1], dtype=torch.float64)
    opt.update()
    before = (p.detach().clone(), *(m[0].clone() for m in opt.moments()), opt.count,
              float(opt.lr))
    p.grad = torch.tensor([5.0, 7.0], dtype=torch.float64)
    opt.update(ok=torch.tensor(False))
    after = (p.detach(), *(m[0] for m in opt.moments()), opt.count, float(opt.lr))
    assert all(torch.equal(a, b) for a, b in zip(before[:3], after[:3]))
    assert before[3:] == after[3:]
