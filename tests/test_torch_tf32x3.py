"""The split rule of the f32 edge kernels' tensor-core product (3xTF32).

K1 and K3 in f32 (``csrc/egnn_edge.cuh``, ``mma_product``) run their Wc1
product on the tensor cores: each f32 operand x is split into two TF32
values, ``hi = tf32(x)`` and ``lo = tf32(x - hi)``, rounded to nearest (ties
away), and each k-step of 8 is taken as ``lo.hi + hi.lo + hi.hi`` summed from
zero, the k-steps' sums then added in f32 in k order.  Here that arithmetic is
emulated in torch: TF32 rounding by integer operations on the f32 bits, the
three terms in the kernel's order, f32 sums, on the committed N=100
checkpoint's layer-0 ``W2`` and ``Wc1`` and that layer's ``m1`` and ``m2`` for
a seeded scene (the W2 product, which the kernels keep on f32 FMA, as a second
set of real operands for the same rule).

These tests hold the split rule (round to nearest, three terms), not the
card's accumulation: the tensor core's own summation order and rounding
inside a k-step are not emulated, and ``chip_smoke.py`` holds the kernels on
the card against float64.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.core.scene import (
    Scene,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.models import (
    create_model,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.weights import (
    params_from_jax,
    read_jax_checkpoint,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "docs", "results", "fidelity_n100", "egnn_n100_ckpt_30_model.ckpt")
B, N, K_STEP = 2, 100, 8
LOW_BITS = 0x1FFF  # the 13 mantissa bits TF32 drops


def tf32(x: torch.Tensor, mode: str) -> torch.Tensor:
    """f32 -> TF32 (kept in f32): ``"rna"`` rounds to nearest, ties away from
    zero, by adding half a TF32 ulp to the bits and dropping the low 13 (what
    the kernel feeds the tensor core, which drops them); ``"rz"`` truncates."""
    u = x.contiguous().view(torch.int32)
    if mode == "rna":
        u = u + (LOW_BITS + 1) // 2
    return (u & ~LOW_BITS).view(torch.float32)


def split(x: torch.Tensor, mode: str = "rna"):
    hi = tf32(x, mode)
    return hi, tf32(x - hi, mode)


def product(a: torch.Tensor, w: torch.Tensor, mode: str = "rna", terms: int = 3) -> torch.Tensor:
    """a @ w as the kernel takes it: per k-step of 8, lo.hi + hi.lo + hi.hi
    (``terms=1``: hi.hi alone) from zero, added to the f32 sum in k order."""
    ah, al = split(a, mode)
    wh, wl = split(w, mode)
    acc = torch.zeros(a.shape[0], w.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], K_STEP):
        k = slice(k0, k0 + K_STEP)
        if terms == 3:
            d = al[:, k] @ wh[k]
            d = d + ah[:, k] @ wl[k]
            d = d + ah[:, k] @ wh[k]
        else:
            d = ah[:, k] @ wh[k]
        acc = acc + d
    return acc


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.double() - want).abs().max() / want.abs().max()).item()


@pytest.fixture(scope="module")
def operands():
    """Layer 0's m1 and m2 [B N N, 128] for a seeded scene, W2 and Wc1 [128, 128]."""
    model = create_model("egnn_mc", device="cpu")
    model.load_state_dict(params_from_jax(read_jax_checkpoint(CKPT)))
    rng = np.random.default_rng(17)
    pos = rng.normal(size=(B, N, 3)) * (N / 5.0) ** (1 / 3)
    vel = rng.normal(size=(B, N, 3))
    scene = Scene(*(torch.from_numpy(a.astype(np.float32))
                    for a in (pos, vel, np.zeros((B, N, 3)), np.ones((B, N, 1)))))
    block = model.layers[0]
    w_geom, W2, b2, Wc1, _, _ = (t.detach() for t in block.edge_weights())
    with torch.no_grad():
        x, edge_attr = model.featurize(scene)
        hA, hB, geom = block.edge_inputs(model.embedding(x), scene.pos, edge_attr)
        pre = hA[:, :, None, :] + hB[:, None, :, :] + geom[..., :5] @ w_geom
        m1 = torch.nn.functional.silu(pre).reshape(-1, W2.shape[0])
        m2 = torch.nn.functional.silu(m1 @ W2 + b2)
    return {"W2": (m1, W2), "Wc1": (m2, Wc1)}


def test_split_rounds_to_nearest_and_keeps_22_bits():
    x = torch.from_numpy(np.random.default_rng(3).normal(size=4096).astype(np.float32))
    hi, lo = split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & LOW_BITS).any()
    # hi is the nearest TF32 value: within half a TF32 ulp (2^-11 relative)
    assert ((x.double() - hi.double()).abs() <= 2.0**-11 * x.double().abs()).all()
    # lo keeps 11 of the remaining 13 bits: x = hi + lo to within 2^-22 |x|
    assert ((x.double() - hi.double() - lo.double()).abs() <= 2.0**-22 * x.double().abs()).all()
    # a tie rounds away from zero: 1 + 2^-11 is halfway between TF32 1 and 1 + 2^-10
    tie = torch.tensor([1 + 2.0**-11, -(1 + 2.0**-11)], dtype=torch.float32)
    assert tf32(tie, "rna").tolist() == [1 + 2.0**-10, -(1 + 2.0**-10)]
    assert tf32(tie, "rz").tolist() == [1.0, -1.0]


@pytest.mark.parametrize("weight", ["W2", "Wc1"])
def test_three_term_product_keeps_f32_accuracy(operands, weight):
    """3xTF32 with round-to-nearest splits is within 2x of a float32 matmul's
    error against float64; truncating splits and the hi.hi term alone are
    measurably worse."""
    a, w = operands[weight]
    want = a.double() @ w.double()
    f32 = rel_err(a @ w, want)
    x3 = rel_err(product(a, w), want)
    rz = rel_err(product(a, w, mode="rz"), want)
    one = rel_err(product(a, w, terms=1), want)
    assert x3 <= 2.0 * f32, (x3, f32)
    assert rz >= 2.0 * x3, (rz, x3)
    assert one >= 100.0 * x3, (one, x3)
