"""EquiformerV2's SO(3) edge machinery in the port against the JAX package's.

* The host-side constants are the JAX package's bit for bit: the quadratic
  Wigner-2 tensor (``default_rng(7)``, 60 QR rotations, ``lstsq``), the S2
  grid matrices at mmax 1 and 2, and the index helpers of the restricted
  layout.
* ``edge_align_rotation`` and ``wigner_full`` agree with the JAX functions
  within 1e-14 in float64 on random edges, zero vectors (the dense
  diagonal's), axis-aligned edges and edges whose smallest components tie
  (the helper axis is the first of the tied ones in both).
* The frames turn each edge onto the z axis, the edge vector's gradient is
  stopped, and D is orthogonal and equal to the block diagonal of
  ``wigner_D_numpy`` on random rotations within 1e-12.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

TPU = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu"
PORT = TPU + "_torch"
JSE = importlib.import_module(TPU + ".ops.so3_edge")
TSE = importlib.import_module(PORT + ".ops.so3_edge")
steerable = importlib.import_module(PORT + ".ops.steerable")

LAYOUTS = [(2, 1), (2, 2), (1, 1), (2, 0)]


def _edges():
    """Random edges, zero vectors, axis-aligned edges (both signs) and ties
    of the smallest components."""
    rng = np.random.default_rng(3)
    special = [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, -2.0, 0.0], [0.0, 0.0, 3.0],
               [1.0, 1.0, 1.0], [-1.0, 1.0, -1.0], [1.0, -1.0, 0.0], [0.0, 2.0, 2.0],
               [2.0, 0.0, 2.0], [0.5, 0.5, -3.0], [0.0, 0.0, 0.0]]
    return np.concatenate([rng.normal(size=(40, 3)), np.array(special)]).reshape(3, 17, 3)


def test_quadratic_wigner_tensor_is_bitwise_the_jax_one():
    got, want = TSE._wigner2_quadratic_tensor(), JSE._wigner2_quadratic_tensor()
    assert got.shape == (5, 5, 9, 9) and np.array_equal(got, want)


@pytest.mark.parametrize("mmax", [1, 2])
def test_s2_grid_mats_are_bitwise_the_jax_ones(mmax):
    (to_g, from_g), (jto, jfrom) = TSE.s2_grid_mats(2, mmax), JSE.s2_grid_mats(2, mmax)
    k = 7 if mmax == 1 else 9
    assert to_g.shape == (648, k) and from_g.shape == (k, 648)
    assert np.array_equal(to_g, jto) and np.array_equal(from_g, jfrom)


@pytest.mark.parametrize("lmax,mmax", LAYOUTS)
def test_index_helpers_are_the_jax_ones(lmax, mmax):
    assert np.array_equal(TSE.restricted_indices(lmax, mmax), JSE.restricted_indices(lmax, mmax))
    assert np.array_equal(TSE.l_expand_index(lmax, mmax), JSE.l_expand_index(lmax, mmax))
    assert np.array_equal(TSE.l_expand_index(lmax), JSE.l_expand_index(lmax))
    (m0, blocks), (jm0, jblocks) = TSE.m_order_indices(lmax, mmax), JSE.m_order_indices(lmax, mmax)
    assert np.array_equal(m0, jm0) and len(blocks) == len(jblocks)
    for (mi, pl), (jmi, jpl) in zip(blocks, jblocks):
        assert np.array_equal(mi, jmi) and np.array_equal(pl, jpl)
    order, inverse = TSE.m_order(lmax, mmax)
    assert sorted(order) == list(range(len(TSE.restricted_indices(lmax, mmax))))
    assert np.array_equal(order[inverse], np.arange(len(order)))


def test_edge_align_rotation_matches_jax_and_aligns():
    e = _edges()
    got = TSE.edge_align_rotation(torch.from_numpy(e)).numpy()
    want = np.asarray(JSE.edge_align_rotation(jnp.asarray(e)))
    assert got.shape == (3, 17, 3, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
    n = np.linalg.norm(e, axis=-1, keepdims=True)
    nonzero = n[..., 0] > 0
    turned = np.einsum("...ij,...j->...i", got, e / np.where(n > 0, n, 1))
    np.testing.assert_allclose(turned[nonzero], np.tile([0.0, 0.0, 1.0], (nonzero.sum(), 1)),
                               atol=1e-14)
    assert not got[~nonzero].any()  # the zero vector's frame is zero
    # the helper axis is the first of the smallest |components|: for (1, 1, 1)
    # it is x, so b1 = e x x_hat has no x component
    ones = got.reshape(-1, 3, 3)[40 + 4]
    assert ones[0, 0] == 0.0


def test_the_edge_vectors_gradient_is_stopped():
    e = torch.from_numpy(_edges()).requires_grad_(True)
    assert not TSE.edge_align_rotation(e).requires_grad


def test_wigner_full_matches_jax():
    e = _edges()
    R = TSE.edge_align_rotation(torch.from_numpy(e))
    got = TSE.wigner_full(R).numpy()
    want = np.asarray(JSE.wigner_full(jnp.asarray(R.numpy())))
    assert got.shape == (3, 17, 9, 9)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
    for lmax, k in ((0, 1), (1, 4)):
        np.testing.assert_allclose(TSE.wigner_full(R, lmax).numpy(),
                                   np.asarray(JSE.wigner_full(jnp.asarray(R.numpy()), lmax)),
                                   rtol=0, atol=1e-14)
        assert TSE.wigner_full(R, lmax).shape[-1] == k


def _rotations(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        q, r = np.linalg.qr(rng.normal(size=(3, 3)))
        q = q * np.sign(np.diag(r))
        out.append(q if np.linalg.det(q) > 0 else -q)
    return np.stack(out)


def test_wigner_blocks_are_orthogonal_and_equal_wigner_d_numpy():
    Rs = _rotations(8, 11)
    D = TSE.wigner_full(torch.from_numpy(Rs)).numpy()
    for R, d in zip(Rs, D):
        want = np.zeros((9, 9))
        for l, s in ((0, slice(0, 1)), (1, slice(1, 4)), (2, slice(4, 9))):
            want[s, s] = steerable.wigner_D_numpy(l, R)
        np.testing.assert_allclose(d, want, rtol=0, atol=1e-12)
        np.testing.assert_allclose(d @ d.T, np.eye(9), rtol=0, atol=1e-12)


def test_device_tables_are_made_once_per_device_and_dtype():
    like = torch.zeros(1, dtype=torch.float64)
    a = TSE.on_device(("wigner2",), lambda: TSE._wigner2_quadratic_tensor().reshape(25, 81), like)
    assert TSE.on_device(("wigner2",), lambda: 1 / 0, like) is a
    b = TSE.on_device(("wigner2",), lambda: TSE._wigner2_quadratic_tensor().reshape(25, 81),
                      like.float())
    assert b.dtype == torch.float32 and b is not a
