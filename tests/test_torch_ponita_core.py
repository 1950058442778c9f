"""PONITA's building blocks in the port against the JAX package, float64.

The five geometry helpers PONITA and the next families need
(``masked_segment_sum``, ``safe_unit``, ``gaussian_rbf``, ``cosine_cutoff``,
``polynomial_cutoff``) agree with the JAX package's within 1e-12 (relative,
with an absolute floor of 1e-12) on inputs drawn from numpy with a seed, and
``safe_unit``'s gradient is finite at zero length.  ``Scene.charge`` passes
through ``astype``.  The orientation grid ``uniform_grid_s2`` (the port's own
copy, float64 NumPy) is bitwise the JAX package's.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

TPU = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu"
PORT = TPU + "_torch"
jgraph = importlib.import_module(TPU + ".core.graph")
tgraph = importlib.import_module(PORT + ".core.graph")
JScene = importlib.import_module(TPU + ".core.scene").Scene
Scene = importlib.import_module(PORT + ".core.scene").Scene
js2 = importlib.import_module(TPU + ".ops.s2grid")
ts2 = importlib.import_module(PORT + ".ops.s2grid")

RTOL = ATOL = 1e-12


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_masked_segment_sum_matches_jax():
    rng = np.random.default_rng(0)
    values = rng.normal(size=(3, 6, 6, 4, 5))
    mask = rng.random((3, 6, 6)) < 0.5
    _close(tgraph.masked_segment_sum(torch.from_numpy(values), torch.from_numpy(mask)),
           jgraph.masked_segment_sum(jnp.asarray(values), jnp.asarray(mask)))


def test_safe_unit_matches_jax_and_is_zero_at_zero_length():
    rng = np.random.default_rng(1)
    vec = rng.normal(size=(4, 7, 3))
    vec[0, 0] = 0.0
    vec[1, 2] = 1e-10  # below eps: reported as length 0
    unit, norm = tgraph.safe_unit(torch.from_numpy(vec))
    junit, jnorm = jgraph.safe_unit(jnp.asarray(vec))
    _close(unit, junit)
    _close(norm, jnorm)
    assert float(norm[0, 0]) == 0.0 and bool((unit[0, 0] == 0).all())


def test_safe_unit_gradient_is_finite_at_zero_length():
    vec = torch.zeros(2, 3, dtype=torch.float64, requires_grad=True)
    with torch.no_grad():
        vec[1] = torch.tensor([0.3, -0.4, 1.2], dtype=torch.float64)
    unit, norm = tgraph.safe_unit(vec)
    (unit.sum() + norm.sum()).backward()
    assert torch.isfinite(vec.grad).all() and bool((vec.grad[0] == 0).all())
    jgrad = jax.grad(lambda v: sum(jnp.sum(t) for t in jgraph.safe_unit(v)))(
        jnp.asarray(vec.detach().numpy()))
    _close(vec.grad, jgrad)


@pytest.mark.parametrize("num_rbf,cutoff,start", [(16, 5.0, 0.0), (8, 3.0, 0.5), (1, 2.0, 0.0)])
def test_gaussian_rbf_matches_jax(num_rbf, cutoff, start):
    d = np.random.default_rng(2).random((5, 6)) * 6.0
    _close(tgraph.gaussian_rbf(torch.from_numpy(d), num_rbf, cutoff, start),
           jgraph.gaussian_rbf(jnp.asarray(d), num_rbf, cutoff, start))


@pytest.mark.parametrize("fn", ["cosine_cutoff", "polynomial_cutoff"])
def test_cutoff_windows_match_jax(fn):
    d = np.random.default_rng(3).random((5, 6, 1)) * 3.0  # both sides of the cutoff
    got = getattr(tgraph, fn)(torch.from_numpy(d), 2.0)
    _close(got, getattr(jgraph, fn)(jnp.asarray(d), 2.0))
    assert bool((got[torch.from_numpy(d) >= 2.0] == 0).all())


def test_scene_charge_passes_through_astype():
    rng = np.random.default_rng(4)
    arrs = [rng.normal(size=(2, 5, k)) for k in (3, 3, 3, 1, 1)]
    scene = Scene(*(torch.from_numpy(a) for a in arrs))
    jscene = JScene(*(jnp.asarray(a) for a in arrs)).astype(jnp.float32)
    cast = scene.astype(torch.float32)
    assert cast.charge.dtype == torch.float32 and cast.dtype == torch.float32
    np.testing.assert_array_equal(cast.charge.numpy(), np.asarray(jscene.charge))
    plain = Scene(*(torch.from_numpy(a) for a in arrs[:4]))  # the four-field form
    assert plain.charge is None and plain.astype(torch.float32).charge is None
    still = Scene.stationary(2, 5, device="cpu")
    assert float(still.pos.abs().sum()) == 0.0 and bool((still.mass == 1).all())


@pytest.mark.parametrize("n", [1, 6, 20])
def test_uniform_grid_s2_is_bitwise_the_jax_packages(n):
    got, want = ts2.uniform_grid_s2(n), js2.uniform_grid_s2(n)
    assert got.dtype == np.float64 and got.shape == (n, 3)
    assert got.tobytes() == want.tobytes()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-12)


def test_fibonacci_sphere_is_bitwise_the_jax_packages():
    assert ts2.fibonacci_sphere(13).tobytes() == js2.fibonacci_sphere(13).tobytes()
