"""The port's own copies of the macro and KS code against the JAX package's.

Both take the same float64 numpy arrays (random walks made from a seed), so
counts must be exactly equal (NaN where the JAX package has NaN) and p-values
equal to 1e-12.
"""

import numpy as np
import pytest

from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu.metrics import (
    ks as jks,
    macros as jmacros,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.metrics import (
    ks as tks,
    macros as tmacros,
    native as tnative,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.native import (
    build as tbuild,
)


def walk(seed=0, S=6, T=60, N=6, scale=0.15):
    rng = np.random.default_rng(seed)
    start = rng.normal(size=(S, 1, N, 3)) * 0.8
    return start + np.cumsum(rng.normal(size=(S, T, N, 3)) * scale, axis=1)


def _equal_dicts(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_all_macros_matches(seed):
    loc = walk(seed)
    vel = np.diff(walk(seed + 10, scale=1.0), axis=1, prepend=0)
    _equal_dicts(tmacros.compute_all_macros(loc, vel), jmacros.compute_all_macros(loc, vel))


def test_numpy_versions_match():
    loc = walk(2)
    vel = np.diff(walk(3, scale=1.0), axis=1, prepend=0)
    for name, args in (
        ("count_stickings_and_collisions", (loc,)),
        ("count_balls_leaving_defined_area", (loc * 20,)),
        ("max_com_distance", (loc,)),
        ("count_sharp_turns", (vel, 45)),
        ("count_group_collisions", (loc,)),
        ("stuck_cluster_sizes", (loc,)),
    ):
        got, want = getattr(tmacros, name)(*args), getattr(jmacros, name)(*args)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=name)


def test_native_library_builds_into_the_port_build_dir():
    lib = tnative.get_lib()
    assert lib is not None, "g++ build of the port's macro library failed"
    path = tbuild.library_path()
    assert path.startswith(tbuild.BUILD_DIR) and path.endswith(".so")
    loc = walk(4)
    np.testing.assert_array_equal(tnative.count_group_collisions(loc),
                                  tmacros.count_group_collisions(loc))
    np.testing.assert_array_equal(tnative.stuck_cluster_sizes(loc),
                                  tmacros.stuck_cluster_sizes(loc))


def test_group_macro_gated_above_max_n(monkeypatch):
    monkeypatch.setenv("NBX_GROUP_MACRO_MAX_N", "4")
    loc = walk(5, N=6)
    vel = np.diff(loc, axis=1, prepend=0)
    got = tmacros.compute_all_macros(loc, vel)
    assert np.isnan(got["group_collision_count"]).all()
    _equal_dicts(got, jmacros.compute_all_macros(loc, vel))


def test_ks_pvalues_and_combination_match():
    gt = tmacros.compute_all_macros(walk(6), np.diff(walk(7, scale=1.0), axis=1, prepend=0))
    pred = tmacros.compute_all_macros(walk(8, scale=0.3),
                                      np.diff(walk(9, scale=2.0), axis=1, prepend=0))
    per, combined = tks.macro_ks_pvalues(gt, pred)
    jper, jcombined = jks.macro_ks_pvalues(gt, pred)
    assert set(per) == set(jper) and tks.SCORED_MACROS == jks.SCORED_MACROS
    for k in jper:
        np.testing.assert_allclose(per[k], jper[k], rtol=1e-12, atol=0, err_msg=k)
    np.testing.assert_allclose(combined, jcombined, rtol=1e-12)
    # group NaN -> stuck_cluster_size takes its place in the combination
    swapped = dict(per, group_collision_count=float("nan"))
    np.testing.assert_allclose(tks.combine_scored(swapped), jks.combine_scored(swapped), rtol=1e-12)
    assert tks.ks_p([], [1.0]) != tks.ks_p([], [1.0])  # NaN on empty input
    assert np.isnan(tks.fisher_combine([float("nan"), 0.0]))  # nothing valid to combine
    np.testing.assert_allclose(tks.fisher_combine([1e-320, 0.5]), jks.fisher_combine([1e-320, 0.5]))
