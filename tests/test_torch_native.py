"""The port's native C++ host helper (gpsat_tpu_torch/native) against numpy
and the JAX package's native helper: where it builds, its three functions,
and prediction_locations.max_dist_bool's route of large inputs through it."""

import os
import subprocess

import numpy as np
import pytest

from gpsat_tpu import native as jax_native
from gpsat_tpu_torch import native
from gpsat_tpu_torch import prediction_locations

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lib():
    out = native._load()
    assert out is not None, "the port's native library did not build or load"
    return out


def test_builds_under_build_dir_and_nowhere_in_the_jax_package(monkeypatch,
                                                               lib):
    """build() compiles into build/gpsat_tpu_torch/ under the repository
    root, through a file beside the library, and writes nothing under
    gpsat_tpu/."""
    calls = []
    real = subprocess.check_call

    def record(cmd, *a, **kw):
        calls.append(list(cmd))
        return real(cmd, *a, **kw)
    monkeypatch.setattr(native.subprocess, "check_call", record)
    path = native.build()
    build_dir = os.path.join(REPO, "build", "gpsat_tpu_torch")
    assert path == os.path.join(build_dir, "libhostops.so")
    assert os.path.isfile(path)
    (cmd,) = calls
    target = cmd[cmd.index("-o") + 1]
    assert os.path.dirname(target) == build_dir
    jax_dir = os.path.join(REPO, "gpsat_tpu") + os.sep
    assert not any(str(c).startswith(jax_dir) for c in cmd)
    assert cmd[cmd.index("-o") - 1] == os.path.join(
        REPO, "gpsat_tpu_torch", "native", "hostops.cpp")
    assert target != path and not os.path.exists(target)


def test_max_dist_bool_matches_numpy_and_jax(lib):
    rng = np.random.default_rng(0)
    locs = rng.uniform(-10, 10, (5000, 3))
    ref = np.array([1.0, -2.0, 0.5])
    got = native.max_dist_bool(locs, ref, 4.0)
    want = np.sum((locs - ref) ** 2, axis=1) < 16.0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_native.max_dist_bool(locs, ref,
                                                                4.0))


@pytest.mark.parametrize("nan_every", [17, 1])
def test_gaussian_2d_weight_matches_numpy_and_jax(lib, nan_every):
    """NaN sources skipped; an all-NaN field gives NaN everywhere."""
    rng = np.random.default_rng(1)
    n = 200
    x = rng.uniform(-5, 5, n)
    y = rng.uniform(-5, 5, n)
    x0 = rng.uniform(-6, 6, 60)
    y0 = rng.uniform(-6, 6, 60)
    vals = rng.standard_normal(n)
    vals[::nan_every] = np.nan
    got = native.gaussian_2d_weight(x0, y0, x, y, 2.0, 3.0, vals)
    ok = ~np.isnan(vals)
    want = np.full(len(x0), np.nan)
    for i in range(len(x0)):
        w = np.exp(-0.5 * (((x - x0[i]) / 2.0) ** 2
                           + ((y - y0[i]) / 3.0) ** 2))
        if ok.any():
            want[i] = np.sum(w[ok] * vals[ok]) / np.sum(w[ok])
    np.testing.assert_allclose(got, want, rtol=1e-12, equal_nan=True)
    np.testing.assert_allclose(
        got, jax_native.gaussian_2d_weight(x0, y0, x, y, 2.0, 3.0, vals),
        rtol=1e-12, equal_nan=True)


def test_weighted_merge_matches_numpy_and_jax(lib):
    rng = np.random.default_rng(2)
    n, g = 1000, 50
    group = rng.integers(0, g, n)
    d2 = rng.uniform(0, 9, n)
    v = rng.standard_normal(n)
    ls = 1.5
    sw, swv = native.weighted_merge_accumulate(group, d2, v, ls, g)
    w = np.exp(-d2 / (2 * ls**2))
    np.testing.assert_allclose(sw, np.bincount(group, w, g), rtol=1e-12)
    np.testing.assert_allclose(swv, np.bincount(group, w * v, g),
                               rtol=1e-12, atol=1e-12)
    jsw, jswv = jax_native.weighted_merge_accumulate(group, d2, v, ls, g)
    np.testing.assert_allclose(sw, jsw, rtol=1e-12)
    np.testing.assert_allclose(swv, jswv, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("rows, use_native, routed", [
    (150_000, True, True), (99_999, True, False), (150_000, False, False)])
def test_prediction_locations_routes_large_inputs_native(monkeypatch, lib,
                                                         rows, use_native,
                                                         routed):
    """100 000 rows or more go through the native helper (as
    gpsat_tpu/prediction_locations.py:24-37 does), fewer through numpy;
    both give numpy's mask and the JAX package's."""
    calls = []
    real = native.max_dist_bool

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(native, "max_dist_bool", counted)
    rng = np.random.default_rng(3)
    locs = rng.uniform(-10, 10, (rows, 2))
    got = prediction_locations.max_dist_bool(locs, np.zeros(2), 5.0,
                                             use_native=use_native)
    assert bool(calls) == routed
    np.testing.assert_array_equal(got,
                                  np.hypot(locs[:, 0], locs[:, 1]) < 5.0)
    from gpsat_tpu.prediction_locations import max_dist_bool as jax_mdb
    np.testing.assert_array_equal(got, jax_mdb(locs, np.zeros(2), 5.0))
