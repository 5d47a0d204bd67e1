"""The port's NLML value-only path (ops/cuda_gpr.nlml_value_batched,
models/exact_gpr.make_gpr_value_fun) against the JAX Pallas value kernel it
replaces (gpsat_tpu/ops/pallas_gpr.py::_value_kernel, run in interpret mode as
tests/test_pallas_gpr.py runs it) and against ops/gpr.nlml, on the cases of
tests/test_pallas_gpr.py, in f32 on the CPU, where the wrapper takes its
plain version. The CUDA kernel itself is held against the plain version on
the card by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gpsat_tpu.models.exact_gpr import make_gpr_value_fun as jax_value_fun
from gpsat_tpu.ops import pallas_gpr
from gpsat_tpu.ops.transforms import Sigmoid as JaxSigmoid
from gpsat_tpu.ops.transforms import Softplus as JaxSoftplus
from gpsat_tpu_torch.models.exact_gpr import make_gpr_value_fun
from gpsat_tpu_torch.ops import cuda_gpr
from gpsat_tpu_torch.ops import gpr as gpr_math
from gpsat_tpu_torch.ops.transforms import Sigmoid, Softplus

KERNELS = ["Matern32", "Matern12", "Matern52", "RBF", "Exponential"]
NAMES = ("lengthscales", "kernel_variance", "likelihood_variance")

torch.set_num_threads(1)


def make_case(B=5, N=200, D=3, seed=0):
    """The recipe of tests/test_pallas_gpr.py: one partly padded and one
    nearly empty expert."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-4, 4, (B, N, D))
    y = rng.standard_normal((B, N))
    mask = np.ones((B, N), bool)
    mask[0, N * 3 // 4:] = False
    mask[-2, 10:] = False
    params = {"lengthscales": rng.uniform(0.5, 3, (B, D)),
              "kernel_variance": rng.uniform(0.5, 2, B),
              "likelihood_variance": rng.uniform(0.01, 0.2, B)}
    return X, y, mask, params


def t32(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def torch_value(params, X, y, mask, kernel, jitter):
    return cuda_gpr.nlml_value_batched(
        {k: t32(v) for k, v in params.items()}, t32(X), t32(y), t32(mask),
        kernel, jitter).numpy()


def jax_value(params, X, y, mask, kernel, jitter):
    return np.asarray(pallas_gpr.nlml_value_batched(
        {k: jnp.asarray(v) for k, v in params.items()}, X, y,
        mask.astype(float), kernel, jitter, interpret=True))


def nlml_f32(params, X, y, mask, kernel, jitter):
    return gpr_math.nlml({k: t32(v) for k, v in params.items()}, t32(X),
                         t32(y), torch.as_tensor(mask), kernel=kernel,
                         jitter=jitter).numpy()


@pytest.mark.parametrize("kernel", KERNELS)
def test_value_matches_pallas_and_nlml(kernel):
    """rtol 2e-5, atol 1e-4 (tests/test_pallas_gpr.py:41)."""
    X, y, mask, params = make_case()
    before = cuda_gpr.nlml_value_batched.launches
    got = torch_value(params, X, y, mask, kernel, 1e-6)
    assert cuda_gpr.nlml_value_batched.launches == before   # no kernel ran
    assert got.shape == (5,) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_value(params, X, y, mask, kernel,
                                              1e-6), rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(got, nlml_f32(params, X, y, mask, kernel,
                                             1e-6), rtol=2e-5, atol=1e-4)


def test_value_n_multiple_of_panel():
    """N an exact panel multiple and B=7 (no multiple of the JAX expert
    group): rtol 2e-5, atol 1e-4."""
    X, y, mask, params = make_case(B=7, N=256, D=2, seed=1)
    got = torch_value(params, X, y, mask, "Matern32", 1e-6)
    np.testing.assert_allclose(got, jax_value(params, X, y, mask, "Matern32",
                                              1e-6), rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(got, nlml_f32(params, X, y, mask, "Matern32",
                                             1e-6), rtol=2e-5, atol=1e-4)


def test_value_non_pd_is_nan():
    """A wildly non-PD expert gives NaN (a rejected linesearch trial), the
    others stay finite."""
    X, y, mask, params = make_case(B=4, N=64, D=2, seed=2)
    params["likelihood_variance"] = np.array([-5.0, 0.1, 0.1, 0.1])
    got = torch_value(params, X, y, mask, "Matern32", 0.0)
    want = jax_value(params, X, y, mask, "Matern32", 0.0)
    assert np.isnan(got[0]) and np.isnan(want[0])
    assert np.isfinite(got[1:]).all()
    np.testing.assert_allclose(got[1:], want[1:], rtol=2e-5, atol=1e-4)


def test_value_scalar_lengthscale_broadcast():
    """A [B, 1] lengthscale with D > 1 is broadcast over the dimensions."""
    X, y, mask, params = make_case(B=5, N=64, D=2, seed=3)
    scalar = {**params, "lengthscales": params["lengthscales"][:, :1]}
    full = {**params, "lengthscales": np.repeat(scalar["lengthscales"], 2,
                                                axis=1)}
    got = torch_value(scalar, X, y, mask, "Matern32", 1e-6)
    np.testing.assert_array_equal(
        got, torch_value(full, X, y, mask, "Matern32", 1e-6))
    np.testing.assert_allclose(got, jax_value(scalar, X, y, mask, "Matern32",
                                              1e-6), rtol=2e-5, atol=1e-4)


def test_value_agrees_with_the_vg_kernels_value():
    """The value-only path and lane 0 of the value+gradient path are the same
    function: rtol 2e-5, atol 1e-3 (the vg value's tolerance)."""
    X, y, mask, params = make_case(seed=4)
    val, _ = cuda_gpr.nlml_vg_batched(
        {k: t32(v) for k, v in params.items()}, t32(X), t32(y), t32(mask),
        "Matern52", 1e-6)
    np.testing.assert_allclose(
        torch_value(params, X, y, mask, "Matern52", 1e-6), val.numpy(),
        rtol=2e-5, atol=1e-3)


def test_value_gate_and_devices():
    """cuda_value_supported keeps pallas_value_supported's shape limits
    (kernel list, D <= 5, N padded to 128 at most 1024); a tensor that is
    neither on the CPU nor on a card is refused."""
    for k in KERNELS + ["SquaredExponential"]:
        assert cuda_gpr.cuda_value_supported(k, 5, N=1024)
    assert cuda_gpr.cuda_value_supported("Matern32", 3)
    assert not cuda_gpr.cuda_value_supported("RationalQuadratic", 2, N=64)
    assert not cuda_gpr.cuda_value_supported("Matern32", 6, N=64)
    assert not cuda_gpr.cuda_value_supported("Matern32", 3, N=1025)
    X, y, mask, params = make_case(B=2, N=32, seed=6)
    with pytest.raises((ValueError, NotImplementedError, RuntimeError)):
        cuda_gpr.nlml_value_batched(
            {k: t32(v) for k, v in params.items()},
            torch.empty(2, 32, 3, device="meta"), t32(y), t32(mask),
            "Matern32", 0.0)
    counts = cuda_gpr.launch_counts()
    assert counts["nlml_value"] == 0 and counts["sgpr_vg_mega"] == 0
    assert len(counts) == 7


@pytest.mark.parametrize("free_names", [NAMES, ("lengthscales",
                                                "kernel_variance")])
def test_make_gpr_value_fun_matches_jax(free_names):
    """The bulk NLML evaluator over unconstrained vectors, with a Sigmoid
    constraint on the lengthscales and a fixed parameter, against the JAX one
    (interpret mode): rtol 2e-5, atol 1e-4; and against the port's objective
    (ops/gpr.nlml_fused) at the same u."""
    from gpsat_tpu.ops import pallas_gpr as pg
    from gpsat_tpu_torch.models.exact_gpr import make_gpr_objective
    B, D = 4, 3
    X, y, mask, params = make_case(B=B, N=96, D=D, seed=7)
    rng = np.random.default_rng(8)
    P = sum(D if n == "lengthscales" else 1 for n in free_names)
    u = rng.normal(0.0, 0.7, (B, P)).astype(np.float32)
    low, high = np.full((B, D), 0.05, np.float32), np.full((B, D), 9.0,
                                                           np.float32)
    fixed_np = {n: params[n].astype(np.float32) for n in NAMES
                if n not in free_names}

    jbij = {n: (JaxSigmoid(low=jnp.asarray(low), high=jnp.asarray(high))
                if n == "lengthscales"
                else JaxSoftplus(shift=jnp.zeros(B, jnp.float32)))
            for n in free_names}
    old = pg._INTERPRET
    pg._INTERPRET = True
    try:
        want = np.asarray(jax_value_fun("Matern32", free_names, D)(
            jnp.asarray(u), jnp.asarray(X, jnp.float32),
            jnp.asarray(y, jnp.float32), jnp.asarray(mask), jbij,
            {n: jnp.asarray(v) for n, v in fixed_np.items()}))
    finally:
        pg._INTERPRET = old

    tbij = {n: (Sigmoid(low=t32(low), high=t32(high))
                if n == "lengthscales" else Softplus(shift=torch.zeros(B)))
            for n in free_names}
    args = (t32(u), t32(X), t32(y), torch.as_tensor(mask), tbij,
            {n: t32(v) for n, v in fixed_np.items()})
    got = make_gpr_value_fun("Matern32", free_names, D)(*args)
    assert got.shape == (B,) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-4)
    objective, _ = make_gpr_objective("Matern32", free_names, D)
    with torch.no_grad():
        np.testing.assert_allclose(got.numpy(), objective(*args).numpy(),
                                   rtol=2e-5, atol=1e-3)
