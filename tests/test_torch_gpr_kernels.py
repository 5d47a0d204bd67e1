"""The port's fused-GPR kernel module (gpsat_tpu_torch/ops/cuda_gpr.py) against
the JAX Pallas kernels it replaces (gpsat_tpu/ops/pallas_gpr.py, run in
interpret mode as tests/test_pallas_gpr.py runs them), in f32 on the CPU,
where the wrappers take their plain versions. The CUDA kernels themselves are
held against the plain versions on the card by tests/test_torch_cuda.py."""

import re

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gpsat_tpu.ops import pallas_gpr
from gpsat_tpu_torch.ops import _build, cuda_gpr

KERNELS = ["Matern32", "Matern12", "Matern52", "RBF", "Exponential"]


def make_case(B=5, N=100, D=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-4, 4, (B, N, D)).astype(np.float32)
    y = rng.standard_normal((B, N)).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[0, N * 4 // 5:] = 0.0
    mask[-1, 10:] = 0.0           # nearly-empty expert
    params = {"lengthscales": rng.uniform(0.5, 3, (B, D)),
              "kernel_variance": rng.uniform(0.5, 2, B),
              "likelihood_variance": rng.uniform(0.01, 0.2, B)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    return X, y, mask, params


def _torch(*arrays):
    return [torch.as_tensor(np.array(a)) for a in arrays]


def _tparams(params):
    return {k: torch.as_tensor(np.array(v)) for k, v in params.items()}


def _jparams(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("kernel", KERNELS)
def test_vg_plain_matches_pallas(kernel):
    """Value: rtol 2e-5, atol 1e-3; gradients: rtol 2e-3, atol 2e-3
    (tests/test_pallas_gpr.py:137-142)."""
    X, y, mask, params = make_case()
    want_v, want_g = pallas_gpr.nlml_vg_batched(
        _jparams(params), X, y, mask, kernel, 1e-6, interpret=True)
    val, grads = cuda_gpr.nlml_vg_batched_plain(
        _tparams(params), *_torch(X, y, mask), kernel, 1e-6)
    np.testing.assert_allclose(val.numpy(), np.asarray(want_v), rtol=2e-5,
                               atol=1e-3)
    for k in want_g:
        assert grads[k].shape == want_g[k].shape, k
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(want_g[k]),
                                   rtol=2e-3, atol=2e-3,
                                   err_msg=f"{kernel}/{k}")


def test_vg_wrapper_on_cpu_is_the_plain_version():
    X, y, mask, params = make_case(B=3, N=40, seed=1)
    before = cuda_gpr.nlml_vg_batched.launches
    args = (_tparams(params), *_torch(X, y, mask), "Matern32", 1e-6)
    val, grads = cuda_gpr.nlml_vg_batched(*args)
    pval, pgrads = cuda_gpr.nlml_vg_batched_plain(*args)
    assert torch.equal(val, pval)
    for k in grads:
        assert torch.equal(grads[k], pgrads[k])
    assert cuda_gpr.nlml_vg_batched.launches == before   # no kernel ran


def test_vg_scalar_lengthscale_broadcast():
    """A [B, 1] lengthscale with D > 1 returns a [B, 1] gradient summing the
    per-dim contributions, as the JAX wrapper does."""
    X, y, mask, params = make_case(B=5, N=64, D=2, seed=3)
    params["lengthscales"] = params["lengthscales"][:, :1]
    want_v, want_g = pallas_gpr.nlml_vg_batched(
        _jparams(params), X, y, mask, "Matern32", 1e-6, interpret=True)
    val, grads = cuda_gpr.nlml_vg_batched_plain(
        _tparams(params), *_torch(X, y, mask), "Matern32", 1e-6)
    assert grads["lengthscales"].shape == (5, 1)
    np.testing.assert_allclose(val.numpy(), np.asarray(want_v), rtol=2e-5,
                               atol=1e-3)
    np.testing.assert_allclose(grads["lengthscales"].numpy(),
                               np.asarray(want_g["lengthscales"]),
                               rtol=2e-3, atol=2e-3)


def test_vg_non_pd_is_nan():
    X, y, mask, params = make_case(B=4, N=64, D=2, seed=2)
    params["likelihood_variance"] = np.array([-5.0, 0.1, 0.1, 0.1],
                                             np.float32)
    val, grads = cuda_gpr.nlml_vg_batched(
        _tparams(params), *_torch(X, y, mask), "Matern32", 0.0)
    assert np.isnan(val[0].item())
    assert torch.isfinite(val[1:]).all()
    assert torch.isfinite(grads["lengthscales"][1:]).all()


@pytest.mark.parametrize("kernel", ["Matern32", "RBF"])
def test_predict_plain_matches_pallas(kernel):
    """rtol 1e-3, atol 1e-4 (tests/test_pallas_gpr.py:261)."""
    X, y, mask, params = make_case(N=90, seed=4)
    Xs = np.random.default_rng(5).uniform(-4, 4, (5, 70, 3)).astype(
        np.float32)
    want = pallas_gpr.posterior_predict_batched(
        _jparams(params), X, y, mask, Xs, kernel, 1e-6, interpret=True)
    before = cuda_gpr.posterior_predict_batched.launches
    got = cuda_gpr.posterior_predict_batched(
        _tparams(params), *_torch(X, y, mask, Xs), kernel, 1e-6)
    assert cuda_gpr.posterior_predict_batched.launches == before
    for k in ("f*", "f*_var", "y_var"):
        assert got[k].shape == (5, 70)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-3, atol=1e-4, err_msg=k)
    assert (got["f*_var"] >= 0).all()


def test_gates_keep_the_jax_shape_limits():
    """Kernel list, D <= 5, N padded to 128 at most 1024, P padded to 128
    at most 2048 (pallas_gpr.py:566, :922 without the TPU VMEM clauses)."""
    for k in KERNELS + ["SquaredExponential"]:
        assert cuda_gpr.cuda_vg_supported(k, 5, N=1024)
    assert not cuda_gpr.cuda_vg_supported("RationalQuadratic", 2, N=64)
    assert not cuda_gpr.cuda_vg_supported("Matern32", 6, N=64)
    assert not cuda_gpr.cuda_vg_supported("Matern32", 3, N=1025)
    assert cuda_gpr.cuda_predict_supported("Matern32", 3, N=1024, P=2048)
    assert not cuda_gpr.cuda_predict_supported("Matern32", 3, N=400, P=2049)
    assert not cuda_gpr.cuda_predict_supported("Cosine", 3, N=400, P=400)
    assert set(cuda_gpr._KERNELS) == set(pallas_gpr._KERNELS)
    assert cuda_gpr._KERNELS == pallas_gpr._KERNELS


def test_wrappers_reject_other_devices():
    X, y, mask, params = make_case(B=2, N=32, seed=6)
    Xm = torch.empty(2, 32, 3, device="meta")
    with pytest.raises((ValueError, NotImplementedError, RuntimeError)):
        cuda_gpr.nlml_vg_batched(_tparams(params), Xm, *_torch(y, mask),
                                 "Matern32", 0.0)


def test_c_entry_points_match_their_ctypes_signatures():
    """Every entry _build binds exists in csrc with the same number of
    arguments; the sources compile only on the card."""
    cu, cuh = _build._sources()
    names = sorted(p.rsplit("/", 1)[-1] for p in cu + cuh)
    assert names == ["gp_cholinv.cu", "gp_common.cuh", "gp_predict.cu",
                     "gp_sgpr_common.cuh", "gp_sgpr_stream.cu",
                     "gp_sgpr_vg.cu", "gp_value.cu", "gp_vg.cu"]
    assert sorted(_build._SIGNATURES) == [
        "gp_cholinv_kernel_launch", "gp_cholinv_launch", "gp_predict_launch",
        "gp_sgpr_stream1_launch", "gp_sgpr_stream2_launch",
        "gp_sgpr_vg_launch", "gp_value_launch", "gp_vg_launch"]
    assert sorted(_build._WS_SIGNATURES) == [
        "gp_predict_ws_floats", "gp_sgpr_vg_ws_floats", "gp_value_ws_floats",
        "gp_vg_ws_floats"]
    text = "".join(open(p).read() for p in cu)
    for ret, table in (("int", _build._SIGNATURES),
                       ("long long", _build._WS_SIGNATURES)):
        for name, argtypes in table.items():
            m = re.search(r'extern "C" ' + ret + " " + name
                          + r"\(([^)]*)\)", text)
            assert m, name
            assert len(m.group(1).split(",")) == len(argtypes), name
    assert _build.BUILD_DIR.endswith("build/gpsat_tpu_torch")


def test_profile_sums_each_port_kernels_cuda_kernels():
    """profile_sweep's port_kernels_ms finds a kernel by the prefix of its
    name, template arguments with spaces included (vg's factor runs
    cholinv's step kernels on CiKernel<KID> at step 0)."""
    from gpsat_tpu_torch.profile_sweep import _by_family
    got = _by_family({
        "void gp_cholinv_diag_kernel<CiKernel<1> >(CiKernel<1>, float*)":
            (1000.0, 2),
        "void gp_cholinv_diag_kernel<CiMatrix>(CiMatrix, float*)": (500.0, 3),
        "gp_cholinv_inverse_kernel(float const*, float*, int, int)":
            (250.0, 1),
        "void gp_vg_grad_kernel<1>(float const*, float const*)": (2000.0, 1),
        "void at::native::vectorized_elementwise_kernel<4>(int)": (9.0, 9)})
    assert got == {"cholinv": {"ms": 1.75, "calls": 6},
                   "nlml_vg": {"ms": 2.0, "calls": 1}}
