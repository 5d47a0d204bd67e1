"""The port's CUDA kernels on the card, held against their plain PyTorch
versions, and the engine's CUDA path. Every test here needs an NVIDIA GPU and
skips without one. The file imports neither jax nor gpsat_tpu, so it runs on
a machine that has only torch:

    python -m pytest -o addopts="" --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gpsat_tpu_torch.ops import cuda_gpr

pytestmark = pytest.mark.cuda

KERNELS = ["Matern32", "Matern12", "Matern52", "RBF", "Exponential"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels compile with nvcc for "
                    "sm_90a and have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def make_case(dev, B=6, N=200, P=150, D=3, seed=0):
    rng = np.random.default_rng(seed)
    f32 = torch.float32

    def t(a):
        return torch.as_tensor(a, dtype=f32, device=dev)
    X = rng.uniform(-4, 4, (B, N, D))
    y = rng.standard_normal((B, N))
    mask = np.ones((B, N))
    mask[0, N * 3 // 4:] = 0.0
    mask[-1, min(N, 10):] = 0.0
    Xs = rng.uniform(-4, 4, (B, P, D))
    params = {"lengthscales": t(rng.uniform(0.5, 3, (B, D))),
              "kernel_variance": t(rng.uniform(0.5, 2, B)),
              "likelihood_variance": t(rng.uniform(0.01, 0.2, B))}
    return params, t(X), t(y), t(mask), t(Xs)


def assert_vg_close(got, want):
    (val, g), (pval, pg) = got, want
    np.testing.assert_allclose(val.cpu().numpy(), pval.cpu().numpy(),
                               rtol=2e-5, atol=1e-3)
    for k in g:
        assert g[k].shape == pg[k].shape, k
        np.testing.assert_allclose(g[k].cpu().numpy(), pg[k].cpu().numpy(),
                                   rtol=2e-3, atol=2e-3, err_msg=k)


def assert_pred_close(got, want):
    for k in ("f*", "f*_var", "y_var"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].cpu().numpy(),
                                   want[k].cpu().numpy(), rtol=1e-3,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernels_match_plain(dev, kernel):
    params, X, y, m, Xs = make_case(dev)
    before = (cuda_gpr.nlml_vg_batched.launches,
              cuda_gpr.posterior_predict_batched.launches)
    got = cuda_gpr.nlml_vg_batched(params, X, y, m, kernel, 1e-6)
    assert_vg_close(got, cuda_gpr.nlml_vg_batched_plain(params, X, y, m,
                                                        kernel, 1e-6))
    pr = cuda_gpr.posterior_predict_batched(params, X, y, m, Xs, kernel, 1e-6)
    assert_pred_close(pr, cuda_gpr.posterior_predict_batched_plain(
        params, X, y, m, Xs, kernel, 1e-6))
    assert (cuda_gpr.nlml_vg_batched.launches,
            cuda_gpr.posterior_predict_batched.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("N,P,D", [(5, 1, 1), (37, 33, 2), (128, 64, 5),
                                   (1000, 300, 2)])
def test_kernels_at_ragged_and_edge_shapes(dev, N, P, D):
    """Tile padding (N, P not multiples of 32), one dimension, five
    dimensions, and N near the gate's 1024."""
    params, X, y, m, Xs = make_case(dev, B=3, N=N, P=P, D=D, seed=N)
    if N >= 1000:
        params["likelihood_variance"] = params["likelihood_variance"] + 0.3
    assert_vg_close(
        cuda_gpr.nlml_vg_batched(params, X, y, m, "Matern32", 1e-6),
        cuda_gpr.nlml_vg_batched_plain(params, X, y, m, "Matern32", 1e-6))
    assert_pred_close(
        cuda_gpr.posterior_predict_batched(params, X, y, m, Xs, "Matern32",
                                           1e-6),
        cuda_gpr.posterior_predict_batched_plain(params, X, y, m, Xs,
                                                 "Matern32", 1e-6))


def test_scalar_lengthscale_and_non_pd(dev):
    params, X, y, m, _ = make_case(dev, B=4, N=64, D=2, seed=3)
    params["lengthscales"] = params["lengthscales"][:, :1].contiguous()
    val, g = cuda_gpr.nlml_vg_batched(params, X, y, m, "Matern32", 1e-6)
    assert g["lengthscales"].shape == (4, 1)
    assert_vg_close((val, g), cuda_gpr.nlml_vg_batched_plain(
        params, X, y, m, "Matern32", 1e-6))
    params["likelihood_variance"][0] = -5.0
    val, g = cuda_gpr.nlml_vg_batched(params, X, y, m, "Matern32", 0.0)
    assert torch.isnan(val[0])
    assert torch.isfinite(val[1:]).all()
    assert torch.isfinite(g["lengthscales"][1:]).all()


def test_outside_the_gate_raises_on_the_card(dev):
    params, X, y, m, _ = make_case(dev, B=2, N=40, D=3)
    with pytest.raises(ValueError, match="gate"):
        cuda_gpr.nlml_vg_batched(params, X, y, m, "RationalQuadratic", 0.0)


def test_engine_on_the_card_matches_the_host_engine(dev):
    """BatchedGPR with no device runs on the card in f32, through both
    kernels, and lands on the f64 host engine's optima."""
    from gpsat_tpu_torch.models.batched import BatchedGPR
    rng = np.random.default_rng(1)
    E, N, P, D = 24, 60, 16, 3
    X = rng.uniform(-4, 4, (E, N, D))
    X[..., 2] = 0.0
    y = 0.4 * np.sin(X[..., 0] * 0.8) + 0.3 * np.cos(X[..., 1] * 0.6) \
        + 0.05 * rng.standard_normal((E, N))
    y = y - y.mean(axis=1, keepdims=True)
    Xs = rng.uniform(-4, 4, (E, P, D))
    Xs[..., 2] = 0.0
    mask = np.ones((E, N), bool)
    kw = dict(coords_dim=D, kernel="Matern32",
              constraints={"lengthscales": {"low": [0.01] * D,
                                            "high": [50.0] * D},
                           "likelihood_variance": {"low": 1e-5, "high": 1.0}},
              optim_kwargs={"max_iter": 250, "gtol": 1e-5, "ftol": 1e-9})
    eng = BatchedGPR(**kw)
    assert eng.device.type == "cuda" and eng.dtype == torch.float32
    cuda_gpr.reset_launch_counts()
    got = eng.fit_predict_many(X, y, mask, Xs=Xs, slots=8)
    assert cuda_gpr.nlml_vg_batched.launches >= eng._last_pool_iterations + 1
    assert cuda_gpr.posterior_predict_batched.launches == 1
    ref = BatchedGPR(device="cpu", **kw).fit_predict_many(X, y, mask, Xs=Xs,
                                                          slots=8)
    assert got["converged"].all()
    np.testing.assert_allclose(got["objective"], ref["objective"],
                               rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(got["preds"]["f*"], ref["preds"]["f*"],
                               atol=1e-2)
