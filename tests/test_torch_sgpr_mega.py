"""Route "mega" of the port's fused SGPR value and gradient
(ops/cuda_sgpr.sgpr_vg_batched(route="mega"), the counterpart of
gpsat_tpu/ops/pallas_sgpr.py::_sgpr_vg_kernel) on the CPU, where the wrapper
takes its plain version: against the JAX monolithic kernel in interpret mode
(selected by its environment switch, as tests/test_pallas_sgpr.py does),
against the port's hybrid route, and through the engine. The CUDA kernels
themselves are held against the plain version on the card by
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from gpsat_tpu_torch.models.batched import BatchedSGPR
from gpsat_tpu_torch.ops import cuda_gpr, cuda_sgpr

from test_torch_sgpr import (KERNELS, NAMES, assert_vg_close, autograd_vg,
                             jax_vg, make_case, t32, torch_vg)
from test_torch_sgpr_engine import engine_kwargs, workload

torch.set_num_threads(1)


def test_mega_matches_the_jax_monolithic_kernel(monkeypatch):
    """The case of tests/test_pallas_sgpr.py's megakernel test (B=3, N=230,
    M=150, D=2): value rtol 2e-4 atol 1e-3, gradients rtol 5e-3 atol 5e-3,
    against the JAX kernel and against f64 autograd."""
    monkeypatch.setenv("GPSAT_SGPR_MEGAKERNEL", "1")
    X, y, mask, Z, zmask, params = make_case(B=3, N=230, M=150, D=2, seed=5)
    before = cuda_sgpr.sgpr_vg_mega.launches
    got = torch_vg("mega", params, X, y, mask, Z, zmask, "Matern32")
    assert cuda_sgpr.sgpr_vg_mega.launches == before        # no kernel ran
    assert_vg_close(got, jax_vg(params, X, y, mask, Z, zmask, "Matern32"))
    assert_vg_close(got, autograd_vg(params, X, y, mask, Z, zmask,
                                     "Matern32"))


@pytest.mark.parametrize("kernel", KERNELS)
def test_mega_matches_hybrid(kernel):
    """The two routes compute one function: value rtol 2e-4 atol 1e-3,
    gradients rtol 5e-3 atol 5e-3."""
    case = make_case()
    assert_vg_close(torch_vg("mega", *case[5:], *case[:5], kernel),
                    torch_vg("hybrid", *case[5:], *case[:5], kernel))


def test_mega_lanes_on_packed_inputs():
    """sgpr_vg_mega on the packed inputs gives the [B, 8] lanes that
    sgpr_vg_batched unpacks: lane 0 the value, 1..D d/dlog ls, 6 d/dlog sf2,
    7 d/ds2, zeros elsewhere; padded inducing rows add nothing (M=100 pads
    to 128, and doubling the padding changes no lane beyond rounding)."""
    X, y, mask, Z, zmask, params = make_case(B=4, N=150, M=100, D=2, seed=9)
    tp = {k: t32(v) for k, v in params.items()}
    Xp, Zp, m, zm, ls, _, sf2, s2, ybar = cuda_sgpr._prepare(
        tp, t32(X), t32(y), t32(mask), t32(Z), t32(zmask))
    packed = cuda_sgpr._pack_stream(Xp, m, ybar, Zp, zm, ls, sf2, s2)
    out = cuda_sgpr.sgpr_vg_mega(*packed, "Matern32", 2, 1e-6)
    assert out.shape == (4, 8) and out.dtype == torch.float32
    assert (out[:, 3:6] == 0).all()
    val, g = cuda_sgpr.sgpr_vg_batched(tp, t32(X), t32(y), t32(mask), t32(Z),
                                       t32(zmask), "Matern32", 1e-6,
                                       route="mega")
    assert torch.equal(val, out[:, 0])
    np.testing.assert_allclose(g["lengthscales"].numpy(),
                               (out[:, 1:3] / ls).numpy(), rtol=1e-6)
    np.testing.assert_allclose(g["kernel_variance"].numpy(),
                               (out[:, 6] / sf2).numpy(), rtol=1e-6)
    assert torch.equal(g["likelihood_variance"], out[:, 7])
    xt, yt, zt, p = packed
    zt2 = torch.cat([zt, torch.zeros(4, 8, 128)], dim=2)
    out2 = cuda_sgpr.sgpr_vg_mega(xt, yt, zt2, p, "Matern32", 2, 1e-6)
    np.testing.assert_allclose(out2.numpy(), out.numpy(), rtol=2e-4,
                               atol=1e-3)


def test_mega_gate():
    """Route "mega" keeps the data limit of the monolithic JAX kernel
    (pallas_sgpr.py:115-124 without the TPU VMEM clause): N padded at most
    4096, M padded at most 1024; the other routes stream any N."""
    ok = cuda_sgpr.sgpr_vg_supported
    assert cuda_sgpr.ROUTES == ("hybrid", "stream", "mega")
    assert ok("Matern32", 3, 2000, 500, route="mega")
    assert ok("Matern32", 3, 4096, 1024, route="mega")
    assert ok("Matern32", 3, None, 500, route="mega")
    assert not ok("Matern32", 3, 5000, 500, route="mega")
    assert not ok("Matern32", 3, 4097, 500, route="mega")
    assert ok("Matern32", 3, 5000, 500, route="stream")
    assert ok("Matern32", 3, 5000, 500)
    assert not ok("Matern32", 3, 2000, 1025, route="mega")
    assert not ok("Matern32", 6, 100, 50, route="mega")
    assert not ok("Cosine", 2, 100, 50, route="mega")
    rng = np.random.default_rng(0)
    X = t32(rng.uniform(-1, 1, (1, 5000, 2)))
    tp = {"lengthscales": torch.ones(1, 2), "kernel_variance": torch.ones(1),
          "likelihood_variance": torch.ones(1)}
    with pytest.raises(ValueError, match="gate"):
        cuda_sgpr.sgpr_vg_batched(tp, X, X[:, :, 0], torch.ones(1, 5000),
                                  X[:, :8], torch.ones(1, 8), "Matern32",
                                  1e-6, route="mega")


def test_engine_route_mega_lands_the_hybrid_optima(monkeypatch):
    """BatchedSGPR(route="mega") with the kernel path forced on the CPU runs
    the pool through sgpr_vg_batched(route="mega") once per trial and lands
    where the hybrid route does: same converged flags, ELBO rtol 1e-3 atol
    0.1, predictions atol 2e-2 (the tolerances the routes are held to
    against the f64 engine)."""
    calls = {"mega": 0}
    real = cuda_sgpr.sgpr_vg_mega

    def spy(*a, **k):
        calls["mega"] += 1
        return real(*a, **k)
    monkeypatch.setattr(cuda_sgpr, "sgpr_vg_mega", spy)
    monkeypatch.setattr(cuda_gpr, "_FORCE_KERNEL_PATH", True)
    X, y, mask, Xs = workload(12, 120, 16)
    kw = engine_kwargs(ls_high=5.0)
    outs = {}
    for route in ("hybrid", "mega"):
        eng = BatchedSGPR(device="cpu", dtype=torch.float32, route=route,
                          **kw)
        outs[route] = eng.fit_predict_many(X, y, mask, Xs=Xs, slots=4)
        if route == "hybrid":
            assert calls["mega"] == 0
        else:
            assert calls["mega"] == eng._last_pool_iterations + 1
    got, ref = outs["mega"], outs["hybrid"]
    assert got["converged"].all() and ref["converged"].all()
    np.testing.assert_array_equal(got["inducing_mask"], ref["inducing_mask"])
    np.testing.assert_allclose(got["objective"], ref["objective"], rtol=1e-3,
                               atol=0.1)
    for k in NAMES:
        assert got["params"][k].shape == ref["params"][k].shape
    np.testing.assert_allclose(got["preds"]["f*"], ref["preds"]["f*"],
                               atol=2e-2)
    with pytest.raises(ValueError, match="route"):
        BatchedSGPR(device="cpu", route="monolith", **kw)


def test_engine_route_mega_beyond_its_gate_takes_autograd(monkeypatch):
    """N beyond the mega route's data limit: the pool's objective falls back
    to autograd through ops/sgpr.neg_elbo (no vg_fun), as the JAX engine
    falls back to XLA; the other routes keep their fused vg_fun."""
    monkeypatch.setattr(cuda_gpr, "_FORCE_KERNEL_PATH", True)
    kw = engine_kwargs(M=16)
    mega = BatchedSGPR(device="cpu", dtype=torch.float32, route="mega", **kw)
    assert mega._pool_objective(N=5000)[1] is None
    assert mega._pool_objective(N=2000)[1] is not None
    stream = BatchedSGPR(device="cpu", dtype=torch.float32, route="stream",
                         **kw)
    assert stream._pool_objective(N=5000)[1] is not None
