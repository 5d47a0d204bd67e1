"""The port's SGPR math and fused paths (gpsat_tpu_torch ops/sgpr.py,
ops/cuda_cholinv.py, ops/cuda_sgpr.py) against the JAX package on the same
numpy inputs, on the CPU. The JAX Pallas kernels run in interpret mode, as in
the JAX package's own tests; the port's wrappers run their plain versions
(the tensors are on the CPU)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from gpsat_tpu.ops import sgpr as jsgpr
from gpsat_tpu_torch.ops import cuda_cholinv, cuda_sgpr
from gpsat_tpu_torch.ops import sgpr as tsgpr

KERNELS = ["Matern12", "Matern32", "Matern52", "RBF", "Exponential"]
NAMES = ("lengthscales", "kernel_variance", "likelihood_variance")

# many small ops per L-BFGS iteration: one thread per test worker is faster
# than every worker's intra-op pool contending for the same cores
torch.set_num_threads(1)


def make_case(B=5, N=230, M=100, D=3, seed=0, full_mask=False):
    """The recipe of tests/test_pallas_sgpr.py: ragged data masks, seeded
    random-subset inducing points with a prefix mask, one expert with fewer
    valid inducing points than M."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, (B, N, D))
    y = np.sin(X[..., 0]) + 0.3 * np.cos(X[..., 1]) \
        + 0.1 * rng.standard_normal((B, N))
    mask = np.ones((B, N), dtype=bool)
    if not full_mask:
        for b in range(B):
            mask[b, N - rng.integers(0, N // 3):] = False
    y = y - (y * mask).sum(1, keepdims=True) / mask.sum(1, keepdims=True)
    Z = np.zeros((B, M, D))
    zmask = np.zeros((B, M), dtype=bool)
    for b in range(B):
        valid = np.flatnonzero(mask[b])
        mv = min(M, len(valid)) - (2 if b == 1 else 0)
        sel = rng.permutation(valid)[:mv]
        Z[b, :mv] = X[b, sel]
        zmask[b, :mv] = True
    params = {
        "lengthscales": rng.uniform(0.7, 2.5, (B, D)),
        "kernel_variance": rng.uniform(0.5, 2.0, B),
        "likelihood_variance": rng.uniform(0.05, 0.3, B),
    }
    return X, y, mask, Z, zmask, params


def t32(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def j32(a):
    return jnp.asarray(a, jnp.float32)


def torch_vg(route, params, X, y, mask, Z, zmask, kernel, jitter=1e-6):
    val, g = cuda_sgpr.sgpr_vg_batched(
        {k: t32(v) for k, v in params.items()}, t32(X), t32(y), t32(mask),
        t32(Z), t32(zmask), kernel, jitter, route=route)
    return val.numpy(), {k: v.numpy() for k, v in g.items()}


def jax_vg(params, X, y, mask, Z, zmask, kernel, jitter=1e-6):
    from gpsat_tpu.ops.pallas_sgpr import sgpr_vg_batched
    val, g = sgpr_vg_batched(
        {k: j32(v) for k, v in params.items()}, X, y,
        mask.astype(np.float32), Z, zmask.astype(np.float32), kernel, jitter,
        interpret=True)
    return np.asarray(val), {k: np.asarray(v) for k, v in g.items()}


def autograd_vg(params, X, y, mask, Z, zmask, kernel, jitter=1e-6):
    """Value and gradient by torch autograd through ops/sgpr.neg_elbo, f64."""
    t = torch.as_tensor
    pr = {k: t(np.array(v, float)).requires_grad_(True)
          for k, v in params.items()}
    f = tsgpr.neg_elbo(pr, t(X), t(y), t(mask), t(Z), t(zmask),
                       kernel=kernel, jitter=jitter)
    g = torch.autograd.grad(f.sum(), [pr[k] for k in NAMES])
    return f.detach().numpy(), {k: v.numpy() for k, v in zip(NAMES, g)}


def assert_vg_close(got, want, vtol=(2e-4, 1e-3), gtol=(5e-3, 5e-3)):
    """Value rtol 2e-4 atol 1e-3, gradients rtol 5e-3 atol 5e-3 (the f32
    tolerances of tests/test_pallas_sgpr.py) unless given."""
    np.testing.assert_allclose(got[0], want[0], rtol=vtol[0], atol=vtol[1])
    for k in NAMES:
        assert got[1][k].shape == want[1][k].shape, k
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=gtol[0],
                                   atol=gtol[1], err_msg=k)


# ---------------------------------------------------------------------------
# ops/sgpr.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", KERNELS)
def test_neg_elbo_and_predict_match_jax(kernel):
    """f64, ragged data mask, one expert with mv < M: rtol 1e-9."""
    X, y, mask, Z, zmask, params = make_case(B=4, N=90, M=40)
    Xs = np.random.default_rng(1).uniform(-2, 2, (4, 11, 3))
    t = torch.as_tensor
    tp = {k: t(v) for k, v in params.items()}
    got = tsgpr.neg_elbo(tp, t(X), t(y), t(mask), t(Z), t(zmask),
                         kernel=kernel, jitter=1e-6)
    want = jax.vmap(lambda p, xi, yi, mi, zi, zmi: jsgpr.neg_elbo(
        p, xi, yi, mi, zi, zmi, kernel=kernel, jitter=1e-6))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(X),
        jnp.asarray(y), jnp.asarray(mask), jnp.asarray(Z), jnp.asarray(zmask))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)
    np.testing.assert_allclose(
        tsgpr.elbo(tp, t(X), t(y), t(mask), t(Z), t(zmask), kernel=kernel,
                   jitter=1e-6).numpy(), -np.asarray(want), rtol=1e-9)
    pr = tsgpr.predict(tp, t(X), t(y), t(mask), t(Z), t(zmask), t(Xs),
                       kernel=kernel, jitter=1e-6)
    jpr = jax.vmap(lambda p, xi, yi, mi, zi, zmi, xsi: jsgpr.predict(
        p, xi, yi, mi, zi, zmi, xsi, kernel=kernel, jitter=1e-6))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(X),
        jnp.asarray(y), jnp.asarray(mask), jnp.asarray(Z), jnp.asarray(zmask),
        jnp.asarray(Xs))
    for k in ("f*", "f*_var", "y_var"):
        np.testing.assert_allclose(pr[k].numpy(), np.asarray(jpr[k]),
                                   rtol=1e-9, atol=1e-12, err_msg=k)


def test_padded_inducing_rows_contribute_nothing():
    """Appending masked inducing rows leaves ELBO and predictions unchanged."""
    X, y, mask, Z, zmask, params = make_case(B=3, N=60, M=20)
    t = torch.as_tensor
    tp = {k: t(v) for k, v in params.items()}
    Z2 = np.concatenate([Z, np.ones((3, 7, 3))], axis=1)
    zm2 = np.concatenate([zmask, np.zeros((3, 7), bool)], axis=1)
    a = tsgpr.elbo(tp, t(X), t(y), t(mask), t(Z), t(zmask))
    b = tsgpr.elbo(tp, t(X), t(y), t(mask), t(Z2), t(zm2))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12)


# ---------------------------------------------------------------------------
# cholinv
# ---------------------------------------------------------------------------

def make_spd(M, m_valid, seed=0):
    rng = np.random.default_rng(seed)
    A = np.zeros((len(m_valid), M, M))
    for b, mv in enumerate(m_valid):
        G = rng.standard_normal((mv, mv))
        A[b, :mv, :mv] = G @ G.T / mv + np.eye(mv) * 0.5
        A[b, range(mv, M), range(mv, M)] = 1.0
    return A


@pytest.mark.parametrize("M", [128, 256])
def test_cholinv_matches_jax_interpret(M):
    """W rtol 2e-3 atol 2e-3, ld rtol 1e-4 atol 1e-4
    (tests/test_pallas_cholinv.py); exact zeros below the diagonal."""
    from gpsat_tpu.ops.pallas_cholinv import cholinv_batched as jax_cholinv
    A = make_spd(M, (M, M - 56, M // 2, M - 6, 1))
    W, ld = cuda_cholinv.cholinv_batched(t32(A))
    Wj, ldj = jax_cholinv(j32(A), interpret=True)
    assert W.dtype == torch.float32
    np.testing.assert_allclose(W.numpy(), np.asarray(Wj), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ldj), rtol=1e-4,
                               atol=1e-4)
    for b in range(A.shape[0]):
        L = np.linalg.cholesky(A[b])
        np.testing.assert_allclose(W[b].numpy(), np.linalg.inv(L.T),
                                   rtol=2e-3, atol=2e-3)
    assert (W.numpy()[:, np.tril(np.ones((M, M)), -1).astype(bool)] == 0).all()


def test_cholinv_non_pd_gives_non_finite_ld_for_that_matrix_only():
    A = make_spd(128, (128, 100, 64))
    A[1, 3, 3] = -1.0
    W, ld = cuda_cholinv.cholinv_batched_plain(t32(A))
    assert not np.isfinite(ld[1].item())
    assert torch.isfinite(ld[[0, 2]]).all()
    assert torch.isfinite(W[[0, 2]]).all()
    good, ldg = cuda_cholinv.cholinv_batched_plain(t32(A[[0, 2]]))
    np.testing.assert_array_equal(W[[0, 2]].numpy(), good.numpy())


def test_cholinv_gate_and_input_kept():
    assert cuda_cholinv.cholinv_supported(512)
    assert cuda_cholinv.cholinv_supported(1024)
    assert not cuda_cholinv.cholinv_supported(500)
    assert not cuda_cholinv.cholinv_supported(1152)
    A = t32(make_spd(128, (128, 90)))
    keep = A.clone()
    cuda_cholinv.cholinv_batched(A)
    assert torch.equal(A, keep)
    assert cuda_cholinv.cholinv_batched.launches == 0   # CPU: plain version


# ---------------------------------------------------------------------------
# value and gradient: both routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("route", cuda_sgpr.ROUTES)
def test_sgpr_vg_matches_autograd(route, kernel):
    case = make_case()
    assert_vg_close(torch_vg(route, *case[5:], *case[:5], kernel),
                    autograd_vg(case[5], *case[:5], kernel))


@pytest.mark.parametrize("route", cuda_sgpr.ROUTES)
def test_sgpr_vg_matches_jax_interpret(route, monkeypatch):
    """The JAX sgpr_vg_batched in interpret mode on the same inputs; its
    stream split is selected by the test's environment, as
    tests/test_pallas_sgpr.py does."""
    if route == "stream":
        monkeypatch.setenv("GPSAT_SGPR_STREAM", "1")
    X, y, mask, Z, zmask, params = make_case(seed=5)
    assert_vg_close(torch_vg(route, params, X, y, mask, Z, zmask, "Matern32"),
                    jax_vg(params, X, y, mask, Z, zmask, "Matern32"))


def test_sgpr_vg_multitile(monkeypatch):
    """N=1100, M=260, D=2: several data panels and M over two 128-tiles.
    Longer f32 accumulations on both sides: value rtol 5e-4 atol 2e-2,
    gradients rtol 1e-2 atol 1e-2 (tests/test_pallas_sgpr.py:110-114)."""
    monkeypatch.setenv("GPSAT_SGPR_STREAM", "1")
    X, y, mask, Z, zmask, params = make_case(B=3, N=1100, M=260, D=2, seed=3)
    want = autograd_vg(params, X, y, mask, Z, zmask, "Matern32")
    jx = jax_vg(params, X, y, mask, Z, zmask, "Matern32")
    for route in cuda_sgpr.ROUTES:
        got = torch_vg(route, params, X, y, mask, Z, zmask, "Matern32")
        assert_vg_close(got, want, (5e-4, 2e-2), (1e-2, 1e-2))
        assert_vg_close(got, jx, (5e-4, 2e-2), (1e-2, 1e-2))


@pytest.mark.parametrize("route", cuda_sgpr.ROUTES)
def test_sgpr_vg_scalar_lengthscale_broadcast(route):
    X, y, mask, Z, zmask, params = make_case(B=3, N=150, M=80, D=2, seed=4)
    params["lengthscales"] = params["lengthscales"][:, :1]
    val, g = torch_vg(route, params, X, y, mask, Z, zmask, "Matern32")
    assert g["lengthscales"].shape == (3, 1)
    pb = {**params,
          "lengthscales": np.broadcast_to(params["lengthscales"], (3, 2))}
    wval, wg = autograd_vg(pb, X, y, mask, Z, zmask, "Matern32")
    np.testing.assert_allclose(val, wval, rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(g["lengthscales"][:, 0],
                               wg["lengthscales"].sum(axis=1), rtol=5e-3,
                               atol=5e-3)


def test_sgpr_vg_gate_and_route_argument():
    assert cuda_sgpr.sgpr_vg_supported("Matern32", 3, 2000, 500)
    assert cuda_sgpr.sgpr_vg_supported("RBF", 5, None, 1024)
    assert not cuda_sgpr.sgpr_vg_supported("Matern32", 3, 2000, 1025)
    assert not cuda_sgpr.sgpr_vg_supported("Matern32", 6, 100, 50)
    assert not cuda_sgpr.sgpr_vg_supported("RationalQuadratic", 2, 100, 50)
    case = make_case(B=2, N=40, M=10)
    with pytest.raises(ValueError, match="route"):
        torch_vg("fused", case[5], *case[:5], "Matern32")
    with pytest.raises(ValueError, match="gate"):
        torch_vg("hybrid", case[5], *case[:5], "Cosine")


def test_tf32_is_off_inside_and_restored_after(monkeypatch):
    seen = []
    real = cuda_sgpr.cholinv_batched

    def spy(A):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(A)
    monkeypatch.setattr(cuda_sgpr, "cholinv_batched", spy)
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        case = make_case(B=2, N=40, M=10)
        torch_vg("hybrid", case[5], *case[:5], "Matern32")
        assert seen and not any(seen)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


# ---------------------------------------------------------------------------
# the stream kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

def _packed_stream_case(kernel, seed=2):
    """Packed inputs that both packages accept: B=8 (the JAX expert group),
    N=256 (128-lane tiles), M=128."""
    X, y, mask, Z, zmask, params = make_case(B=8, N=256, M=128, seed=seed)
    Xp, Zp, m, zm, ls, _, sf2, s2, ybar = cuda_sgpr._prepare(
        {k: t32(v) for k, v in params.items()}, t32(X), t32(y), t32(mask),
        t32(Z), t32(zmask))
    Kuu = cuda_sgpr._kuu(Zp / ls[:, None, :], zm, sf2, kernel, 1e-6)[0]
    W_u, _ = cuda_cholinv.cholinv_batched(Kuu)
    return cuda_sgpr._pack_stream(Xp, m, ybar, Zp, zm, ls, sf2, s2), W_u


@pytest.mark.parametrize("kernel", ["Matern32", "RBF"])
def test_stream_plain_versions_match_pallas_interpret(kernel):
    """_stream1_plain / _stream2_plain against _sgpr_stream1_call /
    _sgpr_stream2_call in interpret mode: rtol 2e-3, atol 2e-3 of the
    largest entry."""
    from gpsat_tpu.ops.pallas_sgpr import (_sgpr_stream1_call,
                                           _sgpr_stream2_call)
    (xt, yt, zt, p), W_u = _packed_stream_case(kernel)
    D = 3
    Bsum, at, trA2 = cuda_sgpr.sgpr_stream1(xt, yt, zt, p, W_u, kernel, D)
    jin = [jnp.asarray(a.numpy()) for a in (xt, yt, zt, p, W_u)]
    jB, jat, jtr = _sgpr_stream1_call(*jin, kernel=kernel, d=D,
                                      interpret=True)

    def close(a, b, name):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-3,
                                   atol=2e-3 * np.abs(b).max(), err_msg=name)
    close(Bsum, jB, "Bsum")
    close(at, jat, "at")
    close(trA2, jtr, "trA2")

    eye = torch.eye(128)
    W_B, _ = cuda_cholinv.cholinv_batched(Bsum + eye)
    c = (at[:, None, :] @ W_B)[:, 0, :]
    dd = (W_B @ c[:, :, None])[:, :, 0]
    Pm = W_B @ (W_B.mT @ Bsum)
    gout = cuda_sgpr.sgpr_stream2(xt, yt, zt, p, W_u, Pm, dd, kernel, D)
    jg = _sgpr_stream2_call(*jin, jnp.asarray(Pm.numpy()),
                            jnp.asarray(dd.numpy()), kernel=kernel, d=D,
                            interpret=True)
    assert gout.shape == (8, 8)
    close(gout[:, 1:1 + D], np.asarray(jg)[:, 1:1 + D], "d/dlog ls")
    close(gout[:, 6], np.asarray(jg)[:, 6], "d/dlog sf2")
    assert (gout[:, [0, 4, 5, 7]] == 0).all()
    assert cuda_sgpr.sgpr_stream1.launches == 0
    assert cuda_sgpr.sgpr_stream2.launches == 0


# ---------------------------------------------------------------------------
# prediction
# ---------------------------------------------------------------------------

def test_sgpr_predict_batched_matches_jax_interpret():
    """rtol 2e-3 atol 2e-4 (tests/test_pallas_sgpr.py:174), against the JAX
    hybrid in interpret mode and against ops/sgpr.predict in f64."""
    from gpsat_tpu.ops.pallas_sgpr import sgpr_predict_batched as jax_predict
    X, y, mask, Z, zmask, params = make_case(B=4, N=180, M=90, D=2, seed=6)
    Xs = np.random.default_rng(1).uniform(-2, 2, (4, 30, 2))
    got = cuda_sgpr.sgpr_predict_batched(
        {k: t32(v) for k, v in params.items()}, t32(X), t32(y), t32(mask),
        t32(Z), t32(zmask), t32(Xs), "Matern32", 1e-6)
    want = jax_predict({k: j32(v) for k, v in params.items()}, X, y,
                       mask.astype(np.float32), Z, zmask.astype(np.float32),
                       Xs, "Matern32", 1e-6, interpret=True)
    t = torch.as_tensor
    ref = tsgpr.predict({k: t(v) for k, v in params.items()}, t(X), t(y),
                        t(mask), t(Z), t(zmask), t(Xs), kernel="Matern32",
                        jitter=1e-6)
    for k in ("f*", "f*_var", "y_var"):
        assert got[k].dtype == torch.float32 and got[k].shape == (4, 30)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=2e-3, atol=2e-4, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   rtol=2e-3, atol=2e-4, err_msg=k)


def test_sgpr_predict_batched_near_singular_recovers(monkeypatch):
    """Long lengthscales make Kuu near rank 1: the experts whose first
    factorisation fails are refactored once with the escalated jitter and
    predictions stay finite."""
    calls = []
    real = cuda_sgpr.cholinv_batched

    def spy(A):
        out = real(A)
        calls.append(int((~torch.isfinite(out[1])).sum()))
        return out
    monkeypatch.setattr(cuda_sgpr, "cholinv_batched", spy)
    X, y, mask, Z, zmask, params = make_case(B=3, N=150, M=100, D=2, seed=8,
                                             full_mask=True)
    params["lengthscales"] = np.full((3, 2), 40.0)   # >> domain size
    Xs = np.random.default_rng(2).uniform(-2, 2, (3, 20, 2))
    got = cuda_sgpr.sgpr_predict_batched(
        {k: t32(v) for k, v in params.items()}, t32(X), t32(y), t32(mask),
        t32(Z), t32(zmask), t32(Xs), "Matern32", 1e-6)
    assert torch.isfinite(got["f*"]).all()
    assert torch.isfinite(got["f*_var"]).all()
    # Kuu, (the retry when any expert failed,) B
    assert len(calls) == (3 if calls[0] else 2)
    assert calls[-1] == 0
