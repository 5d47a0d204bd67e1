"""The port's CUDA kernels on the card, held against their plain PyTorch
versions, the engines' CUDA paths (exact GPR and SGPR) and the per-expert
models on the card. Every test here needs an NVIDIA GPU and skips without one. The file imports neither jax nor gpsat_tpu, so it runs on
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


@pytest.mark.parametrize("N", [1, 33, 400, 1000])
@pytest.mark.parametrize("B", [3, 140])
def test_vg_kernel_pads_to_its_tile_and_repeats(dev, N, B):
    """vg's factor runs on 64-wide tiles, so N is padded past the packing's
    32 inside the launch (1 -> 64, 33 -> 64, 400 -> 448, 1000 -> 1024); B
    below and above the card's SM count. Value rtol 2e-5 atol 1e-3,
    gradients rtol 2e-3 atol 2e-3 against the plain version; a second launch
    repeats the first bit for bit; one count per launch."""
    params, X, y, m, _ = make_case(dev, B=B, N=N, P=1, D=3, seed=N + B)
    params["likelihood_variance"] = params["likelihood_variance"] + 0.3
    before = cuda_gpr.nlml_vg_batched.launches
    got = cuda_gpr.nlml_vg_batched(params, X, y, m, "Matern32", 1e-6)
    assert cuda_gpr.nlml_vg_batched.launches == before + 1
    assert_vg_close(got, cuda_gpr.nlml_vg_batched_plain(params, X, y, m,
                                                        "Matern32", 1e-6))
    again = cuda_gpr.nlml_vg_batched(params, X, y, m, "Matern32", 1e-6)
    assert torch.equal(got[0], again[0])
    for k in got[1]:
        assert torch.equal(got[1][k], again[1][k]), k


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
    with pytest.raises(ValueError, match="gate"):
        cuda_gpr.nlml_value_batched(params, X, y, m, "RationalQuadratic", 0.0)
    params, X, y, m, _ = make_case(dev, B=1, N=1030, D=2)
    with pytest.raises(ValueError, match="gate"):
        cuda_gpr.nlml_value_batched(params, X, y, m, "Matern32", 0.0)
    xt = torch.zeros(1, 8, 1056, device=dev)
    with pytest.raises(ValueError, match="at most 1024"):
        cuda_gpr._vg_launch(xt, xt[:, 0].contiguous(),
                            torch.ones(1, 8, device=dev), "Matern32", 2)


@pytest.mark.parametrize("kernel", KERNELS)
def test_value_kernel_matches_plain(dev, kernel):
    """The value-only kernel against its plain version and against the
    value+gradient kernel's value: rtol 2e-5, atol 1e-3, and bit for bit the
    latter; one launch."""
    params, X, y, m, _ = make_case(dev)
    before = cuda_gpr.nlml_value_batched.launches
    got = cuda_gpr.nlml_value_batched(params, X, y, m, kernel, 1e-6)
    assert cuda_gpr.nlml_value_batched.launches == before + 1
    assert got.shape == (6,) and got.dtype == torch.float32
    want = cuda_gpr.nlml_value_batched_plain(params, X, y, m, kernel, 1e-6)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-5, atol=1e-3)
    val, _ = cuda_gpr.nlml_vg_batched(params, X, y, m, kernel, 1e-6)
    np.testing.assert_allclose(got.cpu().numpy(), val.cpu().numpy(),
                               rtol=2e-5, atol=1e-3)
    assert torch.equal(got, val)   # one factor, one finishing sum


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("B", [1, 48, 513])
def test_predict_and_value_on_the_bordered_factor(dev, kernel, B):
    """At the main path's widths (N=400 packed to 416 and padded to 448,
    P=400), B below, near and above the card's SM count and beyond the gpr
    sweep's 512: predict and value against their plain versions (rtol 1e-3
    atol 1e-4; rtol 2e-5 atol 1e-3), a second launch bit for bit the first,
    and the value kernel bit for bit the vg kernel's lane 0. The noise is
    raised by 0.3, as in test_vg_kernel_pads_to_its_tile_and_repeats: with
    make_case's noise down to 0.01 at N=400, a few of 513 experts are where
    f32 predictions (torch.linalg's and the kernel's alike) are off f64 by
    more than atol 1e-4, so two f32 versions part beyond it."""
    params, X, y, m, Xs = make_case(dev, B=B, N=400, P=400, seed=B)
    params["likelihood_variance"] = params["likelihood_variance"] + 0.3
    pr = cuda_gpr.posterior_predict_batched(params, X, y, m, Xs, kernel, 1e-6)
    assert_pred_close(pr, cuda_gpr.posterior_predict_batched_plain(
        params, X, y, m, Xs, kernel, 1e-6))
    again = cuda_gpr.posterior_predict_batched(params, X, y, m, Xs, kernel,
                                               1e-6)
    for k in pr:
        assert torch.equal(pr[k], again[k]), k
    val = cuda_gpr.nlml_value_batched(params, X, y, m, kernel, 1e-6)
    np.testing.assert_allclose(
        val.cpu().numpy(),
        cuda_gpr.nlml_value_batched_plain(params, X, y, m, kernel,
                                          1e-6).cpu().numpy(),
        rtol=2e-5, atol=1e-3)
    assert torch.equal(val, cuda_gpr.nlml_value_batched(params, X, y, m,
                                                        kernel, 1e-6))
    vg, _ = cuda_gpr.nlml_vg_batched(params, X, y, m, kernel, 1e-6)
    assert torch.equal(val, vg)


@pytest.mark.parametrize("N,D", [(5, 1), (37, 2), (128, 5), (256, 2),
                                 (1000, 2)])
def test_value_kernel_at_ragged_and_edge_shapes(dev, N, D):
    """Tile padding, N a panel multiple with B=7, and N near the gate."""
    params, X, y, m, _ = make_case(dev, B=7, N=N, P=1, D=D, seed=N)
    if N >= 1000:
        params["likelihood_variance"] = params["likelihood_variance"] + 0.3
    got = cuda_gpr.nlml_value_batched(params, X, y, m, "Matern32", 1e-6)
    want = cuda_gpr.nlml_value_batched_plain(params, X, y, m, "Matern32",
                                             1e-6)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-5, atol=1e-3)


def test_value_kernel_scalar_lengthscale_and_non_pd(dev):
    params, X, y, m, _ = make_case(dev, B=4, N=64, D=2, seed=3)
    params["lengthscales"] = params["lengthscales"][:, :1].contiguous()
    got = cuda_gpr.nlml_value_batched(params, X, y, m, "Matern32", 1e-6)
    want = cuda_gpr.nlml_value_batched_plain(params, X, y, m, "Matern32",
                                             1e-6)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-5, atol=1e-3)
    params["likelihood_variance"][0] = -5.0
    got = cuda_gpr.nlml_value_batched(params, X, y, m, "Matern32", 0.0)
    assert torch.isnan(got[0])
    assert torch.isfinite(got[1:]).all()


def test_bulk_nlml_on_the_card(dev):
    """make_gpr_value_fun on CUDA tensors goes through the value kernel once
    and agrees with make_gpr_vg_fun's value at the same u, bit for bit."""
    from gpsat_tpu_torch.models.exact_gpr import (make_gpr_value_fun,
                                                  make_gpr_vg_fun)
    from gpsat_tpu_torch.ops.transforms import Softplus
    names = ("lengthscales", "kernel_variance", "likelihood_variance")
    _, X, y, m, _ = make_case(dev, B=9, N=150)
    u = torch.as_tensor(np.random.default_rng(2).normal(0, 0.5, (9, 5)),
                        dtype=torch.float32, device=dev)
    bij = {n: Softplus(shift=torch.zeros(
        (9, 3) if n == "lengthscales" else 9, device=dev)) for n in names}
    args = (u, X, y, m.bool(), bij, {})
    before = cuda_gpr.nlml_value_batched.launches
    val = make_gpr_value_fun("Matern32", names, 3)(*args)
    assert cuda_gpr.nlml_value_batched.launches == before + 1
    want, _ = make_gpr_vg_fun("Matern32", names, 3)(*args)
    np.testing.assert_allclose(val.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-5, atol=1e-3)
    assert torch.equal(val, want)


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


def lbfgs_case(dev, E=24, N=60, D=3):
    """The engine test's E experts as the L-BFGS loops take them on the card
    (f32 u0 and args), with expert 0 walled in at its start: every trial
    point off it is NaN for that expert, so its line search fails, resets
    its history, fails again and ends it. Returns (u0, args, vg, eager): vg
    declares itself capturable (ops/lbfgs._capturable), eager is the same
    function without the declaration."""
    from gpsat_tpu_torch.models.batched import BatchedGPR
    from gpsat_tpu_torch.models.exact_gpr import make_gpr_vg_fun
    rng = np.random.default_rng(1)
    X = rng.uniform(-4, 4, (E, N, D))
    X[..., 2] = 0.0
    y = 0.4 * np.sin(X[..., 0] * 0.8) + 0.05 * rng.standard_normal((E, N))
    y = y - y.mean(axis=1, keepdims=True)
    eng = BatchedGPR(coords_dim=D, kernel="Matern32", constraints={
        "lengthscales": {"low": [0.01] * D, "high": [50.0] * D},
        "likelihood_variance": {"low": 1e-5, "high": 1.0}})
    u0 = eng._unconstrained(eng._initial_params_batch(
        E, y_var=y.var(axis=1)), E)
    poison = torch.zeros(E, dtype=torch.bool, device=dev)
    poison[0] = True
    args = (eng._tensor(X), eng._tensor(y),
            torch.ones(E, N, dtype=torch.bool, device=dev),
            eng._batched_bijectors(E), {}, poison, u0.clone())
    fused = make_gpr_vg_fun("Matern32", eng.free_names, D)

    def vg(u, X, y, mask, bij, fixed, poison, u_start):
        f, g = fused(u, X, y, mask, bij, fixed)
        off = poison & (u != u_start).any(dim=1)
        return (torch.where(off, torch.nan, f),
                torch.where(off[:, None], torch.nan, g))
    vg.capturable = True
    return u0, args, vg, lambda *a: vg(*a)


def run_lbfgs(loop, u0, args, vg_fun, mesh=None):
    """(result, launch counts, tracing records) of one L-BFGS loop on the
    card: the pool (8 slots), the one-shot loop, or the one-shot loop at
    max_iter 1, which its it_cap (1 x (8 + 2) iterations) ends."""
    from gpsat_tpu_torch import tracing
    from gpsat_tpu_torch.ops.lbfgs import batched_lbfgs, batched_lbfgs_pool
    kw = dict(max_iter=1 if loop == "it_cap" else 250, gtol=1e-5, ftol=1e-9,
              max_linesearch_steps=8, recovery_steps=4, vg_fun=vg_fun)
    cuda_gpr.reset_launch_counts()
    tracing.clear()
    with tracing.enable():
        res = batched_lbfgs_pool(None, u0, args, slots=8, mesh=mesh, **kw) \
            if loop == "pool" else batched_lbfgs(None, u0, args, **kw)
        torch.cuda.synchronize()
    recs = tracing.snapshot()
    tracing.clear()
    return res, cuda_gpr.launch_counts(), recs


def assert_same_lbfgs(got, want):
    for k in ("x", "fun", "converged", "iterations"):
        a, b = got[k], want[k]
        if a.is_floating_point():
            a, b = torch.nan_to_num(a), torch.nan_to_num(b)
        assert torch.equal(a, b), k


@pytest.mark.parametrize("loop", ["pool", "one-shot", "it_cap"])
def test_captured_lbfgs_equals_the_eager_loop(dev, loop):
    """The fused GPR objective's L-BFGS iteration replayed as a CUDA graph
    (ops/lbfgs._Iterations) against the same loop run eagerly, reached
    through a value_and_grad that does not declare itself capturable: every
    output bit for bit, on a pool level with refills and a history reset,
    the one-shot loop, and its it_cap stop. The launch counts agree but for
    the one iteration queued past the last live one (none where it_cap ends
    the loop); one capture, one replay an iteration after the first."""
    u0, args, vg, eager = lbfgs_case(dev)
    want, want_n, want_recs = run_lbfgs(loop, u0, args, eager)
    got, got_n, recs = run_lbfgs(loop, u0, args, vg)
    assert_same_lbfgs(got, want)
    assert int(want["iterations"][0]) == 0     # expert 0 ended by its fails
    replays = sum(r["counts"].get("graph_replays", 0) for r in recs)
    assert [r["name"] for r in recs].count("lbfgs.capture") == 1
    assert not any("graph_replays" in r["counts"] for r in want_recs)
    trailing = 0 if loop == "it_cap" else 1
    assert got_n == dict(want_n, nlml_vg=want_n["nlml_vg"] + trailing)
    if loop == "pool":
        assert got.pool_iterations == want.pool_iterations == replays
    elif loop == "it_cap":
        assert want_n["nlml_vg"] == 1 + 10 and replays == 10 - 1
        assert not bool(want["converged"].any())


def test_captured_lbfgs_runs_after_eager_work_cached_the_card(dev):
    """A capture takes new memory from the device, and the caching allocator
    cannot free its cache while capturing: with the card's memory held in
    the cache by eager work that ended (all but a few MiB), the captured
    pool still runs (ops/cuda_gpr.CapturedGraph gives the cache back first)
    and ends every expert as the eager pool."""
    u0, args, vg, eager = lbfgs_case(dev)
    want, _, _ = run_lbfgs("pool", u0, args, eager)
    hold = []
    try:
        # 1 GiB, 16 MiB, then 512 KiB blocks (2 MiB segments) until the
        # device has no segment left to give
        for size in (1 << 30, 1 << 24, 1 << 19):
            while True:
                try:
                    hold.append(torch.empty(size, dtype=torch.uint8,
                                            device=dev))
                except torch.cuda.OutOfMemoryError:
                    break
        assert torch.cuda.mem_get_info(dev)[0] < 4 << 20
        del hold[:]
        got, _, _ = run_lbfgs("pool", u0, args, vg)
    finally:
        del hold
        torch.cuda.empty_cache()
    assert_same_lbfgs(got, want)


def test_captured_mesh_equals_one_device(dev):
    """A two-shard mesh of cuda:0, each shard's pool captured on its own
    stream, ends every expert as the one-device captured pool, bit for
    bit."""
    from gpsat_tpu_torch.parallel.mesh import get_mesh
    u0, args, vg, _ = lbfgs_case(dev)
    one, _, _ = run_lbfgs("pool", u0, args, vg)
    two, _, recs = run_lbfgs("pool", u0, args, vg,
                             mesh=get_mesh(devices=["cuda:0", "cuda:0"]))
    assert_same_lbfgs(two, one)
    assert len(two.shard_pool_iterations) == 2
    assert [r["name"] for r in recs].count("lbfgs.capture") == 2


# ---------------------------------------------------------------------------
# SGPR: cholinv, the two stream kernels, the engine
# ---------------------------------------------------------------------------

def make_spd(dev, M, m_valid, seed=0):
    """Masked, well-conditioned SPD matrices (identity on the padded block),
    made on the card in f64 from a seeded generator."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    A = torch.zeros(len(m_valid), M, M, dtype=torch.float64, device=dev)
    for b, mv in enumerate(m_valid):
        G = torch.randn(mv, mv, generator=gen, dtype=torch.float64,
                        device=dev)
        A[b, :mv, :mv] = G @ G.T / mv + 0.5 * torch.eye(
            mv, dtype=torch.float64, device=dev)
        A[b, range(mv, M), range(mv, M)] = 1.0
    return A.float()


@pytest.mark.parametrize("B", [1, 48, 130])
@pytest.mark.parametrize("M", [128, 512, 1024])
def test_cholinv_matches_plain(dev, M, B):
    """W rtol 2e-3 atol 2e-3, ld rtol 1e-4 atol 1e-4; exact zeros below the
    diagonal; the input is left as it was; a second launch repeats the first
    bit for bit."""
    from gpsat_tpu_torch.ops import cuda_cholinv
    sizes = (M, M - 56, M // 2, M - 6, 1)
    A = make_spd(dev, M, [sizes[b % len(sizes)] for b in range(B)], seed=B)
    keep = A.clone()
    before = cuda_cholinv.cholinv_batched.launches
    W, ld = cuda_cholinv.cholinv_batched(A)
    assert cuda_cholinv.cholinv_batched.launches == before + 1
    Wp, ldp = cuda_cholinv.cholinv_batched_plain(A)
    np.testing.assert_allclose(W.cpu().numpy(), Wp.cpu().numpy(), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(ld.cpu().numpy(), ldp.cpu().numpy(), rtol=1e-4,
                               atol=1e-4)
    assert (W.tril(-1) == 0).all()
    assert torch.equal(A, keep)
    W2, ld2 = cuda_cholinv.cholinv_batched(A)
    assert torch.equal(W, W2) and torch.equal(ld, ld2)


@pytest.mark.parametrize("M,bad", [(256, 70), (512, 300)])
def test_cholinv_non_pd_and_gate(dev, M, bad):
    """A negative pivot (in tile column 1 at M=256, in a later tile column at
    M=512) spoils ld of its own matrix only; the others match the plain
    version."""
    from gpsat_tpu_torch.ops import cuda_cholinv
    A = make_spd(dev, M, (M, M - 56, M // 2))
    A[1, bad, bad] = -1.0
    W, ld = cuda_cholinv.cholinv_batched(A)
    assert not torch.isfinite(ld[1])
    Wp, ldp = cuda_cholinv.cholinv_batched_plain(A[[0, 2]])
    np.testing.assert_allclose(W[[0, 2]].cpu().numpy(), Wp.cpu().numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(ld[[0, 2]].cpu().numpy(), ldp.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="gate"):
        cuda_cholinv.cholinv_batched(A[:, :200, :200].contiguous())


def make_sgpr_case(dev, B=4, N=300, M=100, D=3, seed=0):
    """The recipe of tests/test_pallas_sgpr.py on the card: ragged data
    masks, prefix inducing masks, one expert with few valid points."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, (B, N, D))
    y = np.sin(X[..., 0]) + 0.1 * rng.standard_normal((B, N))
    mask = np.ones((B, N), bool)
    for b in range(B):
        mask[b, N - rng.integers(0, N // 3):] = False
    mask[-1, min(N, 40):] = False
    Z = np.zeros((B, M, D))
    zmask = np.zeros((B, M), bool)
    for b in range(B):
        valid = np.flatnonzero(mask[b])
        mv = min(M, len(valid)) - (2 if b == 1 else 0)
        Z[b, :mv] = X[b, rng.permutation(valid)[:mv]]
        zmask[b, :mv] = True

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)
    params = {"lengthscales": t(rng.uniform(0.7, 2.5, (B, D))),
              "kernel_variance": t(rng.uniform(0.5, 2.0, B)),
              "likelihood_variance": t(rng.uniform(0.05, 0.3, B))}
    return params, t(X), t(y), t(mask), t(Z), t(zmask)


@pytest.mark.parametrize("kernel,N,M,D", [
    ("Matern32", 300, 100, 3), ("Matern12", 230, 100, 3),
    ("Matern52", 230, 100, 3), ("RBF", 230, 100, 3),
    ("Exponential", 230, 100, 3), ("Matern32", 70, 30, 1),
    ("Matern32", 1100, 260, 2), ("Matern32", 150, 128, 5),
    ("Matern32", 2000, 1000, 2)])
@pytest.mark.parametrize("B", [1, 4, 48, 140])
def test_stream_kernels_match_plain(dev, kernel, N, M, D, B):
    """stream1 and stream2 against their plain versions on the same packed
    inputs (ragged N, M over one, three and eight 128-tiles, D=1 and 5, one
    to 48 experts): rtol 2e-3, atol 2e-3 of the largest entry; a second
    launch repeats the first bit for bit."""
    from gpsat_tpu_torch.ops import cuda_cholinv, cuda_sgpr
    params, X, y, m, Z, zm = make_sgpr_case(dev, B=B, N=N, M=M, D=D, seed=N)
    Xp, Zp, mf, zmf, ls, _, sf2, s2, ybar = cuda_sgpr._prepare(
        params, X, y, m, Z, zm)
    jitter = 1e-6 if M < 1000 else 1e-3
    Kuu = cuda_sgpr._kuu(Zp / ls[:, None, :], zmf, sf2, kernel, jitter)[0]
    W_u, ld = cuda_cholinv.cholinv_batched(Kuu)
    assert torch.isfinite(ld).all()
    xt, yt, zt, p = cuda_sgpr._pack_stream(Xp, mf, ybar, Zp, zmf, ls, sf2, s2)

    def close(a, b, name):
        b = b.cpu().numpy()
        np.testing.assert_allclose(a.cpu().numpy(), b, rtol=2e-3,
                                   atol=2e-3 * np.abs(b).max(), err_msg=name)
    before = (cuda_sgpr.sgpr_stream1.launches, cuda_sgpr.sgpr_stream2.launches)
    got = cuda_sgpr.sgpr_stream1(xt, yt, zt, p, W_u, kernel, D)
    want = cuda_sgpr._stream1_plain(xt, yt, zt, p, W_u, kernel, D)
    for a, b, name in zip(got, want, ("Bsum", "at", "trA2")):
        close(a, b, name)
    assert torch.equal(got[0], got[0].mT)
    Mp = zt.shape[2]
    W_B, _ = cuda_cholinv.cholinv_batched(
        want[0] + torch.eye(Mp, dtype=torch.float32, device=dev))
    c = (want[1][:, None, :] @ W_B)[:, 0, :]
    dd = (W_B @ c[:, :, None])[:, :, 0].contiguous()
    Pm = (W_B @ (W_B.mT @ want[0])).contiguous()
    g = cuda_sgpr.sgpr_stream2(xt, yt, zt, p, W_u, Pm, dd, kernel, D)
    close(g, cuda_sgpr._stream2_plain(xt, yt, zt, p, W_u, Pm, dd, kernel, D),
          "gout")
    assert torch.equal(g, cuda_sgpr.sgpr_stream2(xt, yt, zt, p, W_u, Pm, dd,
                                                 kernel, D))
    assert (cuda_sgpr.sgpr_stream1.launches,
            cuda_sgpr.sgpr_stream2.launches) == (before[0] + 1, before[1] + 2)


@pytest.mark.parametrize("slab", [128, 384])
@pytest.mark.parametrize("B", [4, 140])
def test_stream1_in_several_slabs(dev, slab, B, monkeypatch):
    """stream1 with its slab cut to 128 and 384 data columns, so N=1100
    (padded to 1152) runs in nine and three slabs (the last narrower), B
    below and above the SM count: Bsum, a~ and trA2 rtol 2e-3, atol 2e-3 of
    the largest entry against the plain version, against the one-slab launch
    to rounding (rtol 1e-5), and a second launch repeats the first bit for
    bit."""
    from gpsat_tpu_torch.ops import cuda_cholinv, cuda_sgpr
    params, X, y, m, Z, zm = make_sgpr_case(dev, B=B, N=1100, M=260, D=2,
                                            seed=B + slab)
    Xp, Zp, mf, zmf, ls, _, sf2, s2, ybar = cuda_sgpr._prepare(
        params, X, y, m, Z, zm)
    Kuu = cuda_sgpr._kuu(Zp / ls[:, None, :], zmf, sf2, "Matern32", 1e-6)[0]
    W_u, _ = cuda_cholinv.cholinv_batched(Kuu)
    xt, yt, zt, p = cuda_sgpr._pack_stream(Xp, mf, ybar, Zp, zmf, ls, sf2, s2)
    one = cuda_sgpr.sgpr_stream1(xt, yt, zt, p, W_u, "Matern32", 2)
    monkeypatch.setattr(cuda_sgpr, "_SLAB", slab)
    got = cuda_sgpr.sgpr_stream1(xt, yt, zt, p, W_u, "Matern32", 2)
    want = cuda_sgpr._stream1_plain(xt, yt, zt, p, W_u, "Matern32", 2)
    for a, b, c, name in zip(got, want, one, ("Bsum", "at", "trA2")):
        b = b.cpu().numpy()
        np.testing.assert_allclose(a.cpu().numpy(), b, rtol=2e-3,
                                   atol=2e-3 * np.abs(b).max(), err_msg=name)
        np.testing.assert_allclose(a.cpu().numpy(), c.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5 * np.abs(b).max(),
                                   err_msg=name)
    assert torch.equal(got[0], got[0].mT)
    again = cuda_sgpr.sgpr_stream1(xt, yt, zt, p, W_u, "Matern32", 2)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernel,N,M,D,B", [
    ("Matern32", 300, 100, 3, 4), ("Matern12", 230, 100, 3, 4),
    ("Matern52", 230, 100, 3, 4), ("RBF", 230, 100, 3, 4),
    ("Exponential", 230, 100, 3, 4), ("Matern32", 70, 30, 1, 4),
    ("Matern32", 1100, 260, 2, 4), ("Matern32", 150, 128, 5, 4),
    ("Matern32", 230, 150, 2, 4), ("Matern32", 2000, 1000, 2, 4),
    ("Matern32", 300, 100, 3, 140), ("Matern32", 400, 260, 2, 140),
    ("Matern32", 2000, 500, 3, 48), ("Matern52", 1100, 300, 3, 48),
    ("Matern32", 2000, 1000, 2, 8), ("Matern32", 1100, 1000, 2, 140)])
def test_mega_kernel_matches_plain(dev, kernel, N, M, D, B):
    """The one-launch value + gradient against its plain version on the same
    packed inputs: value rtol 2e-4 atol 1e-3, gradient lanes rtol 5e-3 and
    atol 5e-3 of the largest lane; a second launch repeats the first bit
    for bit; one count per call. Mp from 128 to 1024 with B = 4, Mp 128 and
    384 with B = 140 (above an H100's 132 SMs), the bench shape (B=48,
    N=2000, M=500) and Mp 384 at B=48, Mp 1024 at B = 8 and 140."""
    from gpsat_tpu_torch.ops import cuda_sgpr
    params, X, y, m, Z, zm = make_sgpr_case(dev, B=B, N=N, M=M, D=D, seed=N)
    Xp, Zp, mf, zmf, ls, _, sf2, s2, ybar = cuda_sgpr._prepare(
        params, X, y, m, Z, zm)
    xt, yt, zt, p = cuda_sgpr._pack_stream(Xp, mf, ybar, Zp, zmf, ls, sf2, s2)
    jitter = 1e-6 if M < 1000 else 1e-3
    before = (cuda_sgpr.sgpr_vg_mega.launches,
              cuda_sgpr.sgpr_stream1.launches)
    got = cuda_sgpr.sgpr_vg_mega(xt, yt, zt, p, kernel, D, jitter)
    want = cuda_sgpr._mega_plain(xt, yt, zt, p, kernel, D, jitter).cpu()
    assert got.shape == (B, 8)
    np.testing.assert_allclose(got[:, 0].cpu().numpy(), want[:, 0].numpy(),
                               rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(
        got[:, 1:].cpu().numpy(), want[:, 1:].numpy(), rtol=5e-3,
        atol=5e-3 * max(1.0, float(want[:, 1:].abs().max())))
    assert (got[:, 1 + D:6] == 0).all()
    assert torch.equal(got, cuda_sgpr.sgpr_vg_mega(xt, yt, zt, p, kernel, D,
                                                   jitter))
    assert (cuda_sgpr.sgpr_vg_mega.launches,
            cuda_sgpr.sgpr_stream1.launches) == (before[0] + 2, before[1])


def test_mega_kernel_above_the_sm_count(dev):
    """Route mega with B = 140 experts (more than an H100's 132 SMs), so its
    stream1 build takes several items a block: value rtol 2e-4 atol 1e-3,
    gradient lanes rtol 5e-3 and atol 5e-3 of the largest lane against the
    plain version; a second launch repeats the first bit for bit."""
    from gpsat_tpu_torch.ops import cuda_sgpr
    params, X, y, m, Z, zm = make_sgpr_case(dev, B=140, N=1100, M=260, D=2,
                                            seed=5)
    Xp, Zp, mf, zmf, ls, _, sf2, s2, ybar = cuda_sgpr._prepare(
        params, X, y, m, Z, zm)
    xt, yt, zt, p = cuda_sgpr._pack_stream(Xp, mf, ybar, Zp, zmf, ls, sf2, s2)
    got = cuda_sgpr.sgpr_vg_mega(xt, yt, zt, p, "Matern32", 2, 1e-6)
    want = cuda_sgpr._mega_plain(xt, yt, zt, p, "Matern32", 2, 1e-6).cpu()
    np.testing.assert_allclose(got[:, 0].cpu().numpy(), want[:, 0].numpy(),
                               rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(
        got[:, 1:].cpu().numpy(), want[:, 1:].numpy(), rtol=5e-3,
        atol=5e-3 * max(1.0, float(want[:, 1:].abs().max())))
    assert torch.equal(got, cuda_sgpr.sgpr_vg_mega(xt, yt, zt, p, "Matern32",
                                                   2, 1e-6))


def test_mega_outside_its_gate_raises_on_the_card(dev):
    from gpsat_tpu_torch.ops import cuda_sgpr
    params, X, y, m, Z, zm = make_sgpr_case(dev, B=1, N=4200, M=20, D=2)
    with pytest.raises(ValueError, match="gate"):
        cuda_sgpr.sgpr_vg_batched(params, X, y, m, Z, zm, "Matern32", 1e-6,
                                  route="mega")
    with pytest.raises(ValueError, match="gate"):
        cuda_sgpr.sgpr_vg_batched(params, X[:, :100], y[:, :100], m[:, :100],
                                  Z, zm, "Cosine", 1e-6, route="mega")
    xt = torch.zeros(1, 8, 100, device=dev)
    with pytest.raises(ValueError, match="padded"):
        cuda_sgpr.sgpr_vg_mega(xt, xt[:, 0], torch.zeros(1, 8, 128,
                                                         device=dev),
                               torch.ones(1, 8, device=dev), "Matern32", 2,
                               1e-6)


@pytest.mark.parametrize("route", ["hybrid", "stream", "mega"])
def test_sgpr_vg_and_predict_match_f64(dev, route):
    """Every route and the prediction on the card against autograd through
    ops/sgpr.neg_elbo and ops/sgpr.predict in f64 on the host: value rtol
    2e-4 atol 1e-3, gradients rtol 5e-3 atol 5e-3, predictions rtol 2e-3
    atol 2e-4 (the tolerances of tests/test_pallas_sgpr.py)."""
    from gpsat_tpu_torch.ops import cuda_sgpr
    from gpsat_tpu_torch.ops import sgpr as sgpr_math
    params, X, y, m, Z, zm = make_sgpr_case(dev, B=5, N=230, M=100, seed=5)
    val, g = cuda_sgpr.sgpr_vg_batched(params, X, y, m, Z, zm, "Matern32",
                                       1e-6, route=route)
    host = [a.double().cpu() for a in (X, y, m.bool(), Z, zm.bool())]
    pr = {k: v.double().cpu().requires_grad_(True) for k, v in params.items()}
    f = sgpr_math.neg_elbo(pr, *host, kernel="Matern32", jitter=1e-6)
    gs = torch.autograd.grad(f.sum(), list(pr.values()))
    np.testing.assert_allclose(val.cpu().numpy(), f.detach().numpy(),
                               rtol=2e-4, atol=1e-3)
    for k, want in zip(pr, gs):
        np.testing.assert_allclose(g[k].cpu().numpy(), want.numpy(),
                                   rtol=5e-3, atol=5e-3, err_msg=k)
    Xs = torch.as_tensor(np.random.default_rng(1).uniform(-2, 2, (5, 30, 3)),
                         dtype=torch.float32, device=dev)
    got = cuda_sgpr.sgpr_predict_batched(params, X, y, m, Z, zm, Xs,
                                         "Matern32", 1e-6)
    ref = sgpr_math.predict({k: v.detach() for k, v in pr.items()}, *host,
                            Xs.double().cpu(), kernel="Matern32", jitter=1e-6)
    for k in ("f*", "f*_var", "y_var"):
        np.testing.assert_allclose(got[k].cpu().numpy(), ref[k].numpy(),
                                   rtol=2e-3, atol=2e-4, err_msg=k)


@pytest.mark.parametrize("route", ["hybrid", "stream", "mega"])
def test_sgpr_engine_on_the_card_matches_the_host_engine(dev, route):
    """BatchedSGPR with no device runs on the card in f32, through the
    route's kernels, and lands on the f64 host engine's optima (ELBO rtol
    1e-3 atol 0.1, predictions atol 2e-2)."""
    from gpsat_tpu_torch.models.batched import BatchedSGPR
    rng = np.random.default_rng(1)
    E, N, P, D = 12, 120, 16, 3
    X = rng.uniform(-4, 4, (E, N, D))
    X[..., 2] = 0.0
    y = 0.4 * np.sin(X[..., 0] * 0.8) + 0.3 * np.cos(X[..., 1] * 0.6) \
        + 0.05 * rng.standard_normal((E, N))
    y = y - y.mean(axis=1, keepdims=True)
    Xs = rng.uniform(-4, 4, (E, P, D))
    Xs[..., 2] = 0.0
    mask = np.ones((E, N), bool)
    mask[0, 100:] = False
    kw = dict(coords_dim=D, kernel="Matern32", num_inducing_points=32,
              constraints={"lengthscales": {"low": [0.01] * D,
                                            "high": [5.0] * D},
                           "likelihood_variance": {"low": 1e-5, "high": 1.0}},
              optim_kwargs={"max_iter": 250, "gtol": 1e-5, "ftol": 1e-9})
    eng = BatchedSGPR(route=route, **kw)
    assert eng.device.type == "cuda" and eng.dtype == torch.float32
    cuda_gpr.reset_launch_counts()
    got = eng.fit_predict_many(X, y, mask, Xs=Xs, slots=4)
    counts = cuda_gpr.launch_counts()
    trials = eng._last_pool_iterations + 1
    # the mega route factors inside its own launch entry: only the fill
    # pass's prediction launches cholinv there
    assert counts["cholinv"] >= (2 if route == "mega" else 2 * trials + 2)
    assert counts["sgpr_stream1"] == counts["sgpr_stream2"] == \
        (trials if route == "stream" else 0)
    assert counts["sgpr_vg_mega"] == (trials if route == "mega" else 0)
    ref = BatchedSGPR(device="cpu", **kw).fit_predict_many(X, y, mask, Xs=Xs,
                                                           slots=4)
    assert got["converged"].all()
    np.testing.assert_array_equal(got["inducing_mask"], ref["inducing_mask"])
    np.testing.assert_allclose(got["objective"], ref["objective"], rtol=1e-3,
                               atol=0.1)
    np.testing.assert_allclose(got["preds"]["f*"], ref["preds"]["f*"],
                               atol=2e-2)


# ---------------------------------------------------------------------------
# per-expert models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["GPRModel", "SGPRModel"])
def test_per_expert_model_on_the_card_matches_the_host_model(dev, name):
    """A model with no device runs on the card in f32 and lands where the
    same model on the CPU in f64 does: predictions rtol 1e-3 atol 1e-4 (GPR)
    and rtol 5e-3 atol 5e-3 (SGPR), objective rtol 1e-3."""
    from gpsat_tpu_torch.models import get_model
    rng = np.random.default_rng(3)
    N, D = 200, 2
    X = rng.uniform(-4, 4, (N, D))
    y = 0.4 * np.sin(X[:, 0] * 0.8) + 0.3 * np.cos(X[:, 1] * 0.6) \
        + 0.05 * rng.standard_normal(N)
    Xs = rng.uniform(-4, 4, (20, D))
    extra = {"num_inducing_points": 50} if name == "SGPRModel" else {}
    cons = {"lengthscales": {"low": [0.01] * D, "high": [5.0] * D},
            "likelihood_variance": {"low": 1e-5, "high": 1.0}}
    out = {}
    for device in (None, "cpu"):
        model = get_model(name)(coords=X, obs=y, obs_mean="local",
                                device=device, **extra)
        model.set_parameter_constraints(cons, move_within_tol=True, tol=1e-2)
        model.optimise_parameters(max_iter=250, gtol=1e-5, ftol=1e-9)
        out[device] = (model, model.predict(Xs),
                       model.get_objective_function_value())
    model, preds, obj = out[None]
    assert model.device.type == "cuda" and model.dtype == torch.float32
    assert model.gpu_name == torch.cuda.get_device_name(0)
    rtol, atol = (1e-3, 1e-4) if name == "GPRModel" else (5e-3, 5e-3)
    for k in ("f*", "f*_var", "y_var"):
        np.testing.assert_allclose(preds[k], out["cpu"][1][k], rtol=rtol,
                                   atol=atol, err_msg=k)
    np.testing.assert_allclose(obj, out["cpu"][2], rtol=1e-3)


def test_sgpr_model_trains_inducing_points_on_the_card(dev):
    """train_inducing_points=True on the card in f32: autograd through
    ops/sgpr.neg_elbo, a few steps; the inducing points move, stay finite,
    and the ELBO does not get worse (a trial whose Kuu is not positive
    definite in f32 reads as NaN for the linesearch, it does not raise)."""
    from gpsat_tpu_torch.models.sgpr import SGPRModel
    rng = np.random.default_rng(5)
    X = rng.uniform(-4, 4, (150, 2))
    y = np.sin(X[:, 0]) + 0.1 * rng.standard_normal(150)
    model = SGPRModel(coords=X, obs=y, num_inducing_points=20)
    assert model.device.type == "cuda"
    Z0, before = model.get_inducing_points(), \
        model.get_objective_function_value()
    assert model.optimise_parameters(train_inducing_points=True,
                                     max_iter=5) in (True, False)
    Z1 = model.get_inducing_points()
    assert Z1.shape == Z0.shape and np.isfinite(Z1).all()
    assert np.abs(Z1 - Z0).max() > 1e-5
    assert model.get_objective_function_value() >= before


# sites that synchronise by uploading from the host, not by reading from the
# device: the engine's _tensor, a bijector's constants
UPLOAD_SITES = {("batched.py", "_tensor"), ("transforms.py", "forward"),
                ("transforms.py", "inverse")}


def synchronising_sites(work):
    """work() under torch.cuda's sync debug mode: [(file, function)] of the
    Python frame of each synchronising call it made, in order."""
    import traceback
    import warnings
    sites = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" not in str(message):
            return
        frame = [f for f in traceback.extract_stack()[:-1]
                 if not f.filename.endswith("warnings.py")][-1]
        sites.append((frame.filename.rsplit("/", 1)[-1], frame.name))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            work()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sites


@pytest.mark.parametrize("optimise", [True, False])
def test_host_reads_count_every_read_of_the_device(dev, monkeypatch,
                                                   optimise):
    """One level of execute_buckets on the card (the L-BFGS pool and the
    fill, or the chunked re-predict at fitted parameters): tracing's
    host_reads equals the synchronising calls that torch.cuda's sync debug
    mode reports at tracing.host, and every other synchronising call is an
    upload from the host."""
    from gpsat_tpu_torch import tracing
    from gpsat_tpu_torch.local_experts import execute_buckets, make_engine
    from gpsat_tpu_torch.models.exact_gpr import GPRModel
    from gpsat_tpu_torch.parallel import scheduler
    monkeypatch.setattr(scheduler, "auto_batch_size", lambda *a, **k: 16)
    rng = np.random.default_rng(11)
    X_list, obs_list, pred_list = [], [], []
    for n in rng.integers(140, 250, 40):
        X = rng.uniform(-4, 4, (n, 3))
        X_list.append(X)
        obs_list.append(np.sin(X[:, 0]) + 0.1 * rng.standard_normal(n))
        pred_list.append(rng.uniform(-4, 4, (50, 3)))
    eng = make_engine(GPRModel, {}, {"lengthscales": {"low": [0.05] * 3,
                                                      "high": [20.0] * 3}},
                      coords_dim=3, device=dev)
    fitted = execute_buckets(eng, X_list, obs_list, pred_list)
    assert [b["n_max"] for b in fitted["buckets"]] == [256]
    kw = {} if optimise else {"optimise": False,
                              "overrides": fitted["params"]}
    tracing.clear()
    out = {}

    def level():
        with tracing.enable():
            out.update(execute_buckets(eng, X_list, obs_list, pred_list,
                                       **kw))
    sites = synchronising_sites(level)
    reads = sum(r["counts"].get("host_reads", 0)
                for r in tracing.snapshot())
    tracing.clear()
    assert (out["buckets"][0]["pool_iterations"] > 0) == optimise
    assert reads > 0
    assert sites.count(("tracing.py", "host")) == reads
    others = {s for s in sites if s != ("tracing.py", "host")}
    assert others <= UPLOAD_SITES, others - UPLOAD_SITES


def test_sgpr_spans_hold_the_cards_reads_and_factors(dev):
    """Route hybrid on the card under the recorder: each sgpr_vg_batched
    call is one sgpr.vg span that reads nothing and counts the matrices its
    two cholinv launches factor; each sgpr_predict_batched call is one
    sgpr.predict span whose one synchronising call, the failed-expert check,
    is its one host_reads."""
    from gpsat_tpu_torch import tracing
    from gpsat_tpu_torch.ops import cuda_sgpr
    params, X, y, m, Z, zm = make_sgpr_case(dev)
    B = X.shape[0]
    Xs = torch.as_tensor(np.random.default_rng(2).uniform(-2, 2, (B, 30, 3)),
                         dtype=torch.float32, device=dev)
    tracing.clear()

    def calls():
        with tracing.enable():
            for _ in range(2):
                cuda_sgpr.sgpr_vg_batched(params, X, y, m, Z, zm, "Matern32",
                                          1e-6, route="hybrid")
                cuda_sgpr.sgpr_predict_batched(params, X, y, m, Z, zm, Xs,
                                               "Matern32", 1e-6)
    sites = synchronising_sites(calls)
    recs = tracing.snapshot()
    tracing.clear()
    vg = [r["counts"] for r in recs if r["name"] == "sgpr.vg"]
    pred = [r["counts"] for r in recs if r["name"] == "sgpr.predict"]
    assert vg == [{"cholinv_mats": 2 * B}] * 2
    assert [c["host_reads"] for c in pred] == [1, 1]
    # Kuu and B, and Kuu once more where an expert's factor failed
    assert all(c["cholinv_mats"] in (2 * B, 3 * B) for c in pred)
    assert sites.count(("tracing.py", "host")) == 2
