"""The port's SGPR sweep engine (gpsat_tpu_torch BatchedSGPR) against the JAX
engine on the same numpy inputs, on the CPU."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gpsat_tpu.models.batched import BatchedSGPR as JaxSGPR
from gpsat_tpu_torch.models.batched import BatchedGPR as TorchGPR
from gpsat_tpu_torch.models.batched import BatchedSGPR as TorchSGPR
from gpsat_tpu_torch.ops import cuda_gpr, cuda_sgpr
from gpsat_tpu_torch.profile_sweep import bench_sgpr_engine, sgpr_slots
from gpsat_tpu_torch.weights import inducing_from_jax, params_from_jax

NAMES = ("lengthscales", "kernel_variance", "likelihood_variance")

# many small ops per L-BFGS iteration: one thread per test worker is faster
# than every worker's intra-op pool contending for the same cores
torch.set_num_threads(1)


def workload(E, N, P, D=3, seed=1):
    """bench.make_workload's recipe (third coordinate 0), de-meaned, with one
    partly padded expert."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-4.0, 4.0, (E, N, D))
    X[..., 2] = 0.0
    z = (0.4 * np.sin(X[..., 0] * 0.8) + 0.3 * np.cos(X[..., 1] * 0.6)
         + 0.05 * rng.standard_normal((E, N)))
    Xs = rng.uniform(-4.0, 4.0, (E, P, D))
    Xs[..., 2] = 0.0
    mask = np.ones((E, N), bool)
    mask[0, N - N // 6:] = False
    return X, z - z.mean(axis=1, keepdims=True), mask, Xs


def engine_kwargs(D=3, M=32, max_iter=250, ls_high=50.0):
    """The bench sgpr engine configuration (bench.py:501-508) at a small M."""
    return dict(
        coords_dim=D, kernel="Matern32", num_inducing_points=M,
        constraints={"lengthscales": {"low": [0.01] * D,
                                      "high": [ls_high] * D},
                     "likelihood_variance": {"low": 1e-5, "high": 1.0}},
        optim_kwargs={"max_iter": max_iter, "gtol": 1e-5, "ftol": 1e-9},
        jitter=1e-6)


def assert_same_inducing(got, want):
    np.testing.assert_array_equal(got["inducing_mask"], want["inducing_mask"])
    np.testing.assert_array_equal(got["params"]["inducing_points"],
                                  want["params"]["inducing_points"])


def test_pool_sweep_matches_jax_step_for_step():
    """The slice as a whole, f64, slots=4 < E=12 so slots refill, stopped at
    25 accepted steps per expert, before rounding can part the two
    trajectories: the same Z, iterations, converged and pool iterations;
    ELBO rtol 1e-7, parameters rtol 1e-5, predictions atol 1e-7."""
    X, y, mask, Xs = workload(12, 120, 16)
    kw = engine_kwargs(max_iter=25)
    jeng = JaxSGPR(dtype=jnp.float64, **kw)
    want = jeng.fit_predict_many(X, y, mask, Xs=Xs, slots=4)
    teng = TorchSGPR(device="cpu", **kw)
    assert teng.dtype == torch.float64
    got = teng.fit_predict_many(X, y, mask, Xs=Xs, slots=4)
    assert_same_inducing(got, want)
    assert got["inducing_mask"][0].sum() == 32
    np.testing.assert_array_equal(got["iterations"], want["iterations"])
    np.testing.assert_array_equal(got["converged"], want["converged"])
    assert teng._last_pool_iterations == jeng._last_pool_iterations
    # the reported objective is the ELBO (the optimiser's value, sign flipped)
    np.testing.assert_allclose(got["objective"], want["objective"], rtol=1e-7)
    for k in NAMES:
        np.testing.assert_allclose(got["params"][k], want["params"][k],
                                   rtol=1e-5, err_msg=k)
    for k in ("f*", "f*_var", "y_var"):
        np.testing.assert_allclose(got["preds"][k], want["preds"][k], rtol=0,
                                   atol=1e-7, err_msg=k)


def test_pool_sweep_converges_to_the_jax_optima():
    """Run to convergence. The f64 ELBO is flat near its optimum and the two
    packages' trajectories part after some hundred iterations (their
    f-stagnation stops fall on different steps), so iteration counts are not
    compared; lengthscales are bounded at 5 so that the optimum is a point:
    ELBO rtol 1e-4, parameters atol 1e-2, predictions atol 1e-3."""
    X, y, mask, Xs = workload(12, 120, 16)
    kw = engine_kwargs(ls_high=5.0)
    want = JaxSGPR(dtype=jnp.float64, **kw).fit_predict_many(
        X, y, mask, Xs=Xs, slots=4)
    got = TorchSGPR(device="cpu", **kw).fit_predict_many(
        X, y, mask, Xs=Xs, slots=4)
    assert_same_inducing(got, want)
    assert got["converged"].all() and want["converged"].all()
    np.testing.assert_allclose(got["objective"], want["objective"], rtol=1e-4)
    for k in NAMES:
        np.testing.assert_allclose(got["params"][k], want["params"][k],
                                   atol=1e-2, err_msg=k)
    for k in ("f*", "f*_var", "y_var"):
        np.testing.assert_allclose(got["preds"][k], want["preds"][k], rtol=0,
                                   atol=1e-3, err_msg=k)


@pytest.mark.parametrize("train_z", [False, True])
def test_fit_predict_matches_jax(train_z):
    """One bucket through fit_predict (batched_lbfgs one-shot), fixed and
    trainable inducing points, 12 steps: ELBO rtol 1e-7, predictions atol
    1e-7, inducing points atol 1e-9."""
    X, y, mask, Xs = (a[:5] for a in workload(12, 60, 8))
    kw = engine_kwargs(M=10, max_iter=12)
    kw["optim_kwargs"]["train_inducing_points"] = train_z
    want = JaxSGPR(dtype=jnp.float64, **kw).fit_predict(X, y, mask, Xs=Xs)
    eng = TorchSGPR(device="cpu", **kw)
    got = eng.fit_predict(X, y, mask, Xs=Xs)
    assert eng.train_inducing_points is train_z
    np.testing.assert_array_equal(got["inducing_mask"], want["inducing_mask"])
    np.testing.assert_allclose(got["params"]["inducing_points"],
                               want["params"]["inducing_points"], atol=1e-9)
    np.testing.assert_array_equal(got["iterations"], want["iterations"])
    np.testing.assert_allclose(got["objective"], want["objective"], rtol=1e-7)
    for k in ("f*", "f*_var", "y_var"):
        np.testing.assert_allclose(got["preds"][k], want["preds"][k], rtol=0,
                                   atol=1e-7, err_msg=k)
    # trainable Z keeps the chunked one-shot path in fit_predict_many too
    assert eng._pool_supported(True) is (not train_z)


def test_carried_parameters_and_inducing_points_give_the_same_predictions():
    """Both engines predict, without optimising, from the JAX sweep's fitted
    hyperparameters and inducing points (params_from_jax,
    inducing_from_jax); the first expert's loaded Z differs from the seeded
    one. Predictions atol 1e-9."""
    X, y, mask, Xs = workload(6, 50, 7, seed=4)
    kw = engine_kwargs(M=12, max_iter=10)
    jeng = JaxSGPR(dtype=jnp.float64, **kw)
    fitted = jeng.fit_predict_many(X, y, mask, Xs=Xs, slots=2)
    ov = {k: np.array(fitted["params"][k]) for k in NAMES}
    Z = np.array(fitted["params"]["inducing_points"])
    Z[0] = X[0, :12]
    ov["inducing_points"] = Z
    want = jeng.fit_predict_many(X, y, mask, Xs=Xs, optimise=False,
                                 param_overrides=ov)
    Zt, zmt = inducing_from_jax(Z, fitted["inducing_mask"], device="cpu")
    assert Zt.dtype == torch.float64 and zmt.dtype == torch.bool
    carried = {k: v.numpy() for k, v in
               params_from_jax({k: ov[k] for k in NAMES}, device="cpu").items()}
    carried["inducing_points"] = Zt.numpy()
    got = TorchSGPR(device="cpu", **kw).fit_predict_many(
        X, y, mask, Xs=Xs, optimise=False, param_overrides=carried)
    np.testing.assert_array_equal(got["inducing_mask"], zmt.numpy())
    np.testing.assert_allclose(got["params"]["inducing_points"][0], Z[0])
    np.testing.assert_allclose(got["objective"], want["objective"], rtol=1e-9)
    for k in ("f*", "f*_var", "y_var"):
        np.testing.assert_allclose(got["preds"][k], want["preds"][k], rtol=0,
                                   atol=1e-9, err_msg=k)


@pytest.mark.parametrize("route", cuda_sgpr.ROUTES)
def test_kernel_path_on_cpu_follows_the_f64_engine(route, monkeypatch):
    """The card's control flow without a card: with the kernel path forced,
    an f32 engine runs the pool through make_sgpr_vg_fun ->
    sgpr_vg_batched(route) and the fill pass through sgpr_predict_batched,
    whose kernels' plain versions run on the CPU (and launch nothing). It
    lands on the f64 engine's optima: ELBO rtol 1e-3 atol 0.1, predictions
    atol 2e-2."""
    calls = {"vg": 0, "predict": 0, "stream1": 0, "stream2": 0}

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped
    X, y, mask, Xs = workload(12, 120, 16)
    kw = engine_kwargs(ls_high=5.0)
    ref = TorchSGPR(device="cpu", **kw).fit_predict_many(X, y, mask, Xs=Xs,
                                                         slots=4)
    for key, name in (("vg", "sgpr_vg_batched"),
                      ("predict", "sgpr_predict_batched"),
                      ("stream1", "_stream1_plain"),
                      ("stream2", "_stream2_plain")):
        monkeypatch.setattr(cuda_sgpr, name,
                            count(key, getattr(cuda_sgpr, name)))
    monkeypatch.setattr(cuda_gpr, "_FORCE_KERNEL_PATH", True)
    cuda_gpr.reset_launch_counts()
    eng = TorchSGPR(device="cpu", dtype=torch.float32, route=route, **kw)
    got = eng.fit_predict_many(X, y, mask, Xs=Xs, slots=4)
    assert calls["vg"] == eng._last_pool_iterations + 1
    assert calls["predict"] == 1          # one fill chunk covers E=12
    # the mega route's plain version is built from the stream kernels' plain
    # versions
    want_stream = calls["vg"] if route in ("stream", "mega") else 0
    assert calls["stream1"] == calls["stream2"] == want_stream
    assert not any(cuda_gpr.launch_counts().values())
    assert got["converged"].all()
    assert got["preds"]["f*"].dtype == np.float64     # host arrays
    np.testing.assert_allclose(got["objective"], ref["objective"], rtol=1e-3,
                               atol=0.1)
    np.testing.assert_allclose(got["preds"]["f*"], ref["preds"]["f*"],
                               atol=2e-2)


def test_f32_sweep_ends_where_f32_cannot_evaluate_the_bound(monkeypatch):
    """With lengthscales free up to 50 (the bench configuration) an f32
    sweep of either package stops by f-stagnation after some 20 steps at
    long lengthscales, where Kuu (jitter 1e-6) is near singular in f32: the
    ELBO an engine reports at its own optimum is then off from an f64
    evaluation at the same parameters by more than the rtol 5e-4 that holds
    at random hyperparameters. The JAX engine shows it (here beyond rtol
    1e-3 on one expert at N=1000, M=256), so the port, whose f32 engine is
    run through both routes of the kernel path, inherits it and does not
    add it: each route stays within rtol 5e-2 of f64, the limit the card's
    smoke test holds the sweep to, and within the JAX engine's own gap."""
    from gpsat_tpu_torch.ops import sgpr as sgpr_math
    X, y, mask, Xs = workload(2, 1000, 4)
    mask[:] = True
    kw = engine_kwargs(M=256)

    def gap(out):
        """Relative distance of the reported ELBO from an f64 evaluation at
        the fitted parameters, per expert; the fitted lengthscales."""
        t = torch.tensor
        params = {k: t(np.asarray(out["params"][k]), dtype=torch.float64)
                  for k in NAMES}
        Z = t(np.asarray(out["params"]["inducing_points"]),
              dtype=torch.float64)
        ref = -sgpr_math.neg_elbo(params, t(X), t(y), t(mask), Z,
                                  t(np.asarray(out["inducing_mask"])),
                                  kernel="Matern32", jitter=1e-6).numpy()
        assert np.isfinite(ref).all()
        return (np.abs(np.asarray(out["objective"]) - ref) / np.abs(ref),
                np.asarray(out["params"]["lengthscales"]))

    jax_gap, jax_ls = gap(JaxSGPR(dtype=jnp.float32, **kw).fit_predict_many(
        X, y, mask, Xs=Xs, slots=2))
    assert (jax_ls[:, :2] > 5.0).all()
    assert jax_gap.max() > 1e-3
    monkeypatch.setattr(cuda_gpr, "_FORCE_KERNEL_PATH", True)
    for route in cuda_sgpr.ROUTES:
        eng = TorchSGPR(device="cpu", dtype=torch.float32, route=route, **kw)
        out = eng.fit_predict_many(X, y, mask, Xs=Xs, slots=2)
        port_gap, port_ls = gap(out)
        assert out["converged"].all() and out["iterations"].max() < 40
        assert (port_ls[:, :2] > 5.0).all(), route
        assert port_gap.max() < 5e-2, route
        assert port_gap.max() < jax_gap.max(), route


def test_fill_chunk_width(monkeypatch):
    """The post-pool prediction-fill chunk width, as the JAX engine's:
    canonical bucket of E capped by the [B, M_pad, N] live-buffer budget, a
    multiple of 16, never below the pool width; the pool width on the
    ops/sgpr path and without predictions."""
    eng = TorchSGPR(coords_dim=3, num_inducing_points=500, device="cpu",
                    dtype=torch.float32)
    X = np.zeros((128, 2000, 3))
    assert eng._fill_chunk_width(128, X, None, 32, True) == 32  # ops/sgpr
    monkeypatch.setattr(cuda_gpr, "_FORCE_KERNEL_PATH", True)
    # bench profile: M_pad=512, N=2000 -> cap 2**27 // 1024000 = 131 -> 128
    assert eng._fill_chunk_width(128, X, None, 32, True) == 128
    assert eng._fill_chunk_width(40, X, None, 32, True) == 64
    assert eng._fill_chunk_width(8, X, None, 32, True) == 32
    Xbig = np.zeros((64, 16000, 3))
    w = eng._fill_chunk_width(64, Xbig, None, 8, True)
    assert w % 16 == 0 and w * 512 * 16000 * 4 <= 2**29
    assert eng._fill_chunk_width(128, X, None, 32, False) == 32


def test_bench_sgpr_engine_and_slot_rule():
    """profile_sweep's engine and slot rule are bench.py's (:507-508,
    :536-538): 48 slots at N=2000, M=500."""
    assert sgpr_slots(128, 2000, 500) == 48
    assert sgpr_slots(8, 2000, 500) == 8
    assert sgpr_slots(128, 400, 100) == 128
    eng = bench_sgpr_engine(3, 500, device="cpu", route="stream")
    assert (eng.num_inducing, eng.jitter, eng.route) == (500, 1e-6, "stream")
    assert (eng.max_iter, eng.gtol, eng.ftol) == (250, 1e-5, 1e-9)
    assert eng.param_shape("inducing_points") == (500, 3)
    with pytest.raises(ValueError, match="route"):
        bench_sgpr_engine(3, 500, device="cpu", route="fused")


def test_base_class_hooks_are_inert_for_gpr():
    """The pool hooks added to BatchedGPR for the SGPR engine change nothing
    for exact GPR (its sweep results are held by tests/test_torch_engine.py)."""
    eng = TorchGPR(coords_dim=2, device="cpu")
    assert eng._pool_supported(True) and not eng._pool_supported(False)
    assert eng._pool_extra_args(None, None, None) == ()
    assert eng._snapshot_state() is None
    out = {"objective": np.ones(2)}
    assert eng._pool_finalize(out) is out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_engine_dtype_stays_put(dtype):
    X, y, mask, Xs = workload(5, 30, 3, seed=7)
    eng = TorchSGPR(device="cpu", dtype=dtype, **engine_kwargs(M=8,
                                                               max_iter=5))
    out = eng.fit_predict_many(X, y, mask, Xs=Xs, slots=2)
    assert out["preds"]["f*"].shape == (5, 3)
    assert np.isfinite(out["preds"]["f*"]).all()
    assert eng._tensor(eng._Z).dtype == dtype
