"""The port's exact-GPR sweep engine (gpsat_tpu_torch BatchedGPR and its
L-BFGS) against the JAX engine on the same numpy inputs, on the CPU."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from gpsat_tpu.models.batched import BatchedGPR as JaxGPR
from gpsat_tpu.models.exact_gpr import make_gpr_objective as jax_objective
from gpsat_tpu.ops import lbfgs as jlbfgs
from gpsat_tpu.ops.transforms import Sigmoid as JaxSigmoid
from gpsat_tpu.ops.transforms import Softplus as JaxSoftplus
from gpsat_tpu_torch.models.batched import BatchedGPR as TorchGPR
from gpsat_tpu_torch.models.exact_gpr import make_gpr_objective, \
    make_gpr_vg_fun
from gpsat_tpu_torch.ops import cuda_gpr
from gpsat_tpu_torch.ops import lbfgs as tlbfgs
from gpsat_tpu_torch.ops.transforms import Sigmoid, Softplus
from gpsat_tpu_torch.weights import carry_from_jax, params_from_jax

NAMES = ("lengthscales", "kernel_variance", "likelihood_variance")


def workload(E, N, P, D=3, seed=0):
    """bench.make_workload's recipe, de-meaned."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-4.0, 4.0, (E, N, D))
    X[..., 2] = 0.0
    z = (0.4 * np.sin(X[..., 0] * 0.8) + 0.3 * np.cos(X[..., 1] * 0.6)
         + 0.05 * rng.standard_normal((E, N)))
    Xs = rng.uniform(-4.0, 4.0, (E, P, D))
    Xs[..., 2] = 0.0
    mask = np.ones((E, N), bool)
    mask[0, N - 8:] = False
    return X, z - z.mean(axis=1, keepdims=True), mask, Xs


def engine_kwargs(D=3):
    """The bench gpr engine configuration (bench.py:501-506)."""
    return dict(
        coords_dim=D, kernel="Matern32",
        constraints={"lengthscales": {"low": [0.01] * D, "high": [50.0] * D},
                     "likelihood_variance": {"low": 1e-5, "high": 1.0}},
        optim_kwargs={"max_iter": 250, "gtol": 1e-5, "ftol": 1e-9},
        jitter=1e-6)


def assert_same_sweep(got, want, obj_rtol=1e-6, pred_atol=1e-6):
    np.testing.assert_array_equal(got["iterations"], want["iterations"])
    np.testing.assert_array_equal(got["converged"], want["converged"])
    np.testing.assert_allclose(got["objective"], want["objective"],
                               rtol=obj_rtol)
    for k in ("f*", "f*_var", "y_var"):
        np.testing.assert_allclose(got["preds"][k], want["preds"][k],
                                   rtol=0, atol=pred_atol, err_msg=k)
    for k in NAMES:
        assert got["params"][k].shape == want["params"][k].shape


# ---------------------------------------------------------------------------
# L-BFGS step
# ---------------------------------------------------------------------------

def _step_setup(B=6, N=30, D=3, seed=3):
    X, y, mask, _ = workload(B, N, 1, D, seed)
    lo, hi = np.full((B, D), 0.01), np.full((B, D), 50.0)
    jobj, _ = jax_objective("Matern32", NAMES, D)
    tobj, _ = make_gpr_objective("Matern32", NAMES, D)
    jargs = (jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask),
             {"lengthscales": JaxSigmoid(jnp.asarray(lo), jnp.asarray(hi)),
              "kernel_variance": JaxSoftplus(jnp.zeros(B)),
              "likelihood_variance": JaxSigmoid(jnp.full(B, 1e-5),
                                                jnp.full(B, 1.0))}, {})
    t = torch.as_tensor
    targs = (t(X), t(y), t(mask),
             {"lengthscales": Sigmoid(t(lo), t(hi)),
              "kernel_variance": Softplus(torch.zeros(B, dtype=torch.float64)),
              "likelihood_variance": Sigmoid(t(np.full(B, 1e-5)),
                                             t(np.full(B, 1.0)))}, {})

    def jvg(x):
        return jax.vmap(lambda xi, ai: jax.value_and_grad(
            lambda u: jobj(u, *ai))(xi))(x, jargs)
    u0 = np.random.default_rng(seed).standard_normal((B, D + 2)) * 0.3
    steps = (jlbfgs._make_step(jvg, B, D + 2, jnp.float64, 250, 1e-5, 1e-9,
                               10, 12, 12),
             tlbfgs._make_step(tlbfgs._value_and_grad_of(tobj, targs), B,
                               D + 2, torch.float64, 250, 1e-5, 1e-9, 10, 12,
                               12))
    return jvg, u0, steps


def _assert_same_carry(tc, jc):
    assert tc.it == int(jc[0])
    for name, a, b in zip(tlbfgs.Carry._fields[1:], tc[1:], jc[1:]):
        b = np.asarray(b)
        if b.dtype == bool or np.issubdtype(b.dtype, np.integer):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-9, atol=1e-12,
                                       err_msg=name)


def test_make_step_matches_jax_from_identical_carries():
    """Twelve iterations, each started from the JAX carry: every field of the
    next carry agrees (booleans and counters exactly)."""
    jvg, u0, (jstep, tstep) = _step_setup()
    jstep = jax.jit(jstep)
    jc = jlbfgs._init_carry(jvg, jnp.asarray(u0), 1e-5, 10)
    for _ in range(12):
        tc = tstep(carry_from_jax(jc, device="cpu"))
        jc = jstep(jc)
        _assert_same_carry(tc, jc)


def test_refilled_slot_bootstraps_on_its_first_trial():
    """A pool-refilled slot (f=inf, g=0, iters=-1, zero history) accepts its
    unchanged point on the first trial and picks up (f0, g0) there."""
    jvg, u0, (jstep, tstep) = _step_setup()
    jc = jstep(jlbfgs._init_carry(jvg, jnp.asarray(u0), 1e-5, 10))
    c = carry_from_jax(jc, device="cpu")
    x_new = torch.as_tensor(u0[::-1].copy())
    ok = torch.zeros(u0.shape[0], dtype=torch.bool)
    ok[[1, 4]] = True
    c = c._replace(
        x=torch.where(ok[:, None], x_new, c.x),
        f=torch.where(ok, torch.tensor(torch.inf, dtype=c.f.dtype), c.f),
        g=torch.where(ok[:, None], 0.0, c.g),
        S=torch.where(ok[None, :, None], 0.0, c.S),
        Y=torch.where(ok[None, :, None], 0.0, c.Y),
        rho=torch.where(ok[None, :], 0.0, c.rho),
        gamma=torch.where(ok, 1.0, c.gamma),
        done=torch.where(ok, False, c.done),
        iters=torch.where(ok, -1, c.iters),
        t=torch.where(ok, 1.0, c.t))
    out = tstep(c)
    assert out.iters[ok].tolist() == [0, 0]
    assert torch.equal(out.x[ok], c.x[ok])
    assert torch.isfinite(out.f[ok]).all()
    assert not out.done[ok].any()
    assert (out.g[ok].abs().sum(dim=1) > 0).all()
    # the same pass through the JAX step
    jc2 = jstep(tuple(jnp.asarray(a.numpy()) if isinstance(a, torch.Tensor)
                      else jnp.asarray(a, jnp.int32) for a in c))
    _assert_same_carry(out, jc2)


def test_linesearch_policy_matches_jax():
    for dt, jdt in ((torch.float32, jnp.float32), (torch.float64,
                                                   jnp.float64)):
        for kind, n in (("gpr", 128), ("gpr", 400), ("sgpr", 400),
                        ("vff", 400), ("gpr", None)):
            assert tlbfgs.linesearch_policy(dt, kind, n) == \
                jlbfgs.linesearch_policy(jdt, kind, n)


# ---------------------------------------------------------------------------
# the sweep engine
# ---------------------------------------------------------------------------

def test_fit_predict_many_pool_matches_jax():
    """The slice as a whole: the pooled sweep in f64 with slots=8 < E=24, so
    slots refill. Objectives rtol 1e-6, predictions atol 1e-6, identical
    iterations, converged and pool iterations."""
    X, y, mask, Xs = workload(24, 40, 16, seed=1)
    jeng = JaxGPR(dtype=jnp.float64, **engine_kwargs())
    want = jeng.fit_predict_many(X, y, mask, Xs=Xs, slots=8)
    teng = TorchGPR(device="cpu", **engine_kwargs())
    assert teng.dtype == torch.float64
    got = teng.fit_predict_many(X, y, mask, Xs=Xs, slots=8)
    assert_same_sweep(got, want)
    assert teng._last_pool_iterations == jeng._last_pool_iterations
    assert got["converged"].all()


def test_fit_predict_matches_jax():
    """One bucket through fit_predict (batched_lbfgs one-shot) in f64."""
    X, y, mask, Xs = (a[:6] for a in workload(24, 40, 16, seed=1))
    want = JaxGPR(dtype=jnp.float64, **engine_kwargs()).fit_predict(
        X, y, mask, Xs=Xs)
    got = TorchGPR(device="cpu", **engine_kwargs()).fit_predict(
        X, y, mask, Xs=Xs)
    assert_same_sweep(got, want)


def _collapse_case():
    """Two experts with no signal: they collapse (kernel variance -> 0)."""
    X, y, mask, Xs = (a[:8] for a in workload(24, 40, 16, seed=1))
    y = y.copy()
    y[[2, 5]] = np.random.default_rng(9).standard_normal((2, 40)) * 1e-3
    return X, y, mask, Xs


def test_collapse_restart_matches_jax():
    """fit_predict restarts collapsed experts from the alternative point and
    keeps the better NLML, as the JAX engine does."""
    X, y, mask, Xs = _collapse_case()
    want = JaxGPR(dtype=jnp.float64, **engine_kwargs()).fit_predict(
        X, y, mask, Xs=Xs)
    got = TorchGPR(device="cpu", **engine_kwargs()).fit_predict(
        X, y, mask, Xs=Xs)
    assert_same_sweep(got, want)


def test_pool_collapse_restart_equals_fit_predict():
    """The pool's collapse-restart (on the failed subset only) gives each
    expert what fit_predict's whole-bucket restart gives it. (The JAX pool's
    restart cannot serve as the reference here: it writes into read-only
    numpy views of its results, see ROADMAP.md Queue C.)"""
    X, y, mask, Xs = _collapse_case()
    eng = TorchGPR(device="cpu", **engine_kwargs())
    whole = eng.fit_predict(X, y, mask, Xs=Xs)
    pooled = eng.fit_predict_many(X, y, mask, Xs=Xs, slots=3)
    assert_same_sweep(pooled, whole, obj_rtol=1e-12, pred_atol=1e-12)


def test_carried_parameters_give_the_same_predictions():
    """Both engines start from the JAX sweep's fitted parameters
    (params_from_jax) and predict without optimising."""
    X, y, mask, Xs = workload(10, 30, 6, seed=4)
    jeng = JaxGPR(dtype=jnp.float64, **engine_kwargs())
    fitted = jeng.fit_predict_many(X, y, mask, Xs=Xs, slots=4)["params"]
    carried = params_from_jax(fitted, device="cpu")
    want = jeng.fit_predict_many(X, y, mask, Xs=Xs, optimise=False,
                                 param_overrides=fitted)
    got = TorchGPR(device="cpu", **engine_kwargs()).fit_predict_many(
        X, y, mask, Xs=Xs, optimise=False,
        param_overrides={k: v.numpy() for k, v in carried.items()})
    assert_same_sweep(got, want, obj_rtol=1e-10, pred_atol=1e-10)
    for k in NAMES:
        np.testing.assert_allclose(got["params"][k], fitted[k], rtol=1e-12)


def test_kernel_path_on_cpu_follows_the_f64_engine(monkeypatch):
    """The card's control flow without a card: with the kernel path forced,
    an f32 engine runs the pool through make_gpr_vg_fun and the fill pass
    through posterior_predict_batched, whose plain versions run on the CPU
    (and launch nothing). It lands on the f64 engine's optima."""
    calls = {"vg": 0, "predict": 0}
    vg_plain, pr_plain = cuda_gpr._vg_lanes_plain, cuda_gpr._predict_plain

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped
    X, y, mask, Xs = workload(24, 40, 16, seed=1)
    ref = TorchGPR(device="cpu", **engine_kwargs()).fit_predict_many(
        X, y, mask, Xs=Xs, slots=8)

    monkeypatch.setattr(cuda_gpr, "_vg_lanes_plain", count("vg", vg_plain))
    monkeypatch.setattr(cuda_gpr, "_predict_plain",
                        count("predict", pr_plain))
    monkeypatch.setattr(cuda_gpr, "_FORCE_KERNEL_PATH", True)
    cuda_gpr.reset_launch_counts()
    eng = TorchGPR(device="cpu", dtype=torch.float32, **engine_kwargs())
    got = eng.fit_predict_many(X, y, mask, Xs=Xs, slots=8)
    assert calls["vg"] == eng._last_pool_iterations + 1
    assert calls["predict"] == 1          # one fill chunk covers E=24
    assert cuda_gpr.nlml_vg_batched.launches == 0
    assert cuda_gpr.posterior_predict_batched.launches == 0
    assert got["converged"].all()
    np.testing.assert_allclose(got["objective"], ref["objective"],
                               rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(got["preds"]["f*"], ref["preds"]["f*"],
                               atol=1e-2)


def test_fill_chunk_width_of_a_subclass_is_the_pool_width(monkeypatch):
    """The reference's guard (gpsat_tpu/models/batched.py, type(self) is
    BatchedGPR): on the kernel path BatchedGPR's own fill runs up to 1024
    experts a chunk through the prediction kernel; a subclass that does not
    choose its width gets the pool's, as without the kernel."""
    class Sub(TorchGPR):
        pass
    X, _, _, Xs = workload(4, 40, 16)
    monkeypatch.setattr(cuda_gpr, "_FORCE_KERNEL_PATH", True)
    for cls, want in ((TorchGPR, 512), (Sub, 7)):
        eng = cls(device="cpu", dtype=torch.float32, **engine_kwargs())
        assert eng._fill_chunk_width(300, X, Xs, 7, True) == want
        assert eng._fill_chunk_width(300, X, Xs, 7, False) == 7
    monkeypatch.setattr(cuda_gpr, "_FORCE_KERNEL_PATH", False)
    eng = TorchGPR(device="cpu", dtype=torch.float32, **engine_kwargs())
    assert eng._fill_chunk_width(300, X, Xs, 7, True) == 7


def test_vg_fun_chain_rule_matches_autograd():
    """make_gpr_vg_fun (kernel gradients + autograd.grad of the bijector
    map) agrees with autograd through the objective."""
    D = 3
    X, y, mask, _ = workload(5, 30, 1, seed=6)
    t = torch.as_tensor
    bij = {"lengthscales": Sigmoid(t(np.full((5, D), 0.01)),
                                   t(np.full((5, D), 50.0))),
           "kernel_variance": Softplus(torch.zeros(5, dtype=torch.float64))}
    fixed = {"likelihood_variance": torch.full((5,), 0.05,
                                               dtype=torch.float64)}
    names = ("lengthscales", "kernel_variance")
    u = t(np.random.default_rng(1).standard_normal((5, D + 1)) * 0.5)
    args = (t(X), t(y), t(mask), bij, fixed)
    val, g = make_gpr_vg_fun("Matern32", names, D)(u, *args)
    obj, _ = make_gpr_objective("Matern32", names, D)
    rval, rg = tlbfgs._value_and_grad_of(obj, args)(u)
    assert val.dtype == torch.float64
    np.testing.assert_allclose(val.numpy(), rval.numpy(), rtol=2e-5,
                               atol=1e-3)
    np.testing.assert_allclose(g.numpy(), rg.numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_engine_dtype_stays_put(dtype):
    """f32 stays f32 through the sweep (bijector bounds are f64 numpy)."""
    X, y, mask, Xs = workload(6, 20, 3, seed=7)
    eng = TorchGPR(device="cpu", dtype=dtype, **engine_kwargs())
    u0 = eng._unconstrained(eng._initial_params_batch(6), 6)
    assert u0.dtype == dtype
    for b in eng._batched_bijectors(6).values():
        for f in b._fields:
            assert getattr(b, f).dtype == dtype
    out = eng.fit_predict_many(X, y, mask, Xs=Xs, slots=2)
    assert out["preds"]["f*"].shape == (6, 3)
    assert np.isfinite(out["preds"]["f*"]).all()


# ---------------------------------------------------------------------------
# the cross-check engine (batched_lbfgs(engine="optax"))
# ---------------------------------------------------------------------------

def _quadratics(B=6, P=4, seed=0):
    """Convex quadratics 0.5 (x - c)^T A (x - c) + d, A SPD, per expert."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, P, P))
    A = M @ M.transpose(0, 2, 1) + 0.5 * np.eye(P)
    return (rng.standard_normal((B, P)),
            (A, rng.standard_normal((B, P)), rng.standard_normal(B)))


def _jax_quadratic(x, A, c, d):
    r = x - c
    return 0.5 * r @ A @ r + d


def _torch_quadratic(x, A, c, d):
    r = x - c
    return 0.5 * torch.einsum("bi,bij,bj->b", r, A, r) + d


def _gpr_problems(E=8, N=30, D=3, seed=3):
    """E GPR NLMLs in both packages' batched_lbfgs args."""
    X, y, mask, _ = workload(E, N, 1, D, seed)
    lo, hi = np.full((E, D), 0.01), np.full((E, D), 50.0)
    jbij = {"lengthscales": JaxSigmoid(jnp.asarray(lo), jnp.asarray(hi)),
            "kernel_variance": JaxSoftplus(jnp.zeros(E)),
            "likelihood_variance": JaxSigmoid(jnp.full(E, 1e-5),
                                              jnp.full(E, 1.0))}
    t = torch.as_tensor
    tbij = {"lengthscales": Sigmoid(t(lo), t(hi)),
            "kernel_variance": Softplus(torch.zeros(E, dtype=torch.float64)),
            "likelihood_variance": Sigmoid(t(np.full(E, 1e-5)),
                                           t(np.full(E, 1.0)))}
    u0 = np.random.default_rng(seed).standard_normal((E, D + 2)) * 0.3
    return u0, (X, y, mask), jbij, tbij


@pytest.mark.parametrize("problem", ["quadratics", "gpr"])
def test_optax_engine_reaches_the_jax_optax_optimum(problem):
    """engine="optax": one minimisation per expert (torch.optim.LBFGS with
    its strong-Wolfe search here, optax's zoom search in the JAX package:
    the steps differ, the optimum does not). Run to the tests' tight
    stopping rule (gtol 1e-9 on the quadratics, 1e-8 on the NLMLs, f-change
    1e-16), x agrees to 1e-6, f to 1e-9 relative, and every expert
    converges in both."""
    if problem == "quadratics":
        x0, args = _quadratics()
        jfun, tfun = _jax_quadratic, _torch_quadratic
        jargs = tuple(jnp.asarray(a) for a in args)
        targs = tuple(torch.as_tensor(a) for a in args)
        opts = dict(gtol=1e-9, ftol=1e-16)
    else:
        x0, data, jbij, tbij = _gpr_problems()
        jfun, _ = jax_objective("Matern32", NAMES, 3)
        tfun, _ = make_gpr_objective("Matern32", NAMES, 3)
        jargs = tuple(jnp.asarray(a) for a in data) + (jbij, {})
        targs = tuple(torch.as_tensor(a) for a in data) + (tbij, {})
        opts = dict(gtol=1e-8, ftol=1e-16, max_iter=500)
    want = jlbfgs.batched_lbfgs(jfun, jnp.asarray(x0), jargs,
                                engine="optax", **opts)
    got = tlbfgs.batched_lbfgs(tfun, torch.as_tensor(x0), targs,
                               engine="optax", **opts)
    assert got.x.dtype == torch.float64 and got.x.shape == x0.shape
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    assert got.converged.all()
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got.fun.numpy(), np.asarray(want.fun),
                               rtol=1e-9)
    assert (got.iterations.numpy() > 0).all()


def test_optax_engine_keeps_the_best_finite_point():
    """An objective that turns NaN past x = 1: the line search backs off
    from the NaN trials and the engine reports the best finite point (at
    the edge for the expert whose optimum lies beyond it)."""
    x0 = torch.tensor([[0.0], [0.0]], dtype=torch.float64)
    c = torch.tensor([[3.0], [-0.5]], dtype=torch.float64)

    def fun(x, c):
        f = ((x - c) ** 2).sum(dim=1)
        return torch.where(x[:, 0] > 1.0, torch.full_like(f, torch.nan), f)
    res = tlbfgs.batched_lbfgs(fun, x0, (c,), engine="optax", gtol=1e-9)
    assert torch.isfinite(res.fun).all() and (res.x[:, 0] <= 1.0).all()
    assert abs(float(res.x[0, 0]) - 1.0) < 1e-6
    assert abs(float(res.x[1, 0]) + 0.5) < 1e-6
    with pytest.raises(ValueError, match="engine"):
        tlbfgs.batched_lbfgs(fun, x0, (c,), engine="scipy")
