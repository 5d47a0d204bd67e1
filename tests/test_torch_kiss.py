"""The port's KISS-GP (gpsat_tpu_torch ops/ski.py, ops/ski_structured.py,
models/kiss_gpr.py) against the JAX package on the same numpy inputs, on the
CPU in f64.

Tolerances: the ops at 1e-10 (relative, with an absolute floor of 1e-10 for
values near zero). CG solves, the structured Adam fit (given the JAX
package's Hutchinson probes) and the dense L-BFGS fit follow the same
iterations to rounding: held at 1e-9, where K is well conditioned. Where
it is not (the model's start, noise 0.1 of var(y)), CG's unconverged
iterates amplify rounding, and what a CG solve to tol 1e-6 gives is held at
CG_TOL = 1e-6. Against dense algebra (the BTTB product against Kg v, the
sparse stencil against the dense W) at 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsat_tpu.models.kiss_gpr import KISSGPModel as JaxKISS
from gpsat_tpu.ops import ski as jski
from gpsat_tpu.ops import ski_structured as jskis
from gpsat_tpu.ops.transforms import Softplus as JaxSoftplus
from gpsat_tpu_torch.models import get_model
from gpsat_tpu_torch.models.kiss_gpr import KISSGPModel
from gpsat_tpu_torch.ops import ski
from gpsat_tpu_torch.ops import ski_structured as skis
from gpsat_tpu_torch.ops.kernels import KERNEL_NAMES, kernel_fn
from gpsat_tpu_torch.ops.transforms import Softplus
from gpsat_tpu_torch.weights import kiss_state_from_jax

# many small ops per CG and Adam step: one thread per test worker
torch.set_num_threads(1)

OPS_TOL = 1e-10
RUN_TOL = 1e-9
CG_TOL = 1e-6
KERNELS = ["Matern32", "RBF", "Matern12"]


def T(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def close(got, want, tol=OPS_TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def case(n=80, d=2, G=10, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, (n, d))
    y = np.sin(X[:, 0]) + 0.3 * np.cos(X[:, -1]) \
        + 0.1 * rng.standard_normal(n)
    starts, steps = jski.make_grid(X, G)
    params = {"lengthscales": rng.uniform(0.8, 1.6, d),
              "kernel_variance": np.asarray(1.3),
              "likelihood_variance": np.asarray(0.1)}
    return X, y, starts, steps, params


def jp(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def tp(params):
    return {k: T(v) for k, v in params.items()}


# ---------------------------------------------------------------------------
# the dense ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,ratio", [(64, 1, 1.0), (64, 2, 1.0),
                                       (600, 3, 1.0), (20000, 2, 1.0),
                                       (343, 3, 1.0), (100, 2, 2.5)])
def test_choose_grid_size_floors_as_jax(n, d, ratio):
    """The grid heuristic floors ratio * n^(1/d) exactly as the JAX package
    does (343^(1/3) is 6.999... in floats), and the model picks it."""
    X = np.zeros((n, d))
    want = jski.choose_grid_size(X, ratio=ratio)
    assert ski.choose_grid_size(X, ratio=ratio) == want
    assert ski.choose_grid_size(T(X), ratio=ratio) == want
    if n <= 600:
        rng = np.random.default_rng(n)
        Xr = rng.uniform(0, 1, (n, d))
        y = rng.standard_normal(n)
        port = KISSGPModel(coords=Xr, obs=y, grid_ratio=ratio, device="cpu")
        assert port.grid_size == JaxKISS(coords=Xr, obs=y[:, None],
                                         grid_ratio=ratio).grid_size == want


def test_interp_partition_of_unity_and_exact_at_nodes():
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (50, 2))
    starts, steps = ski.make_grid(X, 12)
    W = ski.interp_matrix(T(X), T(starts), T(steps), 12)
    close(W.sum(dim=1), np.ones(50), 1e-12)
    G = 9
    nodes = 0.25 * np.arange(2, 7)
    W1 = ski.interp_weights_1d(T(nodes), 0.0, 0.25, G).numpy()
    np.testing.assert_allclose(W1, np.eye(G)[2:7], atol=1e-12)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_interp_matrix_and_grid_points_match_jax(d):
    X, _, starts, steps, _ = case(n=40, d=d, G=8, seed=d)
    got = ski.interp_matrix(T(X), T(starts), T(steps), 8)
    close(got, jski.interp_matrix(jnp.asarray(X), starts, steps, 8))
    close(ski.grid_points(T(starts), T(steps), 8, d),
          jski.grid_points(jnp.asarray(starts), jnp.asarray(steps), 8, d))


def test_make_grid_keeps_the_data_dtype_f32_in_f32_out():
    X, y, _, _, params = case(n=60, d=2, G=10)
    X32 = X.astype(np.float32)
    starts, steps = ski.make_grid(X32, 10)
    assert starts.dtype == steps.dtype == np.float32
    W = ski.interp_matrix(T(X32, torch.float32), T(starts, torch.float32),
                          T(steps, torch.float32), 10)
    Zg = ski.grid_points(T(starts, torch.float32), T(steps, torch.float32),
                         10, 2)
    p32 = {k: T(v, torch.float32) for k, v in params.items()}
    val = ski.ski_nlml(p32, T(X32, torch.float32), T(y, torch.float32),
                       torch.ones(60, dtype=torch.bool), W, Zg, "Matern32")
    assert W.dtype == Zg.dtype == val.dtype == torch.float32


@pytest.mark.parametrize("kernel", KERNELS)
def test_ski_nlml_and_predict_match_jax_masked_and_padded(kernel):
    """ski_nlml on an expert with padded rows, and a batch of two through
    the leading axis; ski_predict on the padded expert; at 1e-10."""
    X, y, starts, steps, params = case(n=70, d=2, G=10, seed=3)
    mask = np.arange(70) < 55
    Xs = np.random.default_rng(4).uniform(-2, 2, (9, 2))
    W = jski.interp_matrix(jnp.asarray(X), starts, steps, 10)
    Zg = jski.grid_points(jnp.asarray(starts), jnp.asarray(steps), 10, 2)
    want = jski.ski_nlml(jp(params), jnp.asarray(X), jnp.asarray(y),
                         jnp.asarray(mask), W, Zg, kernel, jitter=1e-6)
    Wt = ski.interp_matrix(T(X), T(starts), T(steps), 10)
    Zt = ski.grid_points(T(starts), T(steps), 10, 2)
    got = ski.ski_nlml(tp(params), T(X), T(y), T(mask, torch.bool), Wt, Zt,
                       kernel, jitter=1e-6)
    close(got, want)
    # a batch of [padded, full] through the leading axis
    both = {k: torch.stack([T(v), T(v)]) for k, v in params.items()}
    mb = torch.stack([T(mask, torch.bool), torch.ones(70, dtype=torch.bool)])
    got2 = ski.ski_nlml(both, torch.stack([T(X)] * 2), torch.stack([T(y)] * 2),
                        mb, torch.stack([Wt] * 2), torch.stack([Zt] * 2),
                        kernel, jitter=1e-6)
    full = jski.ski_nlml(jp(params), jnp.asarray(X), jnp.asarray(y),
                         jnp.ones(70, bool), W, Zg, kernel, jitter=1e-6)
    close(got2, [float(want), float(full)])

    pw = jski.ski_predict(jp(params), jnp.asarray(X), jnp.asarray(y),
                          jnp.asarray(mask), jnp.asarray(Xs), W, Zg,
                          jnp.asarray(starts), jnp.asarray(steps), 10, kernel,
                          jitter=1e-6)
    pg = ski.ski_predict(tp(params), T(X), T(y), T(mask, torch.bool), T(Xs),
                         Wt, Zt, T(starts), T(steps), 10, kernel, jitter=1e-6)
    for k in ("f*", "f*_var", "y_var"):
        close(pg[k], pw[k])


# ---------------------------------------------------------------------------
# the structured ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", KERNEL_NAMES)
@pytest.mark.parametrize("d", [1, 2, 3])
def test_bttb_matvec_matches_jax_and_dense_grid_kernel(kernel, d):
    """The circulant embedding and the FFT product against JAX and against
    the dense Kg v, for every stationary kernel, on a batch of right-hand
    sides."""
    G = {1: 12, 2: 10, 3: 6}[d]
    X, _, starts, steps, params = case(n=30, d=d, G=G, seed=d + 10)
    femb = skis.grid_kernel_embed_fft(tp(params), T(steps), G, kernel, d)
    jfemb = jskis.grid_kernel_embed_fft(jp(params), steps, G, kernel, d)
    close(femb.real, np.real(jfemb))
    close(femb.imag, np.imag(jfemb))
    v = np.random.default_rng(2).standard_normal((3, G ** d))
    got = skis.bttb_matvec(femb, T(v), G, d)
    close(got, jskis.bttb_matvec(jfemb, jnp.asarray(v), G, d))
    Zg = ski.grid_points(T(starts), T(steps), G, d)
    Kg = kernel_fn(kernel)(Zg, Zg, T(params["lengthscales"]),
                           T(params["kernel_variance"]))
    close(got, T(v) @ Kg.mT)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_sparse_interp_matches_jax_and_dense(d):
    """apply (gather), apply_t (index_add_ on [R, N] right-hand sides) and
    apply_rowdiag against the JAX operator and the dense W."""
    G = {1: 14, 2: 10, 3: 7}[d]
    X, _, starts, steps, _ = case(n=50, d=d, G=G, seed=d + 20)
    sp = skis.SparseInterp(X, starts, steps, G)
    jsp = jskis.SparseInterp(X, starts, steps, G)
    np.testing.assert_array_equal(sp.flat_idx.numpy(),
                                  np.asarray(jsp.flat_idx))
    close(sp.cw, jsp.cw)
    Wd = ski.interp_matrix(T(X), T(starts), T(steps), G)
    rng = np.random.default_rng(4)
    u = rng.standard_normal((2, G ** d))
    close(sp.apply(T(u)), jsp.apply(jnp.asarray(u)))
    close(sp.apply(T(u)), T(u) @ Wd.mT)
    r = rng.standard_normal((3, len(X)))
    close(sp.apply_t(T(r)), jsp.apply_t(jnp.asarray(r)))
    close(sp.apply_t(T(r)), T(r) @ Wd)
    close(sp.apply_t(T(r[0])), T(r[0]) @ Wd)
    U = rng.standard_normal((len(X), G ** d))
    close(sp.apply_rowdiag(T(U)), jsp.apply_rowdiag(jnp.asarray(U)))
    close(sp.apply_rowdiag(T(U)), torch.sum(Wd * T(U), dim=1))


def structured_case(n=120, d=2, G=12, seed=5):
    X, y, starts, steps, params = case(n=n, d=d, G=G, seed=seed)
    return (X, y, starts, steps, params, skis.SparseInterp(X, starts, steps,
                                                           G),
            jskis.SparseInterp(X, starts, steps, G))


@pytest.mark.parametrize("tol,max_iter", [(1e-10, 400), (1e-10, 13),
                                          (1e-3, 400)])
def test_ski_matvec_and_cg_solve_match_jax(tol, max_iter):
    """ski_matvec at 1e-10; cg_solve converged, stopped by max_iter between
    two host checks, and at a loose tol, where the right-hand sides freeze
    at different iterations: the same iterates as the JAX while_loop. K is
    well conditioned here (noise 1.0): at noise 0.1 the iterates before
    convergence amplify rounding (the packages part by 1e-1 at iteration
    17, each run against itself by the same), so only a converged solve is
    comparable there."""
    X, y, starts, steps, params, sp, jsp = structured_case()
    params["likelihood_variance"] = np.asarray(1.0)
    G, d = 12, 2
    rng = np.random.default_rng(6)
    v = rng.standard_normal((4, len(y)))
    mv = lambda a: skis.ski_matvec(tp(params), sp, T(steps), G,  # noqa
                                   "Matern32", d, a, jitter=1e-4)
    jmv = lambda a: jskis.ski_matvec(jp(params), jsp, steps, G,  # noqa
                                     "Matern32", d, a, jitter=1e-4)
    close(mv(T(v)), jmv(jnp.asarray(v)))
    got = skis.cg_solve(mv, T(v), tol=tol, max_iter=max_iter)
    want = jskis.cg_solve(jmv, jnp.asarray(v), tol=tol, max_iter=max_iter)
    close(got, want, RUN_TOL)
    if max_iter == 400 and tol == 1e-10:
        Wd = ski.interp_matrix(T(X), T(starts), T(steps), G)
        Zg = ski.grid_points(T(starts), T(steps), G, d)
        Kg = kernel_fn("Matern32")(Zg, Zg, T(params["lengthscales"]),
                                   T(params["kernel_variance"]))
        K = Wd @ Kg @ Wd.mT + (1.0 + 1e-4) * torch.eye(len(y),
                                                        dtype=torch.float64)
        close(got, torch.linalg.solve(K, T(v).mT).mT, 1e-6)


def test_grad_surrogate_gradient_matches_jax_grad():
    """The stochastic NLML gradient reaches the lengthscales and kernel
    variance only through the FFT embedding: torch.autograd against jax.grad
    on the same detached alpha, probes and solves."""
    X, y, starts, steps, params, sp, jsp = structured_case(seed=7)
    G, d = 12, 2
    rng = np.random.default_rng(8)
    alpha = rng.standard_normal(len(y))
    probes = np.sign(rng.standard_normal((3, len(y))))
    solves = rng.standard_normal((3, len(y)))

    def jfun(p):
        return jskis._grad_surrogate(p, jsp, steps, G, "Matern32", d,
                                     jnp.asarray(alpha), jnp.asarray(probes),
                                     jnp.asarray(solves), 1e-4)
    want = jax.grad(jfun)(jp(params))
    leaves = {k: v.requires_grad_(True) for k, v in tp(params).items()}
    s = skis._grad_surrogate(leaves, sp, T(steps), G, "Matern32", d,
                             T(alpha), T(probes), T(solves), 1e-4)
    close(s, jfun(jp(params)))
    got = torch.autograd.grad(s, list(leaves.values()))
    for k, g in zip(leaves, got):
        close(g, want[k])


def jax_probes(n_probes, n, seed=0):
    """The JAX package's Hutchinson draw (ski_structured.py:230-231)."""
    return np.array(jnp.sign(jax.random.normal(
        jax.random.PRNGKey(seed), (n_probes, n), dtype=jnp.float64)))


@pytest.mark.parametrize("iterations", [1, 6])
def test_ski_fit_adam_follows_jax_step_for_step(iterations):
    """Given the JAX probes, the Adam fit lands where the JAX fit lands
    after 1 and after 6 steps."""
    X, y, starts, steps, _, _, _ = structured_case(n=150, seed=9)
    G = 12
    p0 = {"lengthscales": np.array([0.3, 0.3]),
          "kernel_variance": np.asarray(0.5),
          "likelihood_variance": np.asarray(0.5)}
    want, _ = jskis.ski_fit_adam(p0, {k: JaxSoftplus() for k in p0}, X, y,
                                 starts, steps, G, "Matern32",
                                 iterations=iterations, n_probes=4, seed=0)
    got, interp = skis.ski_fit_adam(p0, {k: Softplus() for k in p0}, X, T(y),
                                    starts, steps, G, "Matern32",
                                    iterations=iterations, n_probes=4,
                                    probes=jax_probes(4, len(y)))
    for k in p0:
        close(got[k], want[k], RUN_TOL)
    assert isinstance(interp, skis.SparseInterp)
    # the default probes are Rademacher draws of the asked shape
    z = skis.draw_probes(4, len(y), 0, torch.float64, "cpu")
    assert z.shape == (4, len(y)) and set(z.unique().tolist()) <= {-1.0, 1.0}


def test_ski_predict_cg_matches_jax_and_dense():
    X, y, starts, steps, params, sp, jsp = structured_case(seed=11)
    G = 12
    Xs = np.random.default_rng(12).uniform(-2, 2, (15, 2))
    got = skis.ski_predict_cg(tp(params), sp, X, T(y), Xs, starts, steps, G,
                              "Matern32", jitter=1e-4, cg_tol=1e-10,
                              cg_iters=400)
    want = jskis.ski_predict_cg(jp(params), jsp, X, y, Xs, starts, steps, G,
                                "Matern32", jitter=1e-4, cg_tol=1e-10,
                                cg_iters=400)
    Wt = ski.interp_matrix(T(X), T(starts), T(steps), G)
    Zt = ski.grid_points(T(starts), T(steps), G, 2)
    dense = ski.ski_predict(tp(params), T(X), T(y),
                            torch.ones(len(y), dtype=torch.bool), T(Xs), Wt,
                            Zt, T(starts), T(steps), G, "Matern32",
                            jitter=1e-4)
    for k in ("f*", "f*_var", "y_var"):
        close(got[k], want[k], RUN_TOL)
        close(got[k], dense[k], 1e-7)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def toy(n=40, d=1, seed=7):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (n, d))
    y = np.cos(4 * X[:, 0]) + 0.5 * np.sin(5 * X[:, -1]) \
        + 0.1 * rng.standard_normal(n)
    return X, y


def test_get_model_resolves_both_kiss_names():
    assert get_model("KISSGPModel") is KISSGPModel
    assert get_model("GPyTorchKISSGPModel") is KISSGPModel


def test_dense_model_fits_and_predicts_as_jax():
    """L-BFGS on the dense SKI NLML: the same optimum, objective and
    predictions as the JAX model, with lengthscale constraints."""
    X, y = toy(n=60, d=2, seed=3)
    Xs = np.random.default_rng(4).uniform(0.1, 0.9, (8, 2))
    jm = JaxKISS(coords=X, obs=y[:, None], kernel="Matern32", grid_size=12)
    pm = KISSGPModel(coords=X, obs=y[:, None], kernel="Matern32",
                     grid_size=12, device="cpu")
    assert not pm.structured and not jm.structured
    for m in (jm, pm):
        m.set_lengthscales_constraints(low=[0.05, 0.05], high=[3.0, 3.0])
    close(pm.get_objective_function_value(),
          jm.get_objective_function_value())
    assert pm.optimise_parameters(max_iter=200) == \
        jm.optimise_parameters(max_iter=200)
    for k, v in jm.get_parameters().items():
        close(pm.get_parameters()[k], v, RUN_TOL)
    close(pm.get_objective_function_value(),
          jm.get_objective_function_value(), RUN_TOL)
    pg, pw = pm.predict(Xs, apply_scale=False), jm.predict(Xs,
                                                           apply_scale=False)
    for k in ("f*", "f*_var", "y_var", "f_bar"):
        close(pg[k], pw[k], RUN_TOL)


def test_structured_model_fits_and_predicts_as_jax():
    """structured=True at a small N: Adam with the JAX probes, the CG
    objective and the CG posterior as the JAX model's; the automatic switch
    picks structured mode past the threshold. The objective is a CG solve to
    tol 1e-6 at the start's noise (0.1 of var(y)), where the two packages'
    iterates part at rounding-amplified levels (test_ski_matvec_and_cg_
    solve_match_jax): these, the fit (CG at tol 1e-4 in every step; 2.9e-9
    apart after five) and the predictions are held at CG_TOL."""
    rng = np.random.default_rng(11)
    X = rng.uniform(-3, 3, (150, 2))
    y = np.sin(X[:, 0]) + 0.3 * np.cos(X[:, 1]) \
        + 0.05 * rng.standard_normal(150)
    Xs = rng.uniform(-2, 2, (10, 2))
    jm = JaxKISS(coords=X, obs=y[:, None], grid_size=12, structured=True)
    pm = KISSGPModel(coords=X, obs=y[:, None], grid_size=12, structured=True,
                     device="cpu")
    assert pm.structured and jm.structured
    close(pm.get_objective_function_value(),
          jm.get_objective_function_value(), CG_TOL)
    assert jm.optimise_parameters(iterations=5)
    assert pm.optimise_parameters(iterations=5, probes=jax_probes(8, 150))
    for k, v in jm.get_parameters().items():
        close(pm.get_parameters()[k], v, CG_TOL)
    pg, pw = pm.predict(Xs, apply_scale=False), jm.predict(Xs,
                                                           apply_scale=False)
    for k in ("f*", "f*_var", "y_var"):
        close(pg[k], pw[k], CG_TOL)
    auto = KISSGPModel(coords=X, obs=y[:, None], grid_size=12,
                       structured_threshold=150 * 144 - 1, device="cpu")
    assert auto.structured
    assert not KISSGPModel(coords=X, obs=y[:, None], grid_size=12,
                           structured_threshold=150 * 144,
                           device="cpu").structured


@pytest.mark.parametrize("structured", [False, True])
def test_f32_model_stays_f32(structured):
    """An f32 model keeps its grid, interpolation and results in f32, and
    its predictions agree with the f64 model's at the f32 fit's
    parameters."""
    X, y = toy(n=120, d=2, seed=5)
    Xs = X[:6]
    kw = dict(coords=X, obs=y[:, None], grid_size=10, structured=structured,
              device="cpu")
    m32 = KISSGPModel(dtype=torch.float32, **kw)
    if structured:
        assert m32._interp.cw.dtype == torch.float32
        assert m32.optimise_parameters(iterations=3,
                                       probes=jax_probes(8, 120))
    else:
        assert m32._W.dtype == m32._Zg.dtype == torch.float32
        m32.optimise_parameters(max_iter=50)
    m64 = KISSGPModel(**kw)
    m64.set_parameters(**m32.get_parameters())
    got, want = m32.predict(Xs, apply_scale=False), m64.predict(
        Xs, apply_scale=False)
    for k in ("f*", "f*_var", "y_var"):
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-4)


def test_state_from_jax_gives_the_jax_predictions():
    """A fitted JAX model's grid and hyperparameters, carried over by
    weights.kiss_state_from_jax, give its predictions through the port's
    ops and through the port's model."""
    X, y = toy(n=50, d=2, seed=9)
    Xs = np.random.default_rng(1).uniform(0, 1, (7, 2))
    jm = JaxKISS(coords=X, obs=y[:, None], grid_size=10)
    jm.optimise_parameters(max_iter=100)
    want = jm.predict(Xs, apply_scale=False)
    G, starts, steps, params = kiss_state_from_jax(
        jm.grid_size, jm._starts, jm._steps, jm.get_parameters(),
        device="cpu")
    Xt = T(X)
    W = ski.interp_matrix(Xt, starts, steps, G)
    Zg = ski.grid_points(starts, steps, G, 2)
    got = ski.ski_predict(params, Xt, T(y), torch.ones(50, dtype=torch.bool),
                          T(Xs), W, Zg, starts, steps, G, "Matern32")
    pm = KISSGPModel(coords=X, obs=y[:, None], grid_size=G, device="cpu")
    np.testing.assert_array_equal(pm._starts, jm._starts)
    pm.set_parameters(**jm.get_parameters())
    got_model = pm.predict(Xs, apply_scale=False)
    for k in ("f*", "f*_var", "y_var"):
        close(got[k], want[k])
        close(got_model[k], want[k])


@pytest.mark.parametrize("sub", [(), ("example",), ("a", "b.h5")])
def test_path_helpers_match_jax(sub):
    """get_data_path and get_config_path (the path helpers the example
    drivers import) name the JAX package's directories."""
    import gpsat_tpu
    import gpsat_tpu_torch
    assert gpsat_tpu_torch.get_data_path(*sub) == gpsat_tpu.get_data_path(*sub)
    assert gpsat_tpu_torch.get_config_path(*sub) == \
        gpsat_tpu.get_config_path(*sub)
