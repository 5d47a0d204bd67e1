"""The port's multi-output models (gpsat_tpu_torch ops/multioutput.py,
models/multioutput.py) against the JAX package on the same numpy inputs, on
the CPU in f64.

Tolerances: the ops at 1e-10 (relative, with an absolute floor of 1e-10),
masked and padded inputs included; the Monte-Carlo likelihood given the JAX
package's draws. The models' L-BFGS and Adam trajectories follow the JAX
package's to rounding (the Adam runs given the JAX key's per-step draws):
held at 1e-9, with the same stopping flags.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsat_tpu.models.multioutput import MultioutputGPRModel as JaxMOGPR
from gpsat_tpu.models.multioutput import MultioutputSVGPModel as JaxMOSVGP
from gpsat_tpu.ops import multioutput as jmo
from gpsat_tpu_torch.models import get_model
from gpsat_tpu_torch.models.multioutput import (MultioutputGPRModel,
                                                MultioutputSVGPModel)
from gpsat_tpu_torch.ops import multioutput as mo
from gpsat_tpu_torch.weights import multioutput_state_from_jax

# many small ops per Adam step: one thread per test worker
torch.set_num_threads(1)

OPS_TOL = 1e-10
RUN_TOL = 1e-9


def T(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def close(got, want, tol=OPS_TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def state(N=24, n_valid=17, M=10, m_valid=7, D=2, Q=2, L=2, P=2, seed=0):
    """Padded data (rows past n_valid masked), padded inducing rows (past
    m_valid), random W, H, SPD R, hyperparameters and a variational state."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (N, D))
    Y = rng.standard_normal((N, P))
    mask = np.arange(N) < n_valid
    X[~mask] = 0.0
    Y[~mask] = 0.0
    Z = X[rng.permutation(n_valid)[:M]] if M <= n_valid \
        else rng.uniform(-2, 2, (M, D))
    zmask = np.arange(M) < m_valid
    Z[~zmask] = 0.0
    A = rng.standard_normal((P, P))
    s = dict(X=X, Y=Y, mask=mask, Z=Z, zmask=zmask,
             W=rng.standard_normal((L, Q)) * 0.8,
             H=rng.standard_normal((P, L)),
             R=0.05 * A @ A.T + 0.05 * np.eye(P),
             params={"lengthscales": rng.uniform(0.5, 1.5, (Q, D)),
                     "kernel_variance": rng.uniform(0.5, 1.2, Q)},
             qm=0.3 * rng.standard_normal((M, Q)),
             qs=np.stack([np.tril(0.1 * rng.standard_normal((M, M)))
                          + np.eye(M) for _ in range(Q)]),
             Xs=rng.uniform(-2, 2, (6, D)),
             g_mean=rng.standard_normal((N, Q)),
             g_var=rng.uniform(0.1, 0.5, (N, Q)))
    return s


def J(s, keys):
    return [jnp.asarray(s[k]) for k in keys]


def Tt(s, keys):
    return [T(s[k], torch.bool) if s[k].dtype == bool else T(s[k])
            for k in keys]


def jparams(s):
    return {k: jnp.asarray(v) for k, v in s["params"].items()}


def tparams(s):
    return {k: T(v) for k, v in s["params"].items()}


# ---------------------------------------------------------------------------
# the exact model's ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["Matern32", "RBF"])
@pytest.mark.parametrize("shape", [dict(Q=2, L=2, P=2), dict(Q=1, L=2, P=3)])
def test_exact_ops_match_jax_masked_and_padded(kernel, shape):
    """observation_cov's (n, p) layout, the marginal likelihood, predict_f
    (variances and full output covariances) and predict_y on padded rows."""
    s = state(**shape)
    keys = ("W", "H", "R", "X", "Y", "mask")
    jargs, targs = J(s, keys), Tt(s, keys)
    close(mo.latent_kernel_stack(tparams(s), T(s["X"]), T(s["Xs"]), kernel),
          jmo.latent_kernel_stack(jparams(s), jnp.asarray(s["X"]),
                                  jnp.asarray(s["Xs"]), kernel))
    close(mo.observation_cov(tparams(s), *targs[:4], targs[5], kernel),
          jmo.observation_cov(jparams(s), *jargs[:4], jargs[5], kernel))
    close(mo.log_marginal_likelihood(tparams(s), *targs, kernel=kernel,
                                     jitter=1e-8),
          jmo.log_marginal_likelihood(jparams(s), *jargs, kernel=kernel,
                                      jitter=1e-8))
    for full in (False, True):
        got = mo.predict_f(tparams(s), *targs, T(s["Xs"]), kernel=kernel,
                           jitter=1e-8, full_output_cov=full)
        want = jmo.predict_f(jparams(s), *jargs, jnp.asarray(s["Xs"]),
                             kernel=kernel, jitter=1e-8, full_output_cov=full)
        for g, w in zip(got, want):
            close(g, w)
    got = mo.predict_y(tparams(s), *targs, T(s["Xs"]), kernel=kernel)
    want = jmo.predict_y(jparams(s), *jargs, jnp.asarray(s["Xs"]),
                         kernel=kernel)
    for g, w in zip(got, want):
        close(g, w)


def test_masked_marginal_likelihood_equals_unpadded():
    s = state()
    n = int(s["mask"].sum())
    keys = ("W", "H", "R")
    got = mo.log_marginal_likelihood(tparams(s), *Tt(s, keys),
                                     *Tt(s, ("X", "Y", "mask")))
    want = mo.log_marginal_likelihood(tparams(s), *Tt(s, keys),
                                      T(s["X"][:n]), T(s["Y"][:n]),
                                      torch.ones(n, dtype=torch.bool))
    close(got, want)


# ---------------------------------------------------------------------------
# the SVGP ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["Matern32", "RBF"])
def test_svgp_ops_match_jax_masked_and_padded(kernel):
    """The whitened marginals, KL, the Gaussian log density, the linear
    expectation, the ELBO (minibatch scale), and the predictions, with
    padded data and inducing rows."""
    s = state()
    jq = J(s, ("qm", "qs", "Z", "zmask"))
    tq = Tt(s, ("qm", "qs", "Z", "zmask"))
    got = mo.svgp_latent_marginals(tparams(s), *tq, T(s["X"]), kernel=kernel)
    want = jmo.svgp_latent_marginals(jparams(s), *jq, jnp.asarray(s["X"]),
                                     kernel=kernel)
    for g, w in zip(got, want):
        close(g, w)
    close(mo.svgp_kl(tq[0], tq[1], tq[3]), jmo.svgp_kl(jq[0], jq[1], jq[3]))
    Rc = np.linalg.cholesky(s["R"])
    close(mo.mvn_log_density(T(s["Y"]), T(s["Y"][::-1]), T(Rc)),
          jmo.mvn_log_density(jnp.asarray(s["Y"]), jnp.asarray(s["Y"][::-1]),
                              jnp.asarray(Rc)))
    Fmu = s["g_mean"] @ s["W"].T
    close(mo.linear_var_exp(T(Fmu), *Tt(s, ("g_var", "W", "H", "R", "Y"))),
          jmo.linear_var_exp(jnp.asarray(Fmu),
                             *J(s, ("g_var", "W", "H", "R", "Y"))))
    for scale in (1.0, 2.5):
        close(mo.svgp_elbo(tparams(s), T(s["W"]), T(s["R"]), tq[0], tq[1],
                           *Tt(s, ("X", "Y", "mask")), tq[2], tq[3],
                           H=T(s["H"]), kernel=kernel, scale=scale),
              jmo.svgp_elbo(jparams(s), jnp.asarray(s["W"]),
                            jnp.asarray(s["R"]), jq[0], jq[1],
                            *J(s, ("X", "Y", "mask")), jq[2], jq[3],
                            H=jnp.asarray(s["H"]), kernel=kernel,
                            scale=scale))
    for full in (False, True):
        got = mo.svgp_predict_f(tparams(s), T(s["W"]), *tq, T(s["Xs"]),
                                kernel=kernel, full_output_cov=full)
        want = jmo.svgp_predict_f(jparams(s), jnp.asarray(s["W"]), *jq,
                                  jnp.asarray(s["Xs"]), kernel=kernel,
                                  full_output_cov=full)
        for g, w in zip(got, want):
            close(g, w)
    got = mo.svgp_predict_y(tparams(s), *Tt(s, ("W", "H", "R")), *tq,
                            T(s["Xs"]), kernel=kernel)
    want = jmo.svgp_predict_y(jparams(s), *J(s, ("W", "H", "R")), *jq,
                              jnp.asarray(s["Xs"]), kernel=kernel)
    for g, w in zip(got, want):
        close(g, w)


def h_torch(X, F):
    return torch.stack([F[..., 0] ** 3 / 3 + F[..., 0],
                        F[..., 1] * torch.cos(X[..., 0])], -1)


def h_jax(X, F):
    return jnp.stack([F[..., 0] ** 3 / 3 + F[..., 0],
                      F[..., 1] * jnp.cos(X[..., 0])], -1)


def test_nonlinear_expectation_and_elbo_match_jax_given_its_draws():
    """nonlinear_var_exp and the nonlinear ELBO with eps drawn by the JAX
    package's key ((S, N, Q) normals, ops/multioutput.py:223)."""
    s = state()
    S, N, Q = 16, len(s["X"]), 2
    key = jax.random.PRNGKey(3)
    eps = np.asarray(jax.random.normal(key, (S, N, Q), dtype=jnp.float64))
    got = mo.nonlinear_var_exp(h_torch, *Tt(s, ("X", "g_mean", "g_var", "W",
                                                "R", "Y")), T(eps))
    want = jmo.nonlinear_var_exp(h_jax, *J(s, ("X", "g_mean", "g_var", "W",
                                               "R", "Y")), key, S)
    close(got, want)
    tq = Tt(s, ("qm", "qs", "Z", "zmask"))
    jq = J(s, ("qm", "qs", "Z", "zmask"))
    close(mo.svgp_elbo(tparams(s), T(s["W"]), T(s["R"]), tq[0], tq[1],
                       *Tt(s, ("X", "Y", "mask")), tq[2], tq[3], h=h_torch,
                       eps=T(eps)),
          jmo.svgp_elbo(jparams(s), jnp.asarray(s["W"]), jnp.asarray(s["R"]),
                        jq[0], jq[1], *J(s, ("X", "Y", "mask")), jq[2], jq[3],
                        h=h_jax, key=key, num_samples=S))
    with pytest.raises(ValueError, match="eps"):
        mo.svgp_elbo(tparams(s), T(s["W"]), T(s["R"]), tq[0], tq[1],
                     *Tt(s, ("X", "Y", "mask")), tq[2], tq[3], h=h_torch)


def test_f32_kl_and_elbo_stay_f32():
    """svgp_kl's 1e-300 is a Python scalar: an f32 state stays f32."""
    s = state()
    f = torch.float32
    tq = [T(s["qm"], f), T(s["qs"], f), T(s["Z"], f),
          T(s["zmask"], torch.bool)]
    kl = mo.svgp_kl(tq[0], tq[1], tq[3])
    elbo = mo.svgp_elbo({k: T(v, f) for k, v in s["params"].items()},
                        T(s["W"], f), T(s["R"], f), tq[0], tq[1],
                        T(s["X"], f), T(s["Y"], f), T(s["mask"], torch.bool),
                        tq[2], tq[3], H=T(s["H"], f))
    assert kl.dtype == elbo.dtype == f
    close(kl, mo.svgp_kl(*Tt(s, ("qm", "qs", "zmask"))), 1e-5)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def fusion_data(n=40, seed=4):
    """Two instruments of one latent field: the first sees f, the second 2f
    with more noise."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, 2))
    f = np.sin(X[:, 0]) + 0.5 * np.cos(2 * X[:, 1])
    Y = np.stack([f + 0.05 * rng.standard_normal(n),
                  2 * f + 0.2 * rng.standard_normal(n)], axis=1)
    return X, Y, f


@pytest.mark.parametrize("name", ["MultioutputGPRModel",
                                  "MultioutputSVGPModel"])
def test_get_model_resolves_the_multioutput_names(name):
    assert get_model(name).__name__ == name
    assert get_model(name) in (MultioutputGPRModel, MultioutputSVGPModel)


def test_gpr_model_fits_and_predicts_as_jax():
    """L-BFGS on the stacked marginal likelihood (Q = 2 latents, H mixing
    both instruments): the same optimum, objective and predictions."""
    X, Y, _ = fusion_data()
    Xs = X[:5] + 0.1
    kw = dict(coords=X, obs=Y, num_latent_gps=2, W=np.eye(2),
              H=np.array([[1.0, 0.0], [1.0, 1.0]]),
              R=np.diag([0.05 ** 2, 0.2 ** 2]))
    jm, pm = JaxMOGPR(**kw), MultioutputGPRModel(device="cpu", **kw)
    close(pm.get_objective_function_value(),
          jm.get_objective_function_value())
    assert pm.optimise_parameters() == jm.optimise_parameters()
    for k, v in jm.get_parameters().items():
        close(pm.get_parameters()[k], v, RUN_TOL)
    close(pm.get_objective_function_value(),
          jm.get_objective_function_value(), RUN_TOL)
    got, want = pm.predict(Xs), jm.predict(Xs)
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k], RUN_TOL)


def jax_step_draws(model, steps):
    """The per-step eps of the JAX model's Adam loop: the key of `mc_seed`
    split once a step (gpsat_tpu/models/multioutput.py:351-355)."""
    key = jax.random.PRNGKey(model.mc_seed)
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(
            sub, (model.num_mc_samples, len(model.coords),
                  model.num_latent_gps), dtype=jnp.float64)))
    return np.stack(out)


def compare_svgp(pm, jm):
    for k, v in jm.get_parameters().items():
        close(pm.get_parameters()[k], v, RUN_TOL)


@pytest.mark.parametrize("R,opt", [
    (0.05, dict(max_iter=1)),
    (0.05, dict(max_iter=40, learning_rate=5e-2)),
    (1.0, dict(max_iter=400, learning_rate=0.2, check_every=5,
               persistence=15)),
    (0.05, dict(max_iter=30, learning_rate=5e-2,
                fixed_params=["inducing_chol", "kernel_variance"]))])
def test_svgp_model_linear_adam_follows_jax(R, opt):
    """The linear likelihood's Adam loop step for step: after one step,
    forty, a plateau stop (at step 291, noise R = I), and with frozen
    leaves."""
    X, Y, _ = fusion_data(n=30)
    kw = dict(coords=X, obs=Y, num_latent_gps=1, W=np.array([[1.0], [1.0]]),
              H=np.array([[1.0, 0.0], [0.0, 2.0]]), R=R * np.eye(2),
              num_inducing_points=12)
    jm, pm = JaxMOSVGP(**kw), MultioutputSVGPModel(device="cpu", **kw)
    np.testing.assert_array_equal(pm.inducing_points, jm.inducing_points)
    close(pm.get_objective_function_value(),
          jm.get_objective_function_value())
    got, want = pm.optimise_parameters(**opt), jm.optimise_parameters(**opt)
    assert got == want or (np.isnan(got) and np.isnan(want))
    assert pm._last_opt_steps == (291 if R == 1.0 else opt["max_iter"])
    compare_svgp(pm, jm)
    g, w = pm.predict(X[:4]), jm.predict(X[:4])
    assert set(g) == set(w) and "y*" in g
    for k in w:
        close(g[k], w[k], RUN_TOL)


@pytest.mark.parametrize("steps", [1, 12])
def test_svgp_model_nonlinear_adam_follows_jax_given_its_draws(steps):
    """The Monte-Carlo likelihood's Adam loop step for step, fed the JAX
    key's per-step draws, as a stacked tensor and as a callable."""
    X, Y, _ = fusion_data(n=24)
    kw = dict(coords=X, obs=Y, num_latent_gps=2, forward_model=None,
              R=0.05 * np.eye(2), num_inducing_points=8, num_mc_samples=16)
    jm = JaxMOSVGP(**dict(kw, forward_model=h_jax))
    pm = MultioutputSVGPModel(device="cpu", **dict(kw, forward_model=h_torch))
    eps0 = np.asarray(jax.random.normal(
        jax.random.PRNGKey(jm.mc_seed), (16, 24, 2), dtype=jnp.float64))
    close(pm.get_objective_function_value(eps=T(eps0)),
          jm.get_objective_function_value())
    draws = jax_step_draws(jm, steps)
    jm.optimise_parameters(max_iter=steps, learning_rate=2e-2)
    pm.optimise_parameters(max_iter=steps, learning_rate=2e-2,
                           mc_draws=T(draws))
    compare_svgp(pm, jm)
    again = MultioutputSVGPModel(device="cpu",
                                 **dict(kw, forward_model=h_torch))
    again.optimise_parameters(max_iter=steps, learning_rate=2e-2,
                              mc_draws=lambda it: T(draws[it]))
    compare_svgp(again, jm)
    out = pm.predict(X[:5])
    assert out["f*"].shape == (5, 2) and "y*" not in out
    # the default draws come from a generator seeded with mc_seed
    d1 = pm.draw_eps()
    assert d1.shape == (16, 24, 2)
    assert torch.equal(d1, pm.draw_eps())
    gen = torch.Generator().manual_seed(pm.mc_seed)
    assert torch.equal(d1, pm.draw_eps(gen))
    assert not torch.equal(d1, pm.draw_eps(gen))


def test_state_from_jax_gives_the_jax_predictions():
    """A fitted JAX MultioutputSVGPModel's state, carried over by
    weights.multioutput_state_from_jax, gives its predictions through the
    port's ops and through the port's model; the exact model's likewise."""
    X, Y, _ = fusion_data(n=30)
    Xs = X[:6] - 0.05
    kw = dict(coords=X, obs=Y, num_latent_gps=1, W=np.array([[1.0], [1.0]]),
              H=np.eye(2), R=0.02 * np.eye(2), num_inducing_points=10)
    jm = JaxMOSVGP(**kw)
    jm.optimise_parameters(max_iter=30, learning_rate=5e-2)
    want = jm.predict(Xs)
    st = multioutput_state_from_jax(
        jm.W, jm.H, jm.R, jm.get_lengthscales(), jm.get_kernel_variance(),
        Z=jm.get_inducing_points(), q_mu=jm.get_inducing_mean(),
        q_sqrt_raw=jm._q_sqrt_raw, device="cpu")
    p = {"lengthscales": st["lengthscales"],
         "kernel_variance": st["kernel_variance"]}
    zm = torch.ones(10, dtype=torch.bool)
    mean, var = mo.svgp_predict_f(p, st["W"], st["q_mu"], st["q_sqrt_raw"],
                                  st["Z"], zm, T(Xs), jitter=jm.jitter)
    close(mean, want["f*"])
    close(var, want["f*_var"])
    pm = MultioutputSVGPModel(device="cpu", **kw)
    pm.set_parameters(**jm.get_parameters())
    got = pm.predict(Xs)
    for k in want:
        close(got[k], want[k])

    gkw = dict(coords=X, obs=Y, num_latent_gps=1, W=np.array([[1.0], [1.0]]),
               H=np.eye(2), R=0.02 * np.eye(2))
    jg = JaxMOGPR(**gkw)
    jg.set_parameters(lengthscales=[[0.7, 1.3]], kernel_variance=[0.9])
    sg = multioutput_state_from_jax(jg.W, jg.H, jg.R, jg.get_lengthscales(),
                                    jg.get_kernel_variance(), device="cpu")
    assert set(sg) == {"W", "H", "R", "lengthscales", "kernel_variance"}
    pg = {"lengthscales": sg["lengthscales"],
          "kernel_variance": sg["kernel_variance"]}
    m = torch.ones(30, dtype=torch.bool)
    mean, var = mo.predict_f(pg, sg["W"], sg["H"], sg["R"], T(X), T(Y), m,
                             T(Xs), jitter=jg.jitter)
    wg = jg.predict(Xs)
    close(mean, wg["f*"])
    close(var, wg["f*_var"])
