"""Multi-output GPR with a linear forward-model likelihood, and the
multi-output SVGP (torch port of gpsat_tpu/ops/multioutput.py).

Re-design of the reference's experimental multioutput stack
(GPSat/models/multioutput/gpr.py:14, likelihoods.py:40, utils.py:31):
L latent GPs g_q mixed by a coregionalization matrix W [L, Q] give
f(x) = W g(x) [L]; observations are y = H f(x) + eps [P] with a linear
measurement operator H [P, L] and noise covariance R [P, P]. The joint
observation covariance over N points is

    C[(n,p),(n',p')] = (H W diag(k_q(x_n, x_n')) W^T H^T)[p,p'] + d_nn' R[p,p']

stacked point-major ((n, p) flattening) into [N*P, N*P]; the marginal
likelihood and the latent posterior are dense Gaussian algebra over it.
Single-expert functions with padding masks.
"""

import math

import torch

from gpsat_tpu_torch.ops.gpr import _cholesky
from gpsat_tpu_torch.ops.kernels import kernel_fn

__all__ = ["latent_kernel_stack", "observation_cov", "log_marginal_likelihood",
           "predict_f", "predict_y", "svgp_latent_marginals", "svgp_kl",
           "linear_var_exp", "nonlinear_var_exp", "svgp_elbo",
           "svgp_predict_f", "svgp_predict_y", "mvn_log_density"]

_LOG_2PI = math.log(2.0 * math.pi)


def latent_kernel_stack(params, X1, X2, kernel="Matern32"):
    """[Q, N1, N2] stack of latent kernels; params: lengthscales [Q, D],
    kernel_variance [Q]."""
    k = kernel_fn(kernel)
    return k(X1[None, :, :], X2[None, :, :], params["lengthscales"],
             params["kernel_variance"])


def _mixed_cov(params, W, H, X1, X2, kernel):
    """[N1, P, N2, P] covariance of Hf between two input sets."""
    Kq = latent_kernel_stack(params, X1, X2, kernel)       # [Q, N1, N2]
    A = H @ W                                              # [P, Q]
    # C[n,p,m,p'] = sum_q A[p,q] A[p',q] Kq[q,n,m]
    return torch.einsum("pq,rq,qnm->npmr", A, A, Kq)


def observation_cov(params, W, H, R, X, mask, kernel="Matern32"):
    """Stacked [N*P, N*P] observation covariance with masking: padded rows get
    zero cross-covariance and identity diagonal blocks."""
    N = X.shape[0]
    P = H.shape[0]
    C = _mixed_cov(params, W, H, X, X, kernel)             # [N, P, N, P]
    m = mask.to(X.dtype)
    C = C * (m[:, None, None, None] * m[None, None, :, None])
    # R on valid diagonal blocks, identity on padded ones
    eyeN = torch.eye(N, dtype=X.dtype, device=X.device)
    Rblk = torch.einsum("nm,pr->npmr", eyeN * m[:, None] * m[None, :], R)
    Iblk = torch.einsum("nm,pr->npmr",
                        eyeN * (1 - m)[:, None] * (1 - m)[None, :],
                        torch.eye(P, dtype=X.dtype, device=X.device))
    C = C + Rblk + Iblk
    return C.reshape(N * P, N * P)


def _factor(params, W, H, R, X, Y, mask, kernel, jitter):
    """(Cholesky factor of the jittered observation covariance, the masked
    stacked observations [N*P])."""
    N, P = Y.shape
    C = observation_cov(params, W, H, R, X, mask, kernel)
    C = C + jitter * torch.eye(N * P, dtype=X.dtype, device=X.device)
    y = (Y * mask.to(X.dtype)[:, None]).reshape(N * P)
    return _cholesky(C), y


def log_marginal_likelihood(params, W, H, R, X, Y, mask, kernel="Matern32",
                            jitter=0.0):
    """log p(Y) for Y [N, P]; equals the reference's MultioutputGPR
    log_marginal_likelihood (gpr.py:41) for the valid subset."""
    P = Y.shape[1]
    L, y = _factor(params, W, H, R, X, Y, mask, kernel, jitter)
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    n_valid = torch.sum(mask.to(X.dtype)) * P
    return -0.5 * (y @ alpha) - torch.sum(torch.log(torch.diagonal(L))) \
        - 0.5 * n_valid * _LOG_2PI


def predict_f(params, W, H, R, X, Y, mask, Xs, kernel="Matern32", jitter=0.0,
              full_output_cov=False):
    """Latent-f posterior at Xs: mean [Ns, L], var [Ns, L] (or [Ns, L, L]).

    Matches the reference's multioutput_conditional (utils.py:120). Only the
    [L, L] diagonal blocks of V^T V are formed (the JAX package forms all of
    it and keeps those)."""
    N, P = Y.shape
    Ns = Xs.shape[0]
    L_dim = W.shape[0]
    Lc, y = _factor(params, W, H, R, X, Y, mask, kernel, jitter)
    alpha = torch.cholesky_solve(y[:, None], Lc)[:, 0]

    # cov between latent f at Xs and observations: [Ns, L, N, P]
    Kq_sn = latent_kernel_stack(params, Xs, X, kernel)     # [Q, Ns, N]
    A = H @ W                                              # [P, Q]
    Kfy = torch.einsum("lq,pq,qsm->slmp", W, A, Kq_sn)
    Kfy = Kfy * mask.to(X.dtype)[None, None, :, None]
    Kfy2 = Kfy.reshape(Ns * L_dim, N * P)

    mean = (Kfy2 @ alpha).reshape(Ns, L_dim)
    V = torch.linalg.solve_triangular(Lc, Kfy2.mT, upper=False)  # [NP, Ns*L]
    # prior latent cov at Xs (block-diagonal over points)
    Kq_ss = latent_kernel_stack(params, Xs, Xs, kernel)
    prior = torch.einsum("lq,rq,qss->slr", W, W, Kq_ss)
    Vr = V.reshape(N * P, Ns, L_dim)
    expl_diag = torch.einsum("ksl,ksr->slr", Vr, Vr)
    cov = prior - expl_diag
    if full_output_cov:
        return mean, cov
    var = torch.clamp_min(torch.diagonal(cov, dim1=-2, dim2=-1), 0.0)
    return mean, var


def predict_y(params, W, H, R, X, Y, mask, Xs, kernel="Matern32", jitter=0.0):
    """Observation-space posterior: mean H f, cov H Sigma H^T + R blocks."""
    mean_f, cov_f = predict_f(params, W, H, R, X, Y, mask, Xs, kernel, jitter,
                              full_output_cov=True)
    mean_y = mean_f @ H.mT
    cov_y = torch.einsum("pl,slr,mr->spm", H, cov_f, H) + R[None, :, :]
    return mean_y, cov_y


# ---------------------------------------------------------------------------
# Multioutput SVGP (reference: MultioutputSVGP, GPSat/models/multioutput/
# gpr.py:82, with ForwardModelLikelihood variants, likelihoods.py:40,146).
#
# Q independent latent GPs g_q with shared inducing locations Z [M, D],
# mixed by W [L, Q] into the latent field f = W g. Whitened variational
# posterior q(v_q) = N(q_mu[:, q], L_q L_q^T), q_sqrt [Q, M, M].
# Observations y = h(x, f) + eps, eps ~ N(0, R [P, P]):
#   - linear h: analytic variational expectations (likelihoods.py:127-144)
#   - nonlinear h: Monte-Carlo quadrature (likelihoods.py:148-210), sampling
#     in g-space (f = W g with independent per-latent marginal draws is an
#     exact sampler of Fcov = W diag(g_var) W^T).
# ---------------------------------------------------------------------------


def _masked_q_sqrt(raw, zmask):
    """[Q, M, M] raw -> masked lower-triangular factors, unit diag on pads."""
    zm = zmask.to(raw.dtype)
    L = torch.tril(raw) * (zm[None, :, None] * zm[None, None, :])
    eye = torch.eye(raw.shape[-1], dtype=raw.dtype, device=raw.device)
    return L + eye[None] * (1.0 - zm)[None, :]


def svgp_latent_marginals(params, q_mu, q_sqrt_raw, Z, zmask, Xs,
                          kernel="Matern32", jitter=1e-6):
    """Whitened per-latent marginal posteriors at Xs.

    params: lengthscales [Q, D], kernel_variance [Q]; q_mu [M, Q];
    q_sqrt_raw [Q, M, M]; Z [M, D] shared across latents. Returns
    (g_mean [Ns, Q], g_var [Ns, Q]).
    """
    zm = zmask.to(Z.dtype)
    Kuu = latent_kernel_stack(params, Z, Z, kernel)           # [Q, M, M]
    diag = torch.where(zmask, torch.full_like(zm, jitter),
                       torch.ones_like(zm))
    Kuu = Kuu * (zm[:, None] * zm[None, :])[None] + torch.diag(diag)[None]
    Lu = _cholesky(Kuu)                                       # [Q, M, M]
    Kus = latent_kernel_stack(params, Z, Xs, kernel) * zm[None, :, None]
    A = torch.linalg.solve_triangular(Lu, Kus, upper=False)   # [Q, M, Ns]
    Lq = _masked_q_sqrt(q_sqrt_raw, zmask)                    # [Q, M, M]
    mean = torch.einsum("qmn,mq->nq", A, q_mu * zm[:, None])
    SA = torch.einsum("qkm,qkn->qmn", Lq, A)                  # L^T A
    var = (params["kernel_variance"][None, :]
           - torch.sum(A * A, dim=1).mT + torch.sum(SA * SA, dim=1).mT)
    return mean, torch.clamp_min(var, 0.0)


def svgp_kl(q_mu, q_sqrt_raw, zmask):
    """Sum over latents of KL(q(v_q) || N(0, I)); padded rows contribute 0.
    The 1e-300 stays a Python scalar: 0 in f32, as in the JAX package, and
    no f64 tensor to promote an f32 model."""
    zm = zmask.to(q_mu.dtype)
    Lq = _masked_q_sqrt(q_sqrt_raw, zmask)
    qm = q_mu * zm[:, None]
    M = q_mu.shape[0]
    diag = torch.abs(torch.diagonal(Lq, dim1=-2, dim2=-1)) + 1e-300
    per_latent = 0.5 * (torch.sum(qm * qm, dim=0)
                        + torch.sum(Lq * Lq, dim=(-2, -1)) - M
                        - 2.0 * torch.sum(torch.log(diag), dim=-1))
    return torch.sum(per_latent)


def mvn_log_density(Y, mu, R_chol):
    """log N(Y | mu, R) for batched rows Y, mu [..., P]; R_chol = chol(R).
    Reference: multivariate_gaussian_log_density (multioutput/utils.py:74)."""
    P = Y.shape[-1]
    diff = Y - mu                                             # [..., P]
    flat = diff.reshape(-1, P).mT                             # [P, K]
    sol = torch.linalg.solve_triangular(R_chol, flat, upper=False)
    maha = torch.sum(sol ** 2, dim=0).reshape(diff.shape[:-1])
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(R_chol)))
    return -0.5 * (P * _LOG_2PI + logdet + maha)


def linear_var_exp(Fmu, g_var, W, H, R, Y):
    """Analytic E_q[log N(y | H W g, R)] per data point.

    Fmu [N, L] latent-field mean (W g_mean), g_var [N, Q] latent marginal
    variances, H [P, L], R [P, P]. Matches LinearModelLikelihood
    ._variational_expectations (likelihoods.py:127-144):
    -(P/2)log 2pi - 0.5 log|R| - 0.5 (y-HFmu)^T R^-1 (y-HFmu)
    - 0.5 tr(R^-1 H Fcov H^T), with Fcov = W diag(g_var) W^T.
    """
    Rc = _cholesky(R)
    HFmu = Fmu @ H.mT                                         # [N, P]
    ll = mvn_log_density(Y, HFmu, Rc)
    # tr(R^-1 (HW) diag(g_var) (HW)^T) = sum_q g_var[:, q] * s_q,
    # s_q = (HW)_q^T R^-1 (HW)_q
    HW = H @ W                                                # [P, Q]
    sol = torch.cholesky_solve(HW, Rc)                        # R^-1 HW
    s = torch.sum(HW * sol, dim=0)                            # [Q]
    return ll - 0.5 * (g_var @ s)


def nonlinear_var_exp(h, X, g_mean, g_var, W, R, Y, eps):
    """Monte-Carlo E_q[log N(y | h(x, f), R)] per data point.

    h(X [N, D], F [N, L]) -> [N, P] is a torch function (the ForwardModel of
    NonlinearModelLikelihood, likelihoods.py:148), mapped over the samples
    with torch.vmap. eps [S, N, Q] are standard normal draws (the JAX
    package draws them from a key): g = g_mean + sqrt(g_var) eps,
    f = g W^T, and the log densities are averaged over S.
    """
    Rc = _cholesky(R)
    g = g_mean[None] + torch.sqrt(g_var)[None] * eps          # [S, N, Q]
    f = g @ W.mT                                              # [S, N, L]
    hf = torch.vmap(h, in_dims=(None, 0))(X, f)               # [S, N, P]
    return torch.mean(mvn_log_density(Y, hf, Rc), dim=0)      # [N]


def svgp_elbo(params, W, R, q_mu, q_sqrt_raw, X, Y, mask, Z, zmask,
              H=None, h=None, kernel="Matern32", jitter=1e-6, scale=1.0,
              eps=None):
    """Multioutput SVGP ELBO (reference: MultioutputSVGP.elbo, gpr.py:120).

    Provide H [P, L] for the linear likelihood, or a callable h(X, F) for the
    Monte-Carlo nonlinear likelihood with its draws `eps` [S, N, Q]. `mask`
    [N] weights data rows; `scale` is the minibatch factor N_total/N_batch.
    """
    g_mean, g_var = svgp_latent_marginals(params, q_mu, q_sqrt_raw, Z, zmask,
                                          X, kernel=kernel, jitter=jitter)
    m = mask.to(X.dtype)
    if h is not None:
        if eps is None:
            raise ValueError("the nonlinear likelihood needs its draws eps")
        ve = nonlinear_var_exp(h, X, g_mean, g_var, W, R, Y, eps)
    else:
        ve = linear_var_exp(g_mean @ W.mT, g_var, W, H, R, Y)
    return scale * torch.sum(ve * m) - svgp_kl(q_mu, q_sqrt_raw, zmask)


def svgp_predict_f(params, W, q_mu, q_sqrt_raw, Z, zmask, Xs,
                   kernel="Matern32", jitter=1e-6, full_output_cov=False):
    """Latent-field posterior at Xs: mean [Ns, L]; var [Ns, L] or cov
    [Ns, L, L] (Fcov = W diag(g_var) W^T)."""
    g_mean, g_var = svgp_latent_marginals(params, q_mu, q_sqrt_raw, Z, zmask,
                                          Xs, kernel=kernel, jitter=jitter)
    mean = g_mean @ W.mT
    if full_output_cov:
        cov = torch.einsum("lq,nq,rq->nlr", W, g_var, W)
        return mean, cov
    var = (W ** 2) @ g_var.mT                                 # [L, Ns]
    return mean, var.mT


def svgp_predict_y(params, W, H, R, q_mu, q_sqrt_raw, Z, zmask, Xs,
                   kernel="Matern32", jitter=1e-6):
    """Observation-space posterior for the linear likelihood: H f + eps."""
    mean, cov = svgp_predict_f(params, W, q_mu, q_sqrt_raw, Z, zmask, Xs,
                               kernel=kernel, jitter=jitter,
                               full_output_cov=True)
    mean_y = mean @ H.mT
    cov_y = torch.einsum("pl,nlr,mr->npm", H, cov, H) + R[None]
    return mean_y, cov_y
