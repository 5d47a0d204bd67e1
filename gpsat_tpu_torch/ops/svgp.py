"""Masked whitened SVGP (Hensman et al. 2013): ELBO, natural-gradient step
and posterior (torch port of gpsat_tpu/ops/svgp.py).

The variational distribution q(u) = N(q_mu, L_q L_q^T) over M inducing
values is whitened (the GPflow default), with a Gaussian likelihood. Every
function takes arbitrary leading batch dimensions (X [..., N, D], y/mask
[..., N], Z [..., M, D], zmask [..., M], q_mu [..., M], q_sqrt_raw
[..., M, M], parameters with the same leading dimensions), as ops/sgpr.py
does; the JAX package vmaps the single-expert form instead.

Masking: the data mask weights the per-point expected log-likelihood; padded
inducing rows carry q_mu = 0 and a unit q_sqrt diagonal, so their KL
contribution is exactly zero, and masked Kuf/Kus rows remove them from the
posterior.
"""

import math

import torch

from gpsat_tpu_torch.ops.gpr import _cholesky
from gpsat_tpu_torch.ops.kernels import kernel_fn

__all__ = ["elbo", "neg_elbo", "predict", "marginals", "DEFAULT_JITTER",
           "make_q_sqrt", "q_sqrt_raw_init", "natgrad_step"]

DEFAULT_JITTER = 1e-6
_LOG_2PI = math.log(2.0 * math.pi)


def q_sqrt_raw_init(M, dtype=torch.float64, device=None):
    """Raw (unconstrained) init for q_sqrt: identity."""
    return torch.eye(M, dtype=dtype, device=device)


def make_q_sqrt(raw, zmask):
    """Raw [..., M, M] -> masked lower-triangular factor with a unit diagonal
    on padded inducing rows."""
    zm = zmask.to(raw.dtype)
    L = torch.tril(raw) * (zm[..., :, None] * zm[..., None, :])
    return L + torch.diag_embed(1.0 - zm)


def _as(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _whitened_kuu_chol(params, Z, zmask, kernel, jitter, kk):
    """(k, zm, Lu): the kernel, the inducing mask as floats and the lower
    factor of the masked Kuu with `jitter` on valid and 1 on padded rows."""
    k = kernel_fn(kernel)
    zm = zmask.to(Z.dtype)
    Kuu = k(Z, Z, params["lengthscales"], params["kernel_variance"], **kk)
    Kuu = Kuu * (zm[..., :, None] * zm[..., None, :]) + torch.diag_embed(
        torch.where(zmask.bool(), torch.full_like(zm, jitter),
                    torch.ones_like(zm)))
    return k, zm, _cholesky(Kuu)


def _whitened_marginals(params, q_mu, q_sqrt, Z, zmask, Xs, kernel="Matern32",
                        jitter=DEFAULT_JITTER, kernel_kwargs=None):
    """Marginal posterior mean/var at Xs for whitened q: f = K_su Lu^{-T} v."""
    kk = kernel_kwargs or {}
    k, zm, Lu = _whitened_kuu_chol(params, Z, zmask, kernel, jitter, kk)
    Kus = k(Z, Xs, params["lengthscales"], params["kernel_variance"], **kk)
    Kus = Kus * zm[..., :, None]
    A = torch.linalg.solve_triangular(Lu, Kus, upper=False)      # [..., M, P]
    mean = (A.mT @ (q_mu * zm)[..., None])[..., 0]
    SA = q_sqrt.mT @ A                                           # [..., M, P]
    kss = _as(params["kernel_variance"], Z)[..., None]
    var = torch.clamp_min(kss - torch.sum(A * A, dim=-2)
                          + torch.sum(SA * SA, dim=-2), 0.0)
    return mean, var


def elbo(params, q_mu, q_sqrt_raw, X, y, mask, Z, zmask, kernel="Matern32",
         jitter=DEFAULT_JITTER, kernel_kwargs=None, scale=1.0):
    """Whitened SVGP ELBO (Gaussian likelihood) of padded experts; [...].

    `scale` ([...] or a number) multiplies the data term (N_total /
    minibatch size when minibatching). Equals GPflow SVGP.elbo() for the
    valid subset.
    """
    q_sqrt = make_q_sqrt(q_sqrt_raw, zmask)
    mean, var = _whitened_marginals(params, q_mu, q_sqrt, Z, zmask, X,
                                    kernel=kernel, jitter=jitter,
                                    kernel_kwargs=kernel_kwargs)
    sn2 = _as(params["likelihood_variance"], X)[..., None]
    m = mask.to(X.dtype)
    # E_q[log N(y | f, sn2)] per point
    exp_ll = (-0.5 * torch.log(2.0 * math.pi * sn2)
              - 0.5 * ((y - mean) ** 2 + var) / sn2)
    data_term = _as(scale, X) * torch.sum(exp_ll * m, dim=-1)

    # KL(q || N(0, I)) in whitened space:
    # 0.5 * (|m|^2 + |L|_F^2 - M - 2 sum log|L_ii|); padded rows carry m = 0
    # and a unit diagonal, so they cancel against the -M count and log(1) = 0
    zm = zmask.to(X.dtype)
    qm = q_mu * zm
    M_total = q_mu.shape[-1]
    diag = torch.abs(torch.diagonal(q_sqrt, dim1=-2, dim2=-1)) + 1e-300
    kl = 0.5 * (torch.sum(qm * qm, dim=-1)
                + torch.sum(q_sqrt * q_sqrt, dim=(-2, -1)) - M_total
                - 2.0 * torch.sum(torch.log(diag), dim=-1))
    return data_term - kl


def neg_elbo(params, q_mu, q_sqrt_raw, X, y, mask, Z, zmask, **kwargs):
    return -elbo(params, q_mu, q_sqrt_raw, X, y, mask, Z, zmask, **kwargs)


def _cho_solve(L, B):
    """(L L^T)^{-1} B for a lower factor L (jax.scipy.linalg.cho_solve)."""
    t = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.mT, t, upper=True)


def natgrad_step(params, q_mu, q_sqrt_raw, X, y, mask, Z, zmask, gamma,
                 kernel="Matern32", jitter=DEFAULT_JITTER, kernel_kwargs=None,
                 scale=1.0):
    """One natural-gradient step on (q_mu, q_sqrt) at fixed hyperparameters.

    The reference runs gpflow.optimizers.NaturalGradient on the variational
    pair before each Adam step when natural_gradients=True
    (GPSat/models/gpflow_models.py:1190-1214). For a Gaussian likelihood it
    is a closed conjugate update in whitened precision space,

        Lambda_new = (1-gamma) Lambda + gamma (I + A W A^T / sn2)
        eta_new    = (1-gamma) eta    + gamma (A W y / sn2)

    with A = Lu^{-1} Kuf, W the data mask (times the minibatch `scale`),
    Lambda = S^{-1}, eta = S^{-1} q_mu. gamma=1 jumps straight to the optimal
    q(u) at the current hyperparameters (the collapsed Titsias bound).
    Padded inducing rows stay exactly at the N(0, 1) prior. Returns
    (q_mu [..., M], lower factor [..., M, M]); NaN where a factor fails.
    """
    kk = kernel_kwargs or {}
    M = q_mu.shape[-1]
    m = mask.to(X.dtype)
    k, zm, Lu = _whitened_kuu_chol(params, Z, zmask, kernel, jitter, kk)
    Kuf = k(Z, X, params["lengthscales"], params["kernel_variance"], **kk)
    Kuf = Kuf * (zm[..., :, None] * m[..., None, :])
    A = torch.linalg.solve_triangular(Lu, Kuf, upper=False)     # [..., M, N]

    sn2 = _as(params["likelihood_variance"], X)[..., None]
    sc = _as(scale, X)[..., None]
    Aw = A * m[..., None, :]
    C = sc[..., None] * (Aw @ A.mT) / sn2[..., None]            # [..., M, M]
    b = sc * (A @ (m * y)[..., None])[..., 0] / sn2             # [..., M]

    L = make_q_sqrt(q_sqrt_raw, zmask)
    eye = torch.eye(M, dtype=X.dtype, device=X.device)
    lam_old = _cho_solve(L, eye.expand_as(L))                   # S^{-1}
    eta_old = _cho_solve(L, (q_mu * zm)[..., None])[..., 0]     # S^{-1} q_mu

    g = gamma
    lam_new = (1.0 - g) * lam_old + g * (eye + C)
    lam_new = 0.5 * (lam_new + lam_new.mT)
    Lp = _cholesky(lam_new)
    eta_new = (1.0 - g) * eta_old + g * b
    m_new = _cho_solve(Lp, eta_new[..., None])[..., 0]
    S_new = _cho_solve(Lp, eye.expand_as(Lp))
    S_new = 0.5 * (S_new + S_new.mT)
    return m_new * zm, _cholesky(S_new)


def marginals(params, q_mu, q_sqrt_raw, Z, zmask, Xs, kernel="Matern32",
              jitter=DEFAULT_JITTER, kernel_kwargs=None):
    q_sqrt = make_q_sqrt(q_sqrt_raw, zmask)
    return _whitened_marginals(params, q_mu, q_sqrt, Z, zmask, Xs,
                               kernel=kernel, jitter=jitter,
                               kernel_kwargs=kernel_kwargs)


def predict(params, q_mu, q_sqrt_raw, Z, zmask, Xs, kernel="Matern32",
            jitter=DEFAULT_JITTER, kernel_kwargs=None):
    """Posterior at Xs [..., P, D]; keys as the reference ('f*', 'f*_var',
    'y_var')."""
    mean, var = marginals(params, q_mu, q_sqrt_raw, Z, zmask, Xs,
                          kernel=kernel, jitter=jitter,
                          kernel_kwargs=kernel_kwargs)
    sn2 = _as(params["likelihood_variance"], Xs)[..., None]
    return {"f*": mean, "f*_var": var, "y_var": var + sn2}
