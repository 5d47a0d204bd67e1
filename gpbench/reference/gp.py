"""Plain reference of one local expert: exact GPR and Titsias' collapsed SGPR
with a Matern-3/2 kernel, and the Gaussian 2-D smoother of the
hyperparameter fields.

Plain PyTorch on one expert at a time, in the dtype of its inputs (float64
for the reference; the control runs the same code in float32 with TF32
matmuls). It imports nothing of the program. Squared distances come from the
matmul expansion on coordinates centred on the expert's data, so a matmul
precision (TF32) reaches the kernel matrix as it would in a program that
took that step.

theta is a dict of tensors: lengthscales [D] (scaled units), kernel_variance
and likelihood_variance (0-d).
"""

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)


def sqdist(A, B):
    """[n, m] squared distances by |a|^2 + |b|^2 - 2 a.b, clamped at 0."""
    aa = (A * A).sum(-1)
    bb = (B * B).sum(-1)
    return torch.clamp_min(aa[:, None] + bb[None, :] - 2.0 * (A @ B.T), 0.0)


def matern32(A, B, theta):
    """kernel_variance * (1 + sqrt(3) r) exp(-sqrt(3) r), r the
    lengthscale-scaled distance."""
    ls = theta["lengthscales"]
    # r is floored at 1e-15 so that its gradient stays finite at r = 0,
    # where the kernel's own derivative in r is 0
    r = torch.sqrt(3.0 * torch.clamp_min(sqdist(A / ls, B / ls), 1e-30))
    return theta["kernel_variance"] * (1.0 + r) * torch.exp(-r)


def cholesky(A):
    """Lower Cholesky factor, all NaN where A is not positive definite (an
    objective there is NaN, which the fit reads as a rejected point)."""
    L, info = torch.linalg.cholesky_ex(A)
    return L if int(info) == 0 else L * float("nan")


def centred(X, *others):
    """X and the other coordinate arrays shifted by X's mean (the kernel is
    stationary: the values are unchanged, the matmul expansion is better
    conditioned)."""
    c = X.mean(0, keepdim=True)
    return (X - c,) + tuple(o - c for o in others)


def gpr_nlml(theta, X, y):
    """Negative log marginal likelihood of one expert: X [n, D] scaled
    coordinates, y [n] observations."""
    (X,) = centred(X)
    n = len(y)
    K = matern32(X, X, theta) + theta["likelihood_variance"] * torch.eye(
        n, dtype=X.dtype, device=X.device)
    L = cholesky(K)
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    return 0.5 * (y * alpha).sum() + torch.log(torch.diagonal(L)).sum() \
        + 0.5 * n * LOG_2PI


def gpr_predict(theta, X, y, Xs):
    """Posterior f*, f*_var and y_var at Xs [P, D]."""
    X, Xs = centred(X, Xs)
    n = len(y)
    K = matern32(X, X, theta) + theta["likelihood_variance"] * torch.eye(
        n, dtype=X.dtype, device=X.device)
    L = cholesky(K)
    Ks = matern32(X, Xs, theta)
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    v = torch.linalg.solve_triangular(L, Ks, upper=False)
    f_var = torch.clamp_min(theta["kernel_variance"] - (v * v).sum(0), 0.0)
    return {"f*": Ks.T @ alpha, "f*_var": f_var,
            "y_var": f_var + theta["likelihood_variance"]}


def _sgpr_common(theta, X, y, Z, jitter):
    X, Z = centred(X, Z)
    m = len(Z)
    eye = torch.eye(m, dtype=X.dtype, device=X.device)
    Lu = cholesky(matern32(Z, Z, theta) + jitter * eye)
    sigma = torch.sqrt(theta["likelihood_variance"])
    A = torch.linalg.solve_triangular(Lu, matern32(Z, X, theta),
                                      upper=False) / sigma
    AAT = A @ A.T
    LB = cholesky(eye + AAT)
    c = torch.linalg.solve_triangular(LB, (A @ y[:, None]) / sigma,
                                      upper=False)[:, 0]
    return X, Z, Lu, LB, AAT, c


def sgpr_elbo(theta, X, y, Z, jitter):
    """Titsias' collapsed evidence lower bound of one expert: inducing
    points Z [m, D] (scaled), `jitter` on the diagonal of Kuu."""
    _, _, _, LB, AAT, c = _sgpr_common(theta, X, y, Z, jitter)
    n = len(y)
    s2 = theta["likelihood_variance"]
    return (-0.5 * n * LOG_2PI - torch.log(torch.diagonal(LB)).sum()
            - 0.5 * n * torch.log(s2) - 0.5 * (y * y).sum() / s2
            + 0.5 * (c * c).sum()
            - 0.5 * (n * theta["kernel_variance"] / s2
                     - torch.diagonal(AAT).sum()))


def sgpr_predict(theta, X, y, Z, Xs, jitter):
    """SGPR posterior f*, f*_var and y_var at Xs [P, D]."""
    c0 = X.mean(0, keepdim=True)
    Xc, Zc, Lu, LB, _, c = _sgpr_common(theta, X, y, Z, jitter)
    Kus = matern32(Zc, Xs - c0, theta)
    t1 = torch.linalg.solve_triangular(Lu, Kus, upper=False)
    t2 = torch.linalg.solve_triangular(LB, t1, upper=False)
    f_var = torch.clamp_min(theta["kernel_variance"] + (t2 * t2).sum(0)
                            - (t1 * t1).sum(0), 0.0)
    return {"f*": t2.T @ c, "f*_var": f_var,
            "y_var": f_var + theta["likelihood_variance"]}


def smooth(x, y, vals, l_x, l_y, vmax=None):
    """smooth_hyperparameters' field smoother: clamp at vmax, Gaussian-weighted
    mean over every source with weights exp(-((dx/l_x)^2 + (dy/l_y)^2) / 2),
    clamp again. x, y, vals [E] tensors."""
    if vmax is not None:
        vals = torch.clamp_max(vals, vmax)
    w = torch.exp(-0.5 * (((x[:, None] - x[None, :]) / l_x) ** 2
                          + ((y[:, None] - y[None, :]) / l_y) ** 2))
    out = (w @ vals) / w.sum(1)
    return out if vmax is None else torch.clamp_max(out, vmax)
