"""Masked Titsias collapsed-ELBO sparse GPR (torch port of
gpsat_tpu/ops/sgpr.py).

M inducing points summarise N observations: O(N M^2) compute, O(N M) memory.
Every function takes arbitrary leading batch dimensions (X [..., N, D],
y/mask [..., N], Z [..., M, D], zmask [..., M], parameters with the same
leading dimensions); the JAX package vmaps the single-expert form instead.

Masking scheme extends ops.gpr: the data mask zeroes Kuf columns and y; the
inducing mask zeroes Kuu cross-terms and Kuf rows with a unit diagonal on the
padded inducing block, so padded inducing rows contribute exactly nothing to
the ELBO or the posterior.

This is the engine's f64 path on the CPU and the objective that autograd
differentiates when the fused route (ops/cuda_sgpr.py) is not taken.
"""

import math

import torch

from gpsat_tpu_torch.ops.gpr import _cholesky
from gpsat_tpu_torch.ops.kernels import kernel_fn

__all__ = ["elbo", "neg_elbo", "predict", "DEFAULT_JITTER"]

DEFAULT_JITTER = 1e-6
_LOG_2PI = math.log(2.0 * math.pi)


def _common(params, X, y, mask, Z, zmask, kernel, jitter, kernel_kwargs):
    k = kernel_fn(kernel)
    kk = kernel_kwargs or {}
    m = mask.to(X.dtype)
    zm = zmask.to(X.dtype)
    sn2 = torch.as_tensor(params["likelihood_variance"], dtype=X.dtype,
                          device=X.device)
    sigma = torch.sqrt(sn2)[..., None, None]

    Kuu = k(Z, Z, params["lengthscales"], params["kernel_variance"], **kk)
    Kuu = Kuu * (zm[..., :, None] * zm[..., None, :]) + torch.diag_embed(
        torch.where(zmask.bool(), torch.full_like(zm, jitter),
                    torch.ones_like(zm)))
    Lu = _cholesky(Kuu)

    Kuf = k(Z, X, params["lengthscales"], params["kernel_variance"], **kk)
    Kuf = Kuf * (zm[..., :, None] * m[..., None, :])

    A = torch.linalg.solve_triangular(Lu, Kuf, upper=False) / sigma  # [M, N]
    AAT = A @ A.mT
    M = Z.shape[-2]
    B = AAT + torch.eye(M, dtype=X.dtype, device=X.device)
    LB = _cholesky(B)
    y_m = y * m
    Aerr = (A @ y_m[..., None]) / sigma                              # [M, 1]
    c = torch.linalg.solve_triangular(LB, Aerr, upper=False)[..., 0]
    return m, zm, sn2, Lu, LB, A, AAT, c, y_m


def elbo(params, X, y, mask, Z, zmask, kernel="Matern32",
         jitter=DEFAULT_JITTER, kernel_kwargs=None):
    """Collapsed Titsias ELBO of (padded) experts; [...] values.

    Equals GPflow SGPR.elbo() for the valid subset (zero mean function).
    """
    m, zm, sn2, Lu, LB, A, AAT, c, y_m = _common(
        params, X, y, mask, Z, zmask, kernel, jitter, kernel_kwargs)
    n = torch.sum(m, dim=-1)
    sf2 = torch.as_tensor(params["kernel_variance"], dtype=X.dtype,
                          device=X.device)
    kdiag_sum = sf2 * n   # stationary kernels
    out = -0.5 * n * _LOG_2PI
    out = out - torch.sum(torch.log(torch.diagonal(LB, dim1=-2, dim2=-1)),
                          dim=-1)
    out = out - 0.5 * n * torch.log(sn2)
    out = out - 0.5 * torch.sum(y_m * y_m, dim=-1) / sn2
    out = out + 0.5 * torch.sum(c * c, dim=-1)
    out = out - 0.5 * (kdiag_sum / sn2
                       - torch.diagonal(AAT, dim1=-2, dim2=-1).sum(dim=-1))
    return out


def neg_elbo(params, X, y, mask, Z, zmask, kernel="Matern32",
             jitter=DEFAULT_JITTER, kernel_kwargs=None):
    return -elbo(params, X, y, mask, Z, zmask, kernel, jitter, kernel_kwargs)


def predict(params, X, y, mask, Z, zmask, Xs, kernel="Matern32",
            jitter=DEFAULT_JITTER, kernel_kwargs=None):
    """SGPR posterior mean/variance at Xs [..., P, D]; keys as the reference
    ('f*', 'f*_var', 'y_var')."""
    k = kernel_fn(kernel)
    kk = kernel_kwargs or {}
    m, zm, sn2, Lu, LB, A, AAT, c, y_m = _common(
        params, X, y, mask, Z, zmask, kernel, jitter, kernel_kwargs)
    Kus = k(Z, Xs, params["lengthscales"], params["kernel_variance"], **kk)
    Kus = Kus * zm[..., :, None]
    tmp1 = torch.linalg.solve_triangular(Lu, Kus, upper=False)
    tmp2 = torch.linalg.solve_triangular(LB, tmp1, upper=False)
    mean = torch.sum(tmp2 * c[..., :, None], dim=-2)
    kss = torch.as_tensor(params["kernel_variance"], dtype=X.dtype,
                          device=X.device)[..., None]
    f_var = torch.clamp_min(kss + torch.sum(tmp2 * tmp2, dim=-2)
                            - torch.sum(tmp1 * tmp1, dim=-2), 0.0)
    return {"f*": mean, "f*_var": f_var, "y_var": f_var + sn2[..., None]}
