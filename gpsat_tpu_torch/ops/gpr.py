"""Masked exact Gaussian-process regression (torch port of gpsat_tpu/ops/gpr.py).

Rasmussen & Williams Algorithm 2.1 with *padding masks*, so experts with
different data counts share one batched computation. Every function takes
arbitrary leading batch dimensions: X [..., N, D], y/mask [..., N] and
parameters with the same leading dimensions (lengthscales [..., D],
kernel_variance [...], likelihood_variance [...]); the JAX package vmaps the
single-expert form instead.

Masking scheme: for an expert with n valid of N padded rows
  K~ = (m m^T) * K(X, X)   with invalid rows/cols zeroed,
  A  = K~ + diag(where(m, sigma_n^2, 1))
giving A = blockdiag(K_valid + sigma_n^2 I, I_pad), whose Cholesky is the
valid Cholesky plus an identity block: the masked NLML equals the unpadded
NLML in exact arithmetic.

This is the engine's path on the CPU, and on the card for shapes outside the
CUDA kernels' gates, as the XLA path is in the JAX package.
"""

import math

import torch

from gpsat_tpu_torch.ops.kernels import kernel_fn

__all__ = ["nlml", "nlml_fused", "predict", "cholesky_masked",
           "DEFAULT_KERNEL"]

DEFAULT_KERNEL = "Matern32"
_LOG_2PI = math.log(2.0 * math.pi)


def _cholesky(A):
    """Lower Cholesky factor; NaN where A is not positive definite (the JAX
    convention, which the L-BFGS linesearch reads as a rejected trial)."""
    L, info = torch.linalg.cholesky_ex(A)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, torch.nan), L)


def _mask_kernel_matrix(K, mask, noise, jitter=0.0):
    """Apply padding mask and add noise/identity diagonal (see module doc)."""
    m = mask.to(K.dtype)
    K = K * (m[..., :, None] * m[..., None, :])
    noise = torch.as_tensor(noise, dtype=K.dtype, device=K.device)
    diag = torch.where(mask.bool(), noise[..., None] + jitter,
                       torch.ones_like(m))
    return K + torch.diag_embed(diag)


def cholesky_masked(params, X, mask, kernel=DEFAULT_KERNEL, jitter=0.0,
                    kernel_kwargs=None):
    """Cholesky of the masked noisy kernel matrix; [..., N, N] lower."""
    k = kernel_fn(kernel)
    K = k(X, X, params["lengthscales"], params["kernel_variance"],
          **(kernel_kwargs or {}))
    A = _mask_kernel_matrix(K, mask, params["likelihood_variance"], jitter)
    return _cholesky(A)


def nlml(params, X, y, mask, kernel=DEFAULT_KERNEL, jitter=0.0,
         kernel_kwargs=None):
    """Negative log marginal likelihood of (padded) experts; [...] values.

    Equals GPflow's -log_marginal_likelihood for the valid subset.
    """
    m = mask.to(X.dtype)
    y = y * m
    L = cholesky_masked(params, X, mask, kernel, jitter, kernel_kwargs)
    alpha = torch.cholesky_solve(y[..., None], L)[..., 0]
    n_valid = torch.sum(m, dim=-1)
    quad = 0.5 * torch.sum(y * alpha, dim=-1)
    logdet = torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    return quad + logdet + 0.5 * n_valid * _LOG_2PI


def predict(params, X, y, mask, Xs, kernel=DEFAULT_KERNEL, jitter=0.0,
            kernel_kwargs=None):
    """Posterior mean / variance at prediction points Xs [..., P, D].

    Returns dict with 'f*' (latent mean), 'f*_var' (latent variance) and
    'y_var' (latent + likelihood variance).
    """
    kk = kernel_kwargs or {}
    k = kernel_fn(kernel)
    m = mask.to(X.dtype)
    y = y * m
    L = cholesky_masked(params, X, mask, kernel, jitter, kernel_kwargs)
    alpha = torch.cholesky_solve(y[..., None], L)[..., 0]
    Ks = k(X, Xs, params["lengthscales"], params["kernel_variance"], **kk) \
        * m[..., :, None]
    f_mean = torch.sum(Ks * alpha[..., :, None], dim=-2)
    v = torch.linalg.solve_triangular(L, Ks, upper=False)
    prior_var = torch.as_tensor(params["kernel_variance"], dtype=X.dtype,
                                device=X.device)[..., None]
    f_var = torch.clamp_min(prior_var - torch.sum(v * v, dim=-2), 0.0)
    noise = torch.as_tensor(params["likelihood_variance"], dtype=X.dtype,
                            device=X.device)[..., None]
    return {"f*": f_mean, "f*_var": f_var, "y_var": f_var + noise}


# ---------------------------------------------------------------------------
# fused NLML with analytic adjoint
# ---------------------------------------------------------------------------
#
# The adjoint of the NLML has a closed form (Rasmussen & Williams eq. 5.9):
#     dNLML/dA = 0.5 (A^{-1} - alpha alpha^T),  alpha = A^{-1} y~
# so the backward pass needs one triangular inverse + one matmul, and the
# per-hyperparameter gradients follow from a VJP through the kernel build
# only (generic over every kernel in ops/kernels.py).


def _build_A(params, X, maskf, jitter, kernel, kernel_kwargs=None):
    """Masked noisy kernel matrix from a float mask (differentiable)."""
    k = kernel_fn(kernel)
    K = k(X, X, params["lengthscales"], params["kernel_variance"],
          **(kernel_kwargs or {}))
    K = K * (maskf[..., :, None] * maskf[..., None, :])
    noise = torch.as_tensor(params["likelihood_variance"], dtype=X.dtype,
                            device=X.device)
    diag = maskf * (noise[..., None] + jitter) + (1.0 - maskf)
    return K + torch.diag_embed(diag)


def _nlml_value(params, X, y, maskf, kernel, jitter):
    """One bordered Cholesky computes factor AND solve.

    chol([[A, y~],[y~^T, c]]) = [[L, 0],[z^T, s]] with z = L^{-1} y~, so
    appending y~ as a border row/col folds the forward substitution into the
    factorisation. c just needs c > y~^T A^{-1} y~; since
    lambda_min(A) >= min(noise+jitter, 1), c = y~.y~/min(noise,1)+1 is safe.
    The border never enters the value (diag/row slices stop at N).
    """
    A = _build_A(params, X, maskf, jitter, kernel)
    N = A.shape[-1]
    pad = 8
    yt = y * maskf
    noise = torch.as_tensor(params["likelihood_variance"], dtype=A.dtype,
                            device=A.device) + jitter
    c = torch.sum(yt * yt, dim=-1) / torch.clamp_max(noise, 1.0) + 1.0
    Aext = torch.nn.functional.pad(A, (0, pad, 0, pad))
    Aext[..., :N, N] = yt
    Aext[..., N, :N] = yt
    idx = torch.arange(N, N + pad, device=A.device)
    border = torch.ones(*A.shape[:-2], pad, dtype=A.dtype, device=A.device)
    border[..., 0] = c
    Aext[..., idx, idx] = border
    Lext = _cholesky(Aext)
    L = Lext[..., :N, :N]
    z = Lext[..., N, :N]
    quad = 0.5 * torch.sum(z * z, dim=-1)
    logdet = torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    val = quad + logdet + 0.5 * torch.sum(maskf, dim=-1) * _LOG_2PI
    return val, (L, z)


class _NLMLFused(torch.autograd.Function):
    """`nlml` with a float mask and the closed-form adjoint of
    gpsat_tpu/ops/gpr.py:_nlml_fused_bwd."""

    @staticmethod
    def forward(ctx, ls, sf2, sn2, X, y, maskf, kernel, jitter):
        params = {"lengthscales": ls, "kernel_variance": sf2,
                  "likelihood_variance": sn2}
        val, (L, z) = _nlml_value(params, X, y, maskf, kernel, jitter)
        ctx.save_for_backward(ls, sf2, sn2, X, y, maskf, L, z)
        ctx.kernel, ctx.jitter = kernel, jitter
        return val

    @staticmethod
    def backward(ctx, g):
        ls, sf2, sn2, X, y, maskf, L, z = ctx.saved_tensors
        N = L.shape[-1]
        alpha = torch.linalg.solve_triangular(
            L.mT, z[..., None], upper=True)[..., 0]
        eye = torch.eye(N, dtype=L.dtype, device=L.device)
        W = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
        Kinv = W.mT @ W
        Q = Kinv - alpha[..., :, None] * alpha[..., None, :]
        Abar = (0.5 * g)[..., None, None] * Q
        need = ctx.needs_input_grad
        inputs = [t.detach().requires_grad_(bool(need[i]))
                  for i, t in enumerate((ls, sf2, sn2, X))] + \
            [maskf.detach().requires_grad_(bool(need[5]))]
        wanted = [t for t in inputs if t.requires_grad]
        grads = [None] * 5
        if wanted:
            with torch.enable_grad():
                A = _build_A({"lengthscales": inputs[0],
                              "kernel_variance": inputs[1],
                              "likelihood_variance": inputs[2]},
                             inputs[3], inputs[4], ctx.jitter, ctx.kernel)
                got = iter(torch.autograd.grad(A, wanted, Abar,
                                               allow_unused=True))
            grads = [next(got) if t.requires_grad else None for t in inputs]
        gls, gsf2, gsn2, gX, gm = grads
        gy = g[..., None] * (maskf * alpha) if need[4] else None
        if need[5]:
            # mask also enters through y~ = y*m and the 0.5*n*log(2pi) term
            gm = gm + g[..., None] * (y * alpha) + \
                (g * 0.5 * _LOG_2PI)[..., None]
        return gls, gsf2, gsn2, gX, gy, gm, None, None


def nlml_fused(params, X, y, maskf, kernel=DEFAULT_KERNEL, jitter=0.0):
    """`nlml` with a float mask and an analytic backward.

    Value path: one bordered Cholesky. Gradient path: one triangular inverse
    + one matmul + a VJP through the kernel build. Gradients agree with
    autodiff through `nlml` to float tolerance.
    """
    def t(v):
        return torch.as_tensor(v, dtype=X.dtype, device=X.device)
    return _NLMLFused.apply(t(params["lengthscales"]),
                            t(params["kernel_variance"]),
                            t(params["likelihood_variance"]),
                            X, y, maskf, kernel, float(jitter))
