"""Structured-kernel-interpolation (SKI / KISS-GP) ops, dense form (torch
port of gpsat_tpu/ops/ski.py).

Reference parity: GPyTorchKISSGPModel (GPSat/models/gpytorch_models.py:321),
which wraps gpytorch's GridInterpolationKernel: K(X1, X2) ~= W1 Kg W2^T with
Kg the exact kernel on a regular grid and W cubic-convolution interpolation
weights (Keys 1981, a = -1/2).

The interpolation matrices are dense ([N, G] per dim, row-wise Kronecker
product across dims): at local-expert sizes (N and G^d a few thousand) dense
SKI is exact to the method and every contraction is a plain matmul. The
large-N machinery is ops/ski_structured.py.

Weights reproduce function values exactly at grid nodes and sum to 1 per row
(partition of unity), so SKI -> exact GPR as the grid refines. `ski_nlml`
takes arbitrary leading batch dimensions (W [..., N, G^d], Zg [..., G^d, d]);
`interp_matrix`, `grid_points` and `ski_predict` are single-expert.
"""

import math

import numpy as np
import torch

from gpsat_tpu_torch.ops.gpr import _cholesky, _mask_kernel_matrix
from gpsat_tpu_torch.ops.kernels import kernel_fn

__all__ = ["choose_grid_size", "make_grid", "interp_weights_1d",
           "interp_matrix", "grid_points", "ski_nlml", "ski_predict"]

_LOG_2PI = math.log(2.0 * math.pi)


def choose_grid_size(X, ratio=1.0, min_size=8):
    """Per-dim grid size heuristic: ratio * N^(1/d) (gpytorch's
    choose_grid_size), floored so the cubic stencil always has support."""
    n, d = np.shape(X)
    return max(int(ratio * n ** (1.0 / d)), min_size)


def make_grid(X, grid_size, pad_cells=2):
    """Regular per-dim grids covering the data plus `pad_cells` cells of
    margin each side (the cubic stencil reads 2 nodes beyond the sample).

    Returns numpy (starts [d], steps [d]) for `grid_size` nodes per dim, in
    X's float dtype: f64 anchors would drag an f32 model's whole SKI algebra
    (W, Zg, Gram, solves) up to float64.
    """
    X = np.asarray(X)
    dt = X.dtype if np.issubdtype(X.dtype, np.floating) else np.float64
    X = X.astype(np.float64, copy=False)
    lo = X.min(axis=0)
    hi = X.max(axis=0)
    span = np.maximum(hi - lo, 1e-12)
    inner = grid_size - 1 - 2 * pad_cells
    assert inner >= 1, f"grid_size {grid_size} too small for pad {pad_cells}"
    steps = span / inner
    starts = lo - pad_cells * steps
    return starts.astype(dt), steps.astype(dt)


def _keys_cubic(u):
    """Keys (1981) cubic-convolution kernel, a = -1/2; support |u| < 2."""
    au = torch.abs(u)
    inner = (1.5 * au - 2.5) * au * au + 1.0
    outer = ((-0.5 * au + 2.5) * au - 4.0) * au + 2.0
    return torch.where(au <= 1.0, inner,
                       torch.where(au < 2.0, outer, torch.zeros_like(au)))


def interp_weights_1d(x, start, step, grid_size):
    """Dense cubic interpolation weights: [N, grid_size] for 1-d samples
    x [N] (a tensor; start and step scalars or 0-d tensors)."""
    nodes = start + step * torch.arange(grid_size, dtype=x.dtype,
                                        device=x.device)
    return _keys_cubic((x[:, None] - nodes[None, :]) / step)


def interp_matrix(X, starts, steps, grid_size):
    """Row-wise Kronecker product of per-dim weights: [N, grid_size**d]."""
    n, d = X.shape
    starts = torch.as_tensor(starts, device=X.device)
    steps = torch.as_tensor(steps, device=X.device)
    W = interp_weights_1d(X[:, 0], starts[0], steps[0], grid_size)
    for j in range(1, d):
        Wj = interp_weights_1d(X[:, j], starts[j], steps[j], grid_size)
        W = (W[:, :, None] * Wj[:, None, :]).reshape(n, -1)
    return W


def grid_points(starts, steps, grid_size, d):
    """Full grid as [grid_size**d, d] points (C order, matching
    interp_matrix's Kronecker layout); starts, steps [d] tensors."""
    ar = torch.arange(grid_size, dtype=starts.dtype, device=starts.device)
    axes = [starts[j] + steps[j] * ar for j in range(d)]
    mesh = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([m.reshape(-1) for m in mesh], dim=-1)


def _ski_gram(params, W, Zg, kernel, kernel_kwargs=None):
    k = kernel_fn(kernel)
    Kg = k(Zg, Zg, params["lengthscales"], params["kernel_variance"],
           **(kernel_kwargs or {}))
    return W @ Kg @ W.mT, Kg


def ski_nlml(params, X, y, mask, W, Zg, kernel, jitter=0.0,
             kernel_kwargs=None):
    """Masked NLML with the SKI kernel (same masking scheme as ops/gpr.nlml;
    reference math: Rasmussen & Williams Algorithm 2.1); [...] values."""
    maskf = mask.to(X.dtype)
    K, _ = _ski_gram(params, W, Zg, kernel, kernel_kwargs)
    A = _mask_kernel_matrix(K, maskf > 0, params["likelihood_variance"],
                            jitter)
    L = _cholesky(A)
    ym = y * maskf
    z = torch.linalg.solve_triangular(L, ym[..., None], upper=False)[..., 0]
    n_valid = torch.sum(maskf, dim=-1)
    return (0.5 * torch.sum(z * z, dim=-1)
            + torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                        dim=-1)
            + 0.5 * n_valid * _LOG_2PI)


def ski_predict(params, X, y, mask, Xs, W, Zg, starts, steps, grid_size,
                kernel, jitter=0.0, kernel_kwargs=None):
    """Posterior mean/variance at Xs under the SKI kernel. The cross- and
    test-covariances use the same interpolation (Ks = W Kg Ws^T,
    kss_diag = diag(Ws Kg Ws^T)) so train and test see one model."""
    maskf = mask.to(X.dtype)
    K, Kg = _ski_gram(params, W, Zg, kernel, kernel_kwargs)
    A = _mask_kernel_matrix(K, maskf > 0, params["likelihood_variance"],
                            jitter)
    L = _cholesky(A)
    Ws = interp_matrix(Xs, starts, steps, grid_size)
    Ks = (W @ Kg @ Ws.mT) * maskf[:, None]
    alpha = torch.cholesky_solve((y * maskf)[:, None], L)[:, 0]
    f_mean = Ks.mT @ alpha
    v = torch.linalg.solve_triangular(L, Ks, upper=False)
    kss = torch.sum((Ws @ Kg) * Ws, dim=1)
    f_var = torch.clamp_min(kss - torch.sum(v * v, dim=0), 0.0)
    return {"f*": f_mean, "f*_var": f_var,
            "y_var": f_var + params["likelihood_variance"]}
