"""Batched stationary covariance functions (torch port of
gpsat_tpu/ops/kernels.py).

All functions accept arbitrary leading batch dimensions:
    X1: [..., N, D], X2: [..., M, D], lengthscales: [..., D] or scalar,
    variance: [...] scalar per batch element.

Distances are computed by direct differencing, which for the small D (2-4)
of this domain avoids the cancellation of the matmul expansion at large
coordinate values.
"""

import math
import warnings

import torch

__all__ = ["kernel_fn", "KERNEL_NAMES", "scaled_squared_distance",
           "kernel_diag", "kernel_from_smoothness"]


def _as_tensor(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def scaled_squared_distance(X1, X2, lengthscales):
    """r2[..., n, m] = sum_d ((X1[..., n, d] - X2[..., m, d]) / ls[..., d])^2."""
    ls = _as_tensor(lengthscales, X1)
    if ls.ndim == 0:
        ls = ls[None]
    x1 = X1 / ls[..., None, :]
    x2 = X2 / ls[..., None, :]
    diff = x1[..., :, None, :] - x2[..., None, :, :]
    return torch.sum(diff * diff, dim=-1)


def _r(r2):
    # clamped sqrt keeping gradients finite at r=0 (same trick as GPflow)
    return torch.sqrt(torch.clamp_min(r2, 1e-36))


def _matern12(r2):
    return torch.exp(-_r(r2))


def _matern32(r2):
    r = _r(r2) * math.sqrt(3.0)
    return (1.0 + r) * torch.exp(-r)


def _matern52(r2):
    r = _r(r2) * math.sqrt(5.0)
    return (1.0 + r + r ** 2 / 3.0) * torch.exp(-r)


def _rbf(r2):
    return torch.exp(-0.5 * r2)


def _exponential(r2):
    # GPflow Exponential: exp(-r/2)
    return torch.exp(-0.5 * _r(r2))


_ISOTROPIC = {
    "Matern12": _matern12,
    "Matern32": _matern32,
    "Matern52": _matern52,
    "RBF": _rbf,
    "SquaredExponential": _rbf,
    "Exponential": _exponential,
}

KERNEL_NAMES = sorted(list(_ISOTROPIC) + ["RationalQuadratic", "Cosine"])

# GPyTorch-config compatibility: Matern smoothness nu in {0.5, 1.5, 2.5}
# selects the Matern order at engine construction
_SMOOTHNESS_TO_KERNEL = {0.5: "Matern12", 1.5: "Matern32", 2.5: "Matern52"}


def kernel_from_smoothness(smoothness, kernel="Matern32"):
    """Map a GPyTorch-style Matern `smoothness` (nu) to a kernel name.

    Exact matches 0.5/1.5/2.5 select Matern12/32/52. Other values warn and
    round to the nearest supported order. A non-Matern `kernel` together with
    `smoothness` warns and keeps the named kernel.
    """
    nu = float(smoothness)
    if kernel not in ("Matern12", "Matern32", "Matern52"):
        warnings.warn(
            f"smoothness={nu} ignored: kernel {kernel!r} is not a Matern "
            "family kernel", stacklevel=2)
        return kernel
    if nu in _SMOOTHNESS_TO_KERNEL:
        return _SMOOTHNESS_TO_KERNEL[nu]
    nearest = min(_SMOOTHNESS_TO_KERNEL, key=lambda k: abs(k - nu))
    warnings.warn(
        f"smoothness={nu} is not a supported Matern order "
        f"(0.5/1.5/2.5); using nearest: {_SMOOTHNESS_TO_KERNEL[nearest]}",
        stacklevel=2)
    return _SMOOTHNESS_TO_KERNEL[nearest]


def kernel_fn(name):
    """Return k(X1, X2, lengthscales, variance, **kw) for the named kernel."""
    if name in _ISOTROPIC:
        shape_fn = _ISOTROPIC[name]

        def k(X1, X2, lengthscales, variance, **kwargs):
            r2 = scaled_squared_distance(X1, X2, lengthscales)
            return _as_tensor(variance, r2)[..., None, None] * shape_fn(r2)

        k.__name__ = f"kernel_{name}"
        return k

    if name == "RationalQuadratic":
        def k(X1, X2, lengthscales, variance, alpha=1.0, **kwargs):
            r2 = scaled_squared_distance(X1, X2, lengthscales)
            alpha = _as_tensor(alpha, r2)
            base = torch.pow(1.0 + r2 / (2.0 * alpha[..., None, None]),
                             -alpha[..., None, None])
            return _as_tensor(variance, r2)[..., None, None] * base
        return k

    if name == "Cosine":
        def k(X1, X2, lengthscales, variance, **kwargs):
            # GPflow Cosine: cos(2*pi * sum_d (x1_d - x2_d)/ls_d) (signed sum)
            ls = _as_tensor(lengthscales, X1)
            if ls.ndim == 0:
                ls = ls[None]
            x1 = X1 / ls[..., None, :]
            x2 = X2 / ls[..., None, :]
            d = torch.sum(x1[..., :, None, :] - x2[..., None, :, :], dim=-1)
            return _as_tensor(variance, d)[..., None, None] * \
                torch.cos(2.0 * math.pi * d)
        return k

    raise NotImplementedError(
        f"kernel: {name} not implemented; available: {KERNEL_NAMES}")


def kernel_diag(name, X, lengthscales, variance, **kwargs):
    """diag(k(X, X)): for all stationary kernels here this is `variance`."""
    n = X.shape[-2]
    var = _as_tensor(variance, X)
    return var[..., None].expand(*var.shape, n)
