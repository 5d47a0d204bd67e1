"""Exact GPR objectives for the batched engine (torch port of the objective
builders in gpsat_tpu/models/exact_gpr.py).

Hyperparameters: lengthscales [D], kernel_variance, likelihood_variance,
optimised by batched L-BFGS on the NLML in unconstrained (bijected) space.
Objectives here are batch-level: u [B, P] -> [B], with per-expert bijectors
(tensors [B, ...]) and fixed parameters [B, ...].
"""

from functools import lru_cache

import numpy as np
import torch

from gpsat_tpu_torch.ops import gpr as gpr_math
from gpsat_tpu_torch.ops.packing import ParamSpec, unpack

__all__ = ["move_within_bounds", "make_gpr_objective", "make_gpr_vg_fun"]


def move_within_bounds(vals, low, high, tol):
    """Clamp values into [low+tol, high-tol]; tol capped at half the narrowest
    width (reference: GPSat/models/gpflow_models.py:470-486)."""
    vals = np.atleast_1d(np.asarray(vals, dtype=float)).copy()
    low = np.broadcast_to(np.asarray(low, dtype=float), vals.shape)
    high = np.broadcast_to(np.asarray(high, dtype=float), vals.shape)
    half_min_width = np.min(high - low) / 2
    tol = min(tol, half_min_width)
    vals = np.where(vals > high - tol, high - tol, vals)
    vals = np.where(vals < low + tol, low + tol, vals)
    return vals


def _spec(free_names, d):
    shapes = {"lengthscales": (d,), "kernel_variance": (),
              "likelihood_variance": ()}
    return ParamSpec([(n, shapes[n]) for n in free_names])


def _to_params(u, spec, free_names, bijectors, fixed):
    """Unconstrained [B, P] -> batched parameter dict."""
    free = unpack(u, spec)
    params = dict(fixed)
    for n in free_names:
        params[n] = bijectors[n].forward(free[n])
    return params


@lru_cache(maxsize=None)
def make_gpr_objective(kernel, free_names, d):
    """Batched NLML objective over flat unconstrained vectors of the free
    parameters: objective(u [B,P], X, y, mask, bijectors, fixed) -> [B].

    Its gradient comes by autograd through ops.gpr.nlml_fused, whose
    backward is the closed-form NLML adjoint.
    """
    spec = _spec(free_names, d)

    def objective(u, X, y, mask, bijectors, fixed):
        params = _to_params(u, spec, free_names, bijectors, fixed)
        return gpr_math.nlml_fused(params, X, y, mask.to(X.dtype), kernel,
                                   0.0)

    return objective, spec


@lru_cache(maxsize=None)
def make_gpr_vg_fun(kernel, free_names, d):
    """Batch-level value_and_grad through the fused kernel
    (ops/cuda_gpr.nlml_vg_batched), which returns raw-parameter gradients.
    The chain rule through the constraint bijectors is torch.autograd.grad of
    the elementwise u -> params map, fed those gradients (the jax.vjp of
    gpsat_tpu/models/exact_gpr.py:make_gpr_vg_fun)."""
    from gpsat_tpu_torch.ops.cuda_gpr import nlml_vg_batched

    spec = _spec(free_names, d)

    def vg_fun(u, X, y, mask, bijectors, fixed):
        with torch.enable_grad():
            ur = u.detach().requires_grad_(True)
            params = _to_params(ur, spec, free_names, bijectors, fixed)
        val, gparams = nlml_vg_batched(
            {n: v.detach() for n, v in params.items()}, X, y,
            mask.to(X.dtype), kernel, 0.0)
        outs = [params[n] for n in free_names]
        cots = [gparams[n].to(params[n].dtype).reshape(params[n].shape)
                for n in free_names]
        (gu,) = torch.autograd.grad(outs, ur, cots)
        return val.to(u.dtype), gu

    return vg_fun
