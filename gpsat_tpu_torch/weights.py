"""Carry per-expert hyperparameters and L-BFGS states over from the JAX
package, as numpy arrays, so both packages can start from the same point.

Nothing here imports jax: the caller converts JAX arrays with ``np.asarray``
(which every helper also applies itself).
"""

import numpy as np
import torch

from gpsat_tpu_torch import default_dtype, resolve_device
from gpsat_tpu_torch.ops.lbfgs import Carry

__all__ = ["params_from_jax", "unconstrained_from_jax", "carry_from_jax"]


def _tensor(a, dtype, device):
    dev = resolve_device(device)
    dtype = default_dtype(dev) if dtype is None else dtype
    return torch.as_tensor(np.array(a), dtype=dtype, device=dev)


def params_from_jax(params_np, dtype=None, device=None):
    """{name: [E, ...] array} hyperparameters -> {name: tensor}."""
    return {k: _tensor(v, dtype, device) for k, v in params_np.items()}


def unconstrained_from_jax(u_np, dtype=None, device=None):
    """[E, P] unconstrained L-BFGS vectors (the JAX engine's packing order:
    lengthscales, kernel_variance, likelihood_variance) -> tensor."""
    return _tensor(u_np, dtype, device)


def carry_from_jax(carry, dtype=None, device=None):
    """The JAX L-BFGS carry tuple (it, x, f, g, S, Y, rho, gamma, done,
    iters, fail_cnt, t, backed) -> ops.lbfgs.Carry."""
    it, *rest = carry
    out = []
    for a in rest:
        a = np.asarray(a)
        if a.dtype == bool:
            out.append(_tensor(a, torch.bool, device))
        elif np.issubdtype(a.dtype, np.integer):
            out.append(_tensor(a, torch.int32, device))
        else:
            out.append(_tensor(a, dtype, device))
    return Carry(int(np.asarray(it)), *out)
