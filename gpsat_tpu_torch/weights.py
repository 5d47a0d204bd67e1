"""Carry per-expert hyperparameters, L-BFGS states and per-expert model
states over from the JAX package, as numpy arrays, so both packages can start
from the same point.

Nothing here imports jax: the caller converts JAX arrays with ``np.asarray``
(which every helper also applies itself).
"""

import numpy as np
import torch

from gpsat_tpu_torch import default_dtype, resolve_device
from gpsat_tpu_torch.ops.lbfgs import Carry

__all__ = ["params_from_jax", "inducing_from_jax", "unconstrained_from_jax",
           "carry_from_jax", "model_state_from_jax", "svgp_state_from_jax",
           "vff_domains_from_jax", "kiss_state_from_jax",
           "multioutput_state_from_jax"]


def _tensor(a, dtype, device):
    dev = resolve_device(device)
    dtype = default_dtype(dev) if dtype is None else dtype
    return torch.as_tensor(np.array(a), dtype=dtype, device=dev)


def params_from_jax(params_np, dtype=None, device=None):
    """{name: [E, ...] array} hyperparameters -> {name: tensor}."""
    return {k: _tensor(v, dtype, device) for k, v in params_np.items()}


def inducing_from_jax(Z_np, zmask_np, dtype=None, device=None):
    """Per-expert inducing points [E, M, d] and their validity mask [E, M]
    (BatchedSGPR's `params["inducing_points"]` and `inducing_mask`) ->
    (Z tensor, bool mask tensor), so both engines work from the same Z."""
    return (_tensor(Z_np, dtype, device),
            _tensor(np.asarray(zmask_np).astype(bool), torch.bool, device))


def svgp_state_from_jax(q_mu, q_sqrt_raw, Z, zmask, dtype=None, device=None):
    """The variational state of BatchedSVGP (its `params["inducing_mean"]`
    [E, M], `params["inducing_chol"]` [E, M, M], `params["inducing_points"]`
    [E, M, d] and `inducing_mask` [E, M]) -> (q_mu, q_sqrt_raw, Z, bool mask)
    tensors, the arguments of ops/svgp's functions."""
    return (_tensor(q_mu, dtype, device), _tensor(q_sqrt_raw, dtype, device),
            *inducing_from_jax(Z, zmask, dtype, device))


def vff_domains_from_jax(a, b, dtype=None, device=None):
    """Per-expert boxes [E, d] of BatchedVFF / BatchedASVGP (`engine._a`,
    `engine._b`) -> (a, b) tensors, the arguments of ops/vff's and
    ops/asvgp's functions."""
    return _tensor(a, dtype, device), _tensor(b, dtype, device)


def kiss_state_from_jax(grid_size, starts, steps, params_np, dtype=None,
                        device=None):
    """The grid of a JAX KISSGPModel (`grid_size`, `_starts`, `_steps`) and
    its GPR hyperparameters ({name: array}, as `get_parameters()` gives them)
    -> (grid_size, starts [d], steps [d], {name: tensor}), the arguments of
    ops/ski's and ops/ski_structured's functions."""
    return (int(grid_size), _tensor(starts, dtype, device),
            _tensor(steps, dtype, device),
            params_from_jax(params_np, dtype, device))


def multioutput_state_from_jax(W, H, R, lengthscales, kernel_variance,
                               Z=None, q_mu=None, q_sqrt_raw=None,
                               dtype=None, device=None):
    """The state of a JAX MultioutputGPRModel or MultioutputSVGPModel ->
    {name: tensor}: W [L, Q], H [P, L] (None for a nonlinear forward
    model), R [P, P], lengthscales [Q, D], kernel_variance [Q], and for the
    SVGP model Z [M, D], q_mu [M, Q] and q_sqrt_raw [Q, M, M]."""
    state = {"W": W, "H": H, "R": R, "lengthscales": lengthscales,
             "kernel_variance": kernel_variance, "Z": Z, "q_mu": q_mu,
             "q_sqrt_raw": q_sqrt_raw}
    return {k: _tensor(v, dtype, device) for k, v in state.items()
            if v is not None}


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


def model_state_from_jax(state_np, bounds=None):
    """The state of a JAX per-expert model (GPRModel / SGPRModel) for the
    port's model of the same class.

    state_np: the dict its `get_parameters()` gives (lengthscales [d],
    kernel_variance, likelihood_variance, and inducing_points [M, d] for
    SGPR). bounds: {name: (low, high)} of its Sigmoid constraints, already in
    scaled coordinates (the `low` / `high` of `model.transforms[name]`).
    Returns (parameters, constraints): `model.set_parameter_constraints(
    constraints, move_within_tol=False)` then `model.set_parameters(
    **parameters)` put the port's model in the same state.
    """
    parameters = {}
    for name, value in state_np.items():
        value = np.array(value, dtype=float)
        parameters[name] = value if value.ndim else float(value)
    constraints = {
        name: {"low": np.array(low, dtype=float),
               "high": np.array(high, dtype=float)}
        for name, (low, high) in (bounds or {}).items()}
    return parameters, constraints
