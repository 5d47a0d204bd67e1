"""Exact GPR: the objectives of the batched engine and the per-expert model
GPRModel (torch port of gpsat_tpu/models/exact_gpr.py; reference parity:
GPflowGPRModel, GPSat/models/gpflow_models.py:26-663).

Hyperparameters: lengthscales [D], kernel_variance, likelihood_variance,
optimised by batched L-BFGS on the NLML in unconstrained (bijected) space.
Objectives here are batch-level: u [B, P] -> [B], with per-expert bijectors
(tensors [B, ...]) and fixed parameters [B, ...]; the per-expert model calls
them with a batch of one.
"""

from functools import lru_cache

import numpy as np
import torch

from gpsat_tpu_torch.models.base import BaseGPRModel
from gpsat_tpu_torch.ops import gpr as gpr_math
from gpsat_tpu_torch.ops.kernels import KERNEL_NAMES, kernel_fn
from gpsat_tpu_torch.ops.lbfgs import batched_lbfgs
from gpsat_tpu_torch.ops.packing import ParamSpec, pack, unpack
from gpsat_tpu_torch.ops.transforms import Sigmoid, Softplus

__all__ = ["move_within_bounds", "make_gpr_objective", "make_gpr_value_fun",
           "make_gpr_vg_fun", "GPRModel"]


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
def make_gpr_value_fun(kernel, free_names, d):
    """Batch-level value-only objective through the fused NLML value kernel
    (ops/cuda_gpr.nlml_value_batched): the cheap bulk NLML evaluator
    (diagnostics, objective reporting), not on the L-BFGS path, where every
    trial evaluates value_and_grad.
    value_fun(u [B,P], X, y, mask, bijectors, fixed) -> [B]."""
    from gpsat_tpu_torch.ops.cuda_gpr import nlml_value_batched

    spec = _spec(free_names, d)

    def value_fun(u, X, y, mask, bijectors, fixed):
        with torch.no_grad():
            params = _to_params(u, spec, free_names, bijectors, fixed)
            return nlml_value_batched(params, X, y, mask.to(X.dtype), kernel,
                                      0.0)

    return value_fun


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

    # no read back to the host and no upload from it: ops/lbfgs may capture
    # an L-BFGS iteration over it as a CUDA graph
    vg_fun.capturable = True
    return vg_fun


class GPRModel(BaseGPRModel):
    """Exact Gaussian-process regression expert."""

    HYPER_NAMES = ("lengthscales", "kernel_variance", "likelihood_variance")

    def __init__(self,
                 data=None,
                 coords_col=None,
                 obs_col=None,
                 coords=None,
                 obs=None,
                 coords_scale=None,
                 obs_scale=None,
                 obs_mean=None,
                 verbose=False,
                 *,
                 kernel="Matern32",
                 kernel_kwargs=None,
                 noise_variance=None,
                 likelihood_variance=None,
                 jitter=0.0,
                 device=None,
                 dtype=None,
                 **kwargs):
        super().__init__(data=data, coords_col=coords_col, obs_col=obs_col,
                         coords=coords, obs=obs, coords_scale=coords_scale,
                         obs_scale=obs_scale, obs_mean=obs_mean,
                         verbose=verbose, device=device, dtype=dtype)

        kernel_kwargs = dict(kernel_kwargs or {})
        if "smoothness" in kernel_kwargs:
            # GPyTorch-config compatibility (gpytorch_models.py:230):
            # smoothness selects the Matern order of the kernel
            from gpsat_tpu_torch.ops.kernels import kernel_from_smoothness
            kernel = kernel_from_smoothness(
                kernel_kwargs.pop("smoothness"), kernel)
        assert kernel in KERNEL_NAMES, \
            f"kernel: {kernel} not in available kernels: {KERNEL_NAMES}"
        self.kernel = kernel
        self.jitter = float(jitter)
        d = self.coords.shape[1]
        self._lengthscales = np.asarray(
            kernel_kwargs.pop("lengthscales", np.ones(d)), dtype=float)
        if self._lengthscales.ndim == 0:
            self._lengthscales = np.full(d, float(self._lengthscales))
        # data-driven default initial variances (same scheme as the batched
        # engine): avoids the degenerate zero-signal optimum the reference's
        # fixed kv=1 init can fall into
        y_var = float(np.var(self.obs[:, 0])) if len(self.obs) > 1 else 1.0
        y_var = max(y_var, 1e-10)
        self._kernel_variance = float(kernel_kwargs.pop("variance", y_var))
        if likelihood_variance is None:
            likelihood_variance = (0.1 * y_var) if noise_variance is None \
                else noise_variance
        self._likelihood_variance = float(likelihood_variance)
        self.kernel_kwargs = kernel_kwargs  # e.g. alpha for RationalQuadratic

        # unconstrained-space bijectors per parameter (GPflow-style positive
        # default)
        self.transforms = {n: Softplus() for n in self.param_names}
        self._last_opt_success = None

    # -- param_names + getters/setters --------------------------------------

    @property
    def param_names(self):
        return list(self.HYPER_NAMES)

    def get_lengthscales(self):
        return self._lengthscales.copy()

    def set_lengthscales(self, lengthscales):
        ls = np.asarray(lengthscales, dtype=float)
        if ls.ndim == 0:
            ls = np.full(self.coords.shape[1], float(ls))
        assert len(ls) == self.coords.shape[1], \
            "lengthscales must align to dim of coords"
        self._lengthscales = ls

    def get_kernel_variance(self):
        return float(self._kernel_variance)

    def set_kernel_variance(self, kernel_variance):
        self._kernel_variance = float(np.asarray(kernel_variance).reshape(-1)[0])

    def get_likelihood_variance(self):
        return float(self._likelihood_variance)

    def set_likelihood_variance(self, likelihood_variance):
        self._likelihood_variance = float(
            np.asarray(likelihood_variance).reshape(-1)[0])

    # -- constraints ---------------------------------------------------------

    def _set_constraint(self, name, low, high, move_within_tol=True, tol=1e-8,
                        scale=False, scale_magnitude=None):
        low = np.atleast_1d(np.asarray(low, dtype=float))
        high = np.atleast_1d(np.asarray(high, dtype=float))
        assert np.all(low <= high), "all high values must be >= low"
        if scale:
            if scale_magnitude is None:
                low = low / self.coords_scale[0, :]
                high = high / self.coords_scale[0, :]
            else:
                low = low / scale_magnitude
                high = high / scale_magnitude
        cur = np.atleast_1d(self.get_parameters(name)[name])
        if move_within_tol:
            cur = move_within_bounds(cur, low, high, tol)
            self.set_parameters(**{name: cur if name == "lengthscales" else cur[0]})
        if name == "lengthscales":
            self.transforms[name] = Sigmoid(low=self._tensor(low),
                                            high=self._tensor(high))
        else:
            # scalar parameters keep 0-d bounds
            self.transforms[name] = Sigmoid(low=self._tensor(low[0]),
                                            high=self._tensor(high[0]))

    def set_lengthscales_constraints(self, low, high, move_within_tol=True,
                                     tol=1e-8, scale=False, scale_magnitude=None):
        self._set_constraint("lengthscales", low, high, move_within_tol, tol,
                             scale, scale_magnitude)

    def set_kernel_variance_constraints(self, low, high, move_within_tol=True,
                                        tol=1e-8, scale=False, scale_magnitude=None):
        self._set_constraint("kernel_variance", low, high, move_within_tol, tol,
                             scale, scale_magnitude)

    def set_likelihood_variance_constraints(self, low, high, move_within_tol=True,
                                            tol=1e-8, scale=False,
                                            scale_magnitude=None):
        self._set_constraint("likelihood_variance", low, high, move_within_tol,
                             tol, scale, scale_magnitude)

    # -- objective / fit / predict -------------------------------------------

    def _param_dict(self):
        return {"lengthscales": self._tensor(self._lengthscales),
                "kernel_variance": self._tensor(self._kernel_variance),
                "likelihood_variance": self._tensor(self._likelihood_variance)}

    def _data(self):
        """(X [N, D], y [N], all-true mask [N]) on the model's device."""
        return (self._tensor(self.coords), self._tensor(self.obs[:, 0]),
                torch.ones(len(self.obs), dtype=torch.bool,
                           device=self.device))

    def _batch_of_one(self, tree):
        """A leading batch axis of 1 on every tensor of a dict of tensors or
        bijectors, in the model's dtype."""
        def lift(a):
            return self._tensor(a)[None]
        return {n: v.map_tensors(lift) if hasattr(v, "map_tensors")
                else lift(v) for n, v in tree.items()}

    def _store_optimum(self, opt, names, res):
        """Write the optimised free parameters back and keep the success."""
        for n in names:
            val = self.transforms[n].forward(opt[n]).detach().cpu().numpy()
            if n == "lengthscales":
                self.set_lengthscales(val)
            else:
                self.set_parameters(**{n: float(val)})
        self._last_opt_success = bool(res.converged[0])
        return self._last_opt_success

    def get_objective_function_value(self):
        """Negative log marginal likelihood at current parameters."""
        X, y, mask = self._data()
        with torch.no_grad():
            val = gpr_math.nlml(self._param_dict(), X, y, mask,
                                kernel=self.kernel, jitter=self.jitter)
        return float(val)

    def optimise_parameters(self, max_iter=1000, fixed_params=None,
                            gtol=1e-6, ftol=1e-11, **opt_kwargs):
        """L-BFGS on the NLML; returns True when converged
        (reference: GPSat/models/gpflow_models.py:291-330)."""
        if fixed_params is None:
            fixed_params = []
        free_names = tuple(n for n in self.param_names if n not in fixed_params)
        if len(free_names) == 0:
            return True
        d = self.coords.shape[1]
        objective, spec = make_gpr_objective(self.kernel, free_names, d)

        params = self._param_dict()
        fixed = {n: params[n] for n in self.param_names if n not in free_names}
        bijectors = {n: self.transforms[n] for n in free_names}
        u0 = pack({n: bijectors[n].inverse(params[n]) for n in free_names},
                  spec)

        X, y, mask = self._data()
        args = (X[None], y[None], mask[None], self._batch_of_one(bijectors),
                self._batch_of_one(fixed))
        res = batched_lbfgs(objective, u0[None].to(self.dtype), args=args,
                            max_iter=max_iter, gtol=gtol, ftol=ftol)
        return self._store_optimum(unpack(res.x[0], spec), free_names, res)

    def predict(self, coords, full_cov=False, apply_scale=True, **kwargs):
        """Posterior at given coords; keys match the reference
        (GPSat/models/gpflow_models.py:232-272)."""
        coords = self._prediction_coords(coords, apply_scale)
        params = self._param_dict()
        X, y, mask = self._data()
        Xs = self._tensor(coords)
        with torch.no_grad():
            out = gpr_math.predict(params, X, y, mask, Xs, kernel=self.kernel,
                                   jitter=self.jitter)
            result = {k: out[k].cpu().numpy()
                      for k in ("f*", "f*_var", "y_var")}

            if full_cov:
                k = kernel_fn(self.kernel)
                Kss = k(Xs, Xs, params["lengthscales"],
                        params["kernel_variance"], **self.kernel_kwargs)
                L = gpr_math.cholesky_masked(params, X, mask, self.kernel,
                                             self.jitter)
                Ks = k(X, Xs, params["lengthscales"],
                       params["kernel_variance"], **self.kernel_kwargs)
                v = torch.linalg.solve_triangular(L, Ks, upper=False)
                f_cov = (Kss - v.mT @ v).cpu().numpy()
                y_cov = f_cov.copy()
                np.fill_diagonal(y_cov,
                                 np.diag(y_cov) + self._likelihood_variance)
                result["f*_cov"] = f_cov
                result["y_cov"] = y_cov

        f_bar = self.obs_mean[:, 0]
        if len(f_bar) != len(result["f*"]):
            assert len(f_bar) == 1
            result["f_bar"] = np.repeat(f_bar, len(result["f*"]))
        else:
            result["f_bar"] = f_bar
        return result
