"""KISS-GP (SKI) local-expert model (torch port of
gpsat_tpu/models/kiss_gpr.py).

Reference parity: GPyTorchKISSGPModel (GPSat/models/gpytorch_models.py:321),
an exact-GPR variant whose kernel is replaced by structured kernel
interpolation over an auto-sized regular grid
(gpytorch.kernels.GridInterpolationKernel with
gpytorch.utils.grid.choose_grid_size). Hyperparameters, constraints and the
optimise/predict API are GPRModel's; only the Gram matrices go through the
SKI approximation (ops/ski.py, ops/ski_structured.py).
"""

import math
from functools import lru_cache

import numpy as np
import torch

from gpsat_tpu_torch.models.exact_gpr import GPRModel, _spec, _to_params
from gpsat_tpu_torch.ops import ski
from gpsat_tpu_torch.ops import ski_structured as skis
from gpsat_tpu_torch.ops.lbfgs import batched_lbfgs
from gpsat_tpu_torch.ops.packing import pack, unpack

__all__ = ["KISSGPModel"]


@lru_cache(maxsize=None)
def _make_ski_objective(kernel, free_names, d):
    """Batched NLML over flat unconstrained vectors, SKI Gram:
    objective(u [B, P], X, y, mask, W, Zg, bijectors, fixed) -> [B]."""
    spec = _spec(free_names, d)

    def objective(u, X, y, mask, W, Zg, bijectors, fixed):
        params = _to_params(u, spec, free_names, bijectors, fixed)
        return ski.ski_nlml(params, X, y, mask, W, Zg, kernel)

    return objective, spec


class KISSGPModel(GPRModel):
    """Exact-GPR expert with a grid-interpolation (SKI) kernel.

    Two execution modes:
    - dense (default at expert scale): [N, G^d] interpolation matrices and
      dense Gram algebra, exact to the method, fastest when N and G^d are a
      few thousand;
    - structured (`structured=True`, or automatic when N * G^d exceeds
      `structured_threshold` elements): never materialises W or Kg; BTTB
      FFT grid-kernel MVMs, sparse stencil interpolation, CG solves and
      stochastic-trace Adam training (ops/ski_structured), the machinery
      gpytorch uses at the N where the reference reaches for KISS.
    """

    def __init__(self, *args, grid_size=None, grid_ratio=1.0,
                 structured=None, structured_threshold=2**24, **kwargs):
        super().__init__(*args, **kwargs)
        d = self.coords.shape[1]
        if grid_size is None:
            grid_size = ski.choose_grid_size(self.coords, ratio=grid_ratio)
        self.grid_size = int(grid_size)
        self._starts, self._steps = ski.make_grid(self.coords, self.grid_size)
        if structured is None:
            structured = (len(self.coords) * self.grid_size ** d
                          > structured_threshold)
        self.structured = bool(structured)
        if self.structured:
            self._interp = skis.SparseInterp(
                self.coords, self._starts, self._steps, self.grid_size,
                dtype=self.dtype, device=self.device)
            self._Zg = None
            self._W = None
            return
        self._Zg = ski.grid_points(self._tensor(self._starts),
                                   self._tensor(self._steps),
                                   self.grid_size, d)
        self._W = ski.interp_matrix(self._tensor(self.coords),
                                    self._tensor(self._starts),
                                    self._tensor(self._steps), self.grid_size)

    def get_objective_function_value(self):
        """NLML at the current parameters. In structured mode, the data-fit
        half 0.5 y^T K^-1 y + N/2 log(2 pi) by CG (the log-determinant needs
        stochastic Lanczos at that scale), like gpytorch's diagnostic
        loss."""
        X, y, mask = self._data()
        with torch.no_grad():
            if self.structured:
                d = self.coords.shape[1]
                params = self._param_dict()
                femb = skis.grid_kernel_embed_fft(
                    params, self._tensor(self._steps), self.grid_size,
                    self.kernel, d)
                mv = skis._matvec(femb, self._interp,
                                  params["likelihood_variance"] + self.jitter,
                                  self.grid_size, d)
                alpha = skis.cg_solve(mv, y[None], tol=1e-6,
                                      max_iter=200)[0]
                return float(0.5 * torch.sum(y * alpha)
                             + 0.5 * len(y) * math.log(2 * math.pi))
            return float(ski.ski_nlml(self._param_dict(), X, y, mask,
                                      self._W, self._Zg, self.kernel,
                                      self.jitter))

    def optimise_parameters(self, max_iter=1000, fixed_params=None,
                            gtol=1e-6, ftol=1e-11, iterations=30, lr=0.1,
                            probes=None, **opt_kwargs):
        """Dense: L-BFGS on the SKI NLML. Structured: gpytorch-style
        fixed-iteration Adam with stochastic trace gradients (reference:
        gpytorch_models.py:181, Adam lr=0.1); `probes` [n_probes, N]
        replaces its default Hutchinson draw."""
        if fixed_params is None:
            fixed_params = []
        free_names = tuple(n for n in self.param_names
                           if n not in fixed_params)
        if self.structured:
            params = self._param_dict()
            p0 = {n: params[n].cpu().numpy() for n in free_names}
            bij = {n: self.transforms[n] for n in free_names}
            opt_params, self._interp = skis.ski_fit_adam(
                p0, bij, self.coords, self._data()[1], self._starts,
                self._steps, self.grid_size, self.kernel,
                jitter=max(self.jitter, 1e-6), iterations=int(iterations),
                lr=lr, probes=probes)
            vals = {n: opt_params[n].cpu().numpy() for n in free_names}
            for n, val in vals.items():
                if n == "lengthscales":
                    self.set_lengthscales(val)
                else:
                    self.set_parameters(**{n: float(val)})
            self._last_opt_success = all(np.isfinite(v).all()
                                         for v in vals.values())
            return self._last_opt_success
        if len(free_names) == 0:
            return True
        d = self.coords.shape[1]
        objective, spec = _make_ski_objective(self.kernel, free_names, d)

        params = self._param_dict()
        fixed = {n: params[n] for n in self.param_names
                 if n not in free_names}
        bijectors = {n: self.transforms[n] for n in free_names}
        u0 = pack({n: bijectors[n].inverse(params[n]) for n in free_names},
                  spec)
        X, y, mask = self._data()
        args = (X[None], y[None], mask[None], self._W[None], self._Zg[None],
                self._batch_of_one(bijectors), self._batch_of_one(fixed))
        res = batched_lbfgs(objective, u0[None].to(self.dtype), args=args,
                            max_iter=max_iter, gtol=gtol, ftol=ftol)
        return self._store_optimum(unpack(res.x[0], spec), free_names, res)

    def predict(self, coords, full_cov=False, apply_scale=True, **kwargs):
        """Posterior at coords: f*, f*_var, y_var and f_bar, dense or
        structured (by CG)."""
        coords = self._prediction_coords(coords, apply_scale)
        X, y, mask = self._data()
        with torch.no_grad():
            if self.structured:
                out = skis.ski_predict_cg(
                    self._param_dict(), self._interp, self.coords, y, coords,
                    self._starts, self._steps, self.grid_size, self.kernel,
                    jitter=max(self.jitter, 1e-6))
            else:
                out = ski.ski_predict(
                    self._param_dict(), X, y, mask, self._tensor(coords),
                    self._W, self._Zg, self._tensor(self._starts),
                    self._tensor(self._steps), self.grid_size, self.kernel,
                    self.jitter)
        result = {k: out[k].cpu().numpy() for k in ("f*", "f*_var", "y_var")}
        f_bar = self.obs_mean[:, 0]
        if len(f_bar) != len(result["f*"]):
            assert len(f_bar) == 1
            result["f_bar"] = np.repeat(f_bar, len(result["f*"]))
        else:
            result["f_bar"] = f_bar
        return result
