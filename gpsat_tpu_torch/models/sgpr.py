"""Sparse GPR (Titsias) local-expert model (torch port of
gpsat_tpu/models/sgpr.py; reference parity: GPflowSGPRModel,
GPSat/models/gpflow_models.py:666-901).

Inducing points default to a random subset of the (scaled) training inputs,
the reference's selection method (gpflow_models.py:807-819) with an explicit
seed: the same numpy draws as the JAX package.
"""

import numpy as np
import torch

from gpsat_tpu_torch.models.exact_gpr import GPRModel
from gpsat_tpu_torch.ops import sgpr as sgpr_math
from gpsat_tpu_torch.ops.lbfgs import batched_lbfgs
from gpsat_tpu_torch.ops.packing import ParamSpec, pack, unpack

__all__ = ["select_inducing", "SGPRModel"]


def select_inducing(coords, num_inducing, seed=42):
    """Random-subset inducing points (M x D); all points when n <= M."""
    n = len(coords)
    if n <= num_inducing:
        return np.asarray(coords, dtype=float).copy()
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)[:num_inducing]
    return np.asarray(coords, dtype=float)[idx]


class SGPRModel(GPRModel):
    """Titsias sparse-GPR expert: O(N M^2) compute, O(N M) memory."""

    def __init__(self, *args, num_inducing_points=500, inducing_seed=42,
                 jitter=sgpr_math.DEFAULT_JITTER, **kwargs):
        kwargs.setdefault("jitter", jitter)
        super().__init__(*args, **kwargs)
        self.num_inducing_points = num_inducing_points
        self.inducing_points = select_inducing(self.coords,
                                               num_inducing_points,
                                               seed=inducing_seed)

    @property
    def param_names(self):
        return super().param_names + ["inducing_points"]

    def get_inducing_points(self):
        return np.asarray(self.inducing_points).copy()

    def set_inducing_points(self, inducing_points):
        self.inducing_points = np.asarray(inducing_points, dtype=float)

    def set_inducing_points_constraints(self, **kwargs):
        # inducing locations are unconstrained; accept and ignore
        pass

    def _sgpr_args(self):
        """(X, y, mask, Z, all-true zmask) on the model's device."""
        Z = self._tensor(self.inducing_points)
        return (*self._data(), Z,
                torch.ones(len(Z), dtype=torch.bool, device=self.device))

    def get_objective_function_value(self):
        """The ELBO (positive), matching the reference's SGPR semantics
        (gpflow_models.py:864: returns elbo, not its negative)."""
        with torch.no_grad():
            return float(sgpr_math.elbo(self._param_dict(),
                                        *self._sgpr_args(),
                                        kernel=self.kernel,
                                        jitter=self.jitter))

    def optimise_parameters(self, train_inducing_points=False, max_iter=1000,
                            fixed_params=None, gtol=1e-6, ftol=1e-11,
                            **opt_kwargs):
        """L-BFGS on the collapsed negative ELBO by autograd through
        ops/sgpr.neg_elbo; with `train_inducing_points` the inducing
        locations join the optimised vector."""
        if fixed_params is None:
            fixed_params = []
        hyper_names = tuple(n for n in self.HYPER_NAMES
                            if n not in fixed_params)
        d = self.coords.shape[1]
        M = len(self.inducing_points)
        entries = [(n, (d,) if n == "lengthscales" else ())
                   for n in hyper_names]
        if train_inducing_points:
            entries.append(("inducing_points", (M, d)))
        if not entries:
            return True
        spec = ParamSpec(entries)
        X, y, m, Z, zm = self._sgpr_args()
        bij = {n: self.transforms[n] for n in hyper_names}
        kernel, jitter = self.kernel, self.jitter

        def objective(u, X, y, m, Z, zm, bijectors, fixed):
            free = unpack(u, spec)
            params = dict(fixed)
            for n in hyper_names:
                params[n] = bijectors[n].forward(free[n])
            Z_use = free.get("inducing_points", Z)
            return sgpr_math.neg_elbo(params, X, y, m, Z_use, zm,
                                      kernel=kernel, jitter=jitter)

        params = self._param_dict()
        fixed = {n: params[n] for n in self.HYPER_NAMES
                 if n not in hyper_names}
        u0_parts = {n: bij[n].inverse(params[n]) for n in hyper_names}
        if train_inducing_points:
            u0_parts["inducing_points"] = Z
        u0 = pack(u0_parts, spec)

        res = batched_lbfgs(objective, u0[None].to(self.dtype),
                            args=(X[None], y[None], m[None], Z[None],
                                  zm[None], self._batch_of_one(bij),
                                  self._batch_of_one(fixed)),
                            max_iter=max_iter, gtol=gtol, ftol=ftol)
        opt = unpack(res.x[0], spec)
        if train_inducing_points:
            self.set_inducing_points(
                opt["inducing_points"].detach().cpu().numpy())
        return self._store_optimum(opt, hyper_names, res)

    def predict(self, coords, full_cov=False, apply_scale=True, **kwargs):
        coords = self._prediction_coords(coords, apply_scale)
        with torch.no_grad():
            out = sgpr_math.predict(self._param_dict(), *self._sgpr_args(),
                                    self._tensor(coords), kernel=self.kernel,
                                    jitter=self.jitter)
        result = {k: v.cpu().numpy() for k, v in out.items()}
        f_bar = self.obs_mean[:, 0]
        result["f_bar"] = np.repeat(f_bar, len(result["f*"])) \
            if len(f_bar) == 1 else f_bar
        return result
