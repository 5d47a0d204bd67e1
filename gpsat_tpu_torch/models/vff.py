"""Variational-Fourier-feature local-expert model (torch port of
gpsat_tpu/models/vff.py; reference parity: GPflowVFFModel,
GPSat/models/vff_model.py:48-267).

Separable product of 1-D Matern kernels on a per-expert box domain
[expert_loc - domain_size, expert_loc + domain_size], expanded to cover the
training data (reference domain logic: vff_model.py:178-211). Per-dimension
hyperparameters: lengthscales [D] and kernel_variance [D].
"""

import numpy as np
import torch

from gpsat_tpu_torch.models.exact_gpr import GPRModel
from gpsat_tpu_torch.ops import vff as vff_math
from gpsat_tpu_torch.ops.lbfgs import batched_lbfgs
from gpsat_tpu_torch.ops.packing import ParamSpec, pack, unpack

__all__ = ["resolve_domain", "VFFModel"]


def resolve_domain(coords, coords_scale, domain_size=None, expert_loc=None,
                   eps=1e-8):
    """Per-dim [a, b] in scaled units, expanded to cover the data
    (reference: GPSat/models/vff_model.py:178-211)."""
    D = coords.shape[1]
    a_list, b_list = [], []
    if domain_size is None:
        for i in range(D):
            a_list.append(coords[:, i].min() - eps)
            b_list.append(coords[:, i].max() + eps)
        return np.array(a_list), np.array(b_list)
    if isinstance(domain_size, (int, float)):
        domain_size = [domain_size] * D
    assert len(domain_size) == D
    if expert_loc is None:
        expert_loc = np.mean(coords, axis=0) * np.asarray(coords_scale).reshape(-1)
    expert_loc = np.asarray(expert_loc, dtype=float).reshape(-1)
    cs = np.asarray(coords_scale, dtype=float).reshape(-1)
    if len(cs) == 1:
        cs = np.full(D, cs[0])
    for i in range(D):
        a = (expert_loc[i] - domain_size[i]) / cs[i]
        b = (expert_loc[i] + domain_size[i]) / cs[i]
        a_list.append(min(a, coords[:, i].min() - eps))
        b_list.append(max(b, coords[:, i].max() + eps))
    return np.array(a_list), np.array(b_list)


class VFFModel(GPRModel):
    """VFF expert: O(N M^2) precompute, O(M^3) an iteration,
    M = prod(2 m_d - 1).

    The feature math lives in `_math` (ops/vff.py); ASVGPModel swaps in the
    B-spline feature module (ops/asvgp.py): the same collapsed bound, another
    Kuu and Kuf.
    """

    _math = vff_math

    def __init__(self,
                 data=None, coords_col=None, obs_col=None, coords=None,
                 obs=None, coords_scale=None, obs_scale=None, obs_mean=None,
                 verbose=False, *,
                 kernel="Matern32",
                 num_inducing_features=None,
                 kernel_kwargs=None,
                 domain_size=None,
                 expert_loc=None,
                 noise_variance=None,
                 likelihood_variance=None,
                 jitter=vff_math.DEFAULT_JITTER,
                 **kwargs):
        assert num_inducing_features is not None, \
            "num_inducing_features must be specified for VFF"
        super().__init__(data=data, coords_col=coords_col, obs_col=obs_col,
                         coords=coords, obs=obs, coords_scale=coords_scale,
                         obs_scale=obs_scale, obs_mean=obs_mean,
                         verbose=verbose, kernel=kernel,
                         kernel_kwargs=kernel_kwargs,
                         noise_variance=noise_variance,
                         likelihood_variance=likelihood_variance,
                         jitter=jitter, **kwargs)
        assert kernel in ("Matern12", "Matern32", "Matern52"), \
            f"VFF requires a 1-D Matern kernel, got {kernel}"
        d = self.coords.shape[1]
        # kernel_variance is per-dimension for the separable product kernel;
        # initialised so that the product equals the scalar init
        kv0 = float(self._kernel_variance)
        self._kernel_variance = np.full(d, kv0 ** (1.0 / d))

        if isinstance(num_inducing_features, int):
            num_inducing_features = [num_inducing_features] * d
        assert len(num_inducing_features) == d
        self.ms = tuple(int(m) for m in num_inducing_features)
        self.a, self.b = resolve_domain(self.coords, self.coords_scale,
                                        domain_size=domain_size,
                                        expert_loc=expert_loc)

    # kernel_variance is a [D] vector here
    def get_kernel_variance(self):
        return np.asarray(self._kernel_variance).copy()

    def set_kernel_variance(self, kernel_variance):
        kv = np.asarray(kernel_variance, dtype=float).reshape(-1)
        d = self.coords.shape[1]
        if len(kv) == 1:
            kv = np.full(d, kv[0] ** (1.0 / d))
        assert len(kv) == d
        self._kernel_variance = kv

    def _vff_args(self):
        """(X, y, all-true mask, a, b) on the model's device."""
        return (*self._data(), self._tensor(self.a), self._tensor(self.b))

    def get_objective_function_value(self):
        """The collapsed VFF ELBO (reference semantics: vff_model.py:265)."""
        with torch.no_grad():
            return float(self._math.elbo(self._param_dict(), *self._vff_args(),
                                         self.ms, kernel=self.kernel,
                                         jitter=self.jitter))

    def optimise_parameters(self, max_iter=1000, fixed_params=None,
                            gtol=1e-6, ftol=1e-11, **opt_kwargs):
        """L-BFGS on the collapsed negative ELBO by autograd."""
        if fixed_params is None:
            fixed_params = []
        d = self.coords.shape[1]
        free_names = tuple(n for n in self.param_names if n not in fixed_params)
        if not free_names:
            return True
        shapes = {"lengthscales": (d,), "kernel_variance": (d,),
                  "likelihood_variance": ()}
        spec = ParamSpec([(n, shapes[n]) for n in free_names])
        X, y, m, a, b = self._vff_args()
        bij = {n: self.transforms[n] for n in free_names}
        params = self._param_dict()
        fixed = {n: params[n] for n in self.param_names if n not in free_names}
        ms, kernel, jitter = self.ms, self.kernel, self.jitter
        mathmod = self._math

        def objective(u, X, y, m, a, b, bijectors, fixed_v):
            free = unpack(u, spec)
            p = dict(fixed_v)
            for n in free_names:
                p[n] = bijectors[n].forward(free[n])
            return mathmod.neg_elbo(p, X, y, m, a, b, ms, kernel=kernel,
                                    jitter=jitter)

        u0 = pack({n: bij[n].inverse(params[n]) for n in free_names}, spec)
        res = batched_lbfgs(objective, u0[None].to(self.dtype),
                            args=(X[None], y[None], m[None], a[None], b[None],
                                  self._batch_of_one(bij),
                                  self._batch_of_one(fixed)),
                            max_iter=max_iter, gtol=gtol, ftol=ftol)
        opt = unpack(res.x[0], spec)
        for n in free_names:
            val = self.transforms[n].forward(opt[n]).detach().cpu().numpy()
            if n == "likelihood_variance":
                self.set_likelihood_variance(float(val))
            else:
                getattr(self, f"set_{n}")(val)
        self._last_opt_success = bool(res.converged[0])
        return self._last_opt_success

    def predict(self, coords, full_cov=False, apply_scale=True, **kwargs):
        coords = self._prediction_coords(coords, apply_scale)
        X, y, m, a, b = self._vff_args()
        with torch.no_grad():
            out = self._math.predict(self._param_dict(), X, y, m,
                                     self._tensor(coords), a, b, self.ms,
                                     kernel=self.kernel, jitter=self.jitter)
        result = {k: v.cpu().numpy() for k, v in out.items()}
        f_bar = self.obs_mean[:, 0]
        result["f_bar"] = np.repeat(f_bar, len(result["f*"])) \
            if len(f_bar) == 1 else f_bar
        return result
