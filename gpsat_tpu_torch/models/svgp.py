"""SVGP local-expert model (torch port of gpsat_tpu/models/svgp.py;
reference parity: GPflowSVGPModel, GPSat/models/gpflow_models.py:904-1310).

Whitened variational parameterisation, Adam optimisation with the reference's
early stop (check the ELBO every `check_every` steps, stop when it has not
improved for `persistence` steps). Variational parameters use the
reference's names and shapes: inducing_mean q_mu [M, 1], inducing_chol
q_sqrt [1, M, M].
"""

import numpy as np
import torch

from gpsat_tpu_torch.models.batched import Adam
from gpsat_tpu_torch.models.sgpr import SGPRModel
from gpsat_tpu_torch.ops import svgp as svgp_math

__all__ = ["SVGPModel"]


class SVGPModel(SGPRModel):
    """Sparse variational GP expert: O(N M^2 + M^3) per step."""

    def __init__(self, *args, num_inducing_points=None, minibatch_size=None,
                 jitter=svgp_math.DEFAULT_JITTER, **kwargs):
        # num_inducing None -> inducing = data points (reference behaviour,
        # gpflow_models.py:1056-1064)
        super().__init__(*args, num_inducing_points=(
            num_inducing_points if num_inducing_points is not None else 10**9),
            jitter=jitter, **kwargs)
        self.num_inducing_points = num_inducing_points
        self.minibatch_size = minibatch_size
        M = len(self.inducing_points)
        self._q_mu = np.zeros(M)
        self._q_sqrt_raw = np.eye(M)

    @property
    def param_names(self):
        return list(self.HYPER_NAMES) + ["inducing_points", "inducing_mean",
                                         "inducing_chol"]

    def get_inducing_mean(self):
        return self._q_mu.copy()[:, None]            # [M, 1] like the reference

    def set_inducing_mean(self, q_mu):
        self._q_mu = np.asarray(q_mu, dtype=float).reshape(-1)

    def set_inducing_mean_constraints(self, **kwargs):
        pass

    def get_inducing_chol(self):
        return np.tril(self._q_sqrt_raw)[None, :, :]  # [1, M, M] like the reference

    def set_inducing_chol(self, q_sqrt):
        q = np.asarray(q_sqrt, dtype=float)
        if q.ndim == 3:
            q = q[0]
        self._q_sqrt_raw = q

    def set_inducing_chol_constraints(self, **kwargs):
        pass

    def get_objective_function_value(self):
        """The ELBO (the reference averages it over a minibatch,
        gpflow_models.py:1101; here it is exact and full-batch)."""
        with torch.no_grad():
            return float(svgp_math.elbo(
                self._param_dict(), self._tensor(self._q_mu),
                self._tensor(self._q_sqrt_raw), *self._sgpr_args(),
                kernel=self.kernel, jitter=self.jitter))

    def optimise_parameters(self, train_inducing_points=False,
                            natural_gradients=False, fixed_params=None,
                            gamma=0.1, learning_rate=1e-2, max_iter=10_000,
                            persistence=100, check_every=10, early_stop=True,
                            verbose=False, **kwargs):
        """Adam on hyperparameters and variational parameters with the
        reference's plateau early stop (gpflow_models.py:1117-1245). The
        inducing locations stay fixed, as in the JAX package's model. Reads
        the objective back once per check, not once per step."""
        if fixed_params is None:
            fixed_params = []
        hyper_names = tuple(n for n in self.HYPER_NAMES
                            if n not in fixed_params)
        train_qm = "inducing_mean" not in fixed_params
        train_qs = "inducing_chol" not in fixed_params

        X, y, m, Z, zm = self._sgpr_args()
        params = self._param_dict()
        bij = {n: self.transforms[n] for n in hyper_names}
        fixed = {n: params[n] for n in self.HYPER_NAMES
                 if n not in hyper_names}
        kernel, jitter = self.kernel, self.jitter

        theta = {n: bij[n].inverse(params[n]) for n in hyper_names}
        theta["qm"] = self._tensor(self._q_mu)
        theta["qs"] = self._tensor(self._q_sqrt_raw)
        # leaves Adam moves (the others have zero gradients, on which
        # optax's Adam leaves them where they are)
        trained = list(hyper_names) + ([] if natural_gradients else (
            (["qm"] if train_qm else []) + (["qs"] if train_qs else [])))

        def unpack_theta(th):
            p = dict(fixed)
            for n in hyper_names:
                p[n] = bij[n].forward(th[n])
            return p

        opt = Adam(learning_rate)
        max_elbo, max_count = -np.inf, 0
        stopped_early, opt_success = False, np.nan
        for it in range(int(max_iter)):
            if natural_gradients:
                # natgrad on (q_mu, q_sqrt) precedes the Adam step
                # (reference: gpflow_models.py:1204-1214)
                with torch.no_grad():
                    qm_n, qs_n = svgp_math.natgrad_step(
                        unpack_theta(theta), theta["qm"], theta["qs"], X, y,
                        m, Z, zm, gamma, kernel=kernel, jitter=jitter)
                    ok = torch.isfinite(qm_n).all() & \
                        torch.isfinite(qs_n).all()
                    if train_qm:
                        theta["qm"] = torch.where(ok, qm_n, theta["qm"])
                    if train_qs:
                        theta["qs"] = torch.where(ok, qs_n, theta["qs"])
            with torch.enable_grad():
                leaves = {k: theta[k].detach().requires_grad_(True)
                          for k in trained}
                th = {**theta, **leaves}
                v = svgp_math.neg_elbo(unpack_theta(th), th["qm"], th["qs"],
                                       X, y, m, Z, zm, kernel=kernel,
                                       jitter=jitter)
                grads = torch.autograd.grad(v, list(leaves.values())) \
                    if leaves else ()
            with torch.no_grad():
                theta = opt.step(theta, dict(zip(leaves, grads)))
            if it % check_every == 0:
                elbo_now = -float(v.detach())
                if np.isnan(elbo_now):
                    stopped_early, opt_success = True, False
                    break
                if verbose:
                    print(f"step: {it}, elbo: {elbo_now:.2f}")
                if elbo_now > max_elbo and early_stop:
                    max_elbo, max_count = elbo_now, 0
                else:
                    max_count += check_every
                    if max_count >= persistence and early_stop:
                        stopped_early, opt_success = True, True
                        break

        with torch.no_grad():
            p_final = unpack_theta(theta)
        for n in hyper_names:
            val = p_final[n].cpu().numpy()
            if n == "lengthscales":
                self.set_lengthscales(val)
            else:
                self.set_parameters(**{n: float(val)})
        self._q_mu = theta["qm"].cpu().numpy().astype(float)
        self._q_sqrt_raw = theta["qs"].cpu().numpy().astype(float)
        self._last_opt_success = opt_success if stopped_early else np.nan
        return self._last_opt_success

    def predict(self, coords, full_cov=False, apply_scale=True, **kwargs):
        coords = self._prediction_coords(coords, apply_scale)
        _, _, _, Z, zm = self._sgpr_args()
        with torch.no_grad():
            out = svgp_math.predict(self._param_dict(),
                                    self._tensor(self._q_mu),
                                    self._tensor(self._q_sqrt_raw), Z, zm,
                                    self._tensor(coords), kernel=self.kernel,
                                    jitter=self.jitter)
        result = {k: v.cpu().numpy() for k, v in out.items()}
        f_bar = self.obs_mean[:, 0]
        result["f_bar"] = np.repeat(f_bar, len(result["f*"])) \
            if len(f_bar) == 1 else f_bar
        return result
