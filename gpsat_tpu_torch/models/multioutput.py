"""Multi-output forward-model GPR experts (torch port of
gpsat_tpu/models/multioutput.py; reference: GPSat/models/multioutput/gpr.py:14
MultioutputGPR and :82 MultioutputSVGP, experimental and not in the
reference's own factory; API-compatible with BaseGPRModel so they slot into
custom drivers).

Observation model: y = H f(x) + eps (or y = h(x, f) + eps), eps ~ N(0, R);
f = W g with Q latent GPs. Use case: multi-satellite fusion with
per-instrument measurement operators and noise covariances (e.g. radar and
laser freeboard).
"""

import numpy as np
import torch

from gpsat_tpu_torch.models.base import BaseGPRModel
from gpsat_tpu_torch.models.batched import Adam
from gpsat_tpu_torch.ops import multioutput as mo
from gpsat_tpu_torch.ops.lbfgs import batched_lbfgs
from gpsat_tpu_torch.ops.packing import ParamSpec, pack, unpack
from gpsat_tpu_torch.ops.transforms import Softplus

__all__ = ["MultioutputGPRModel", "MultioutputSVGPModel"]


class _MultioutputBase(BaseGPRModel):
    """Shared parameter surface: per-latent lengthscales [Q, D] and kernel
    variances [Q], Softplus transforms, numpy state on the host."""

    def _init_hypers(self, kernel_kwargs, Q):
        kernel_kwargs = dict(kernel_kwargs or {})
        d = self.coords.shape[1]
        ls = np.asarray(kernel_kwargs.get("lengthscales", np.ones((Q, d))),
                        dtype=float)
        if ls.ndim <= 1:
            ls = np.broadcast_to(ls, (Q, d)).copy()
        self._lengthscales = ls                      # [Q, D]
        kv = np.asarray(kernel_kwargs.get("variance", np.ones(Q)),
                        dtype=float)
        self._kernel_variance = np.broadcast_to(np.atleast_1d(kv),
                                                (Q,)).copy()
        # the bijectors' tensors live on the model's device: a host tensor
        # there would be copied to the card, with a sync, at every step
        self.transforms = {n: Softplus().map_tensors(self._tensor)
                           for n in ("lengthscales", "kernel_variance")}

    def get_lengthscales(self):
        return self._lengthscales.copy()

    def set_lengthscales(self, lengthscales):
        ls = np.asarray(lengthscales, dtype=float)
        self._lengthscales = ls.reshape(self._lengthscales.shape)

    def get_kernel_variance(self):
        return self._kernel_variance.copy()

    def set_kernel_variance(self, kernel_variance):
        kv = np.atleast_1d(np.asarray(kernel_variance, dtype=float))
        self._kernel_variance = np.broadcast_to(
            kv, self._kernel_variance.shape).copy()

    def _param_dict(self):
        return {"lengthscales": self._tensor(self._lengthscales),
                "kernel_variance": self._tensor(self._kernel_variance)}

    def _f_bar(self, n):
        f_bar = np.atleast_1d(self.obs_mean[0])
        return np.broadcast_to(f_bar, (n, len(f_bar))).copy()


class MultioutputGPRModel(_MultioutputBase):
    """Exact multi-output GPR with a linear measurement operator."""

    def __init__(self, data=None, coords_col=None, obs_col=None, coords=None,
                 obs=None, coords_scale=None, obs_scale=None, obs_mean=None,
                 verbose=False, *,
                 kernel="Matern32",
                 num_latent_gps=None,
                 W=None, H=None, R=None,
                 kernel_kwargs=None,
                 jitter=1e-8, device=None, dtype=None, **kwargs):
        super().__init__(data=data, coords_col=coords_col, obs_col=obs_col,
                         coords=coords, obs=obs, coords_scale=coords_scale,
                         obs_scale=obs_scale, obs_mean=obs_mean,
                         verbose=verbose, device=device, dtype=dtype)
        P = self.obs.shape[1]
        if W is None:
            assert num_latent_gps is not None or H is not None, \
                "provide W, H or num_latent_gps"
            L = H.shape[1] if H is not None else (num_latent_gps or P)
            W = np.eye(L)
        self.W = np.asarray(W, dtype=float)           # [L, Q]
        L, Q = self.W.shape
        self.H = np.eye(P, L) if H is None else np.asarray(H, dtype=float)
        assert self.H.shape == (P, L), f"H must be [P={P}, L={L}]"
        self.R = 0.1 * np.eye(P) if R is None else np.asarray(R, dtype=float)
        assert self.R.shape == (P, P)
        self.kernel = kernel
        self.jitter = float(jitter)
        self.num_latent_gps = Q
        self._init_hypers(kernel_kwargs, Q)

    @property
    def param_names(self):
        return ["lengthscales", "kernel_variance"]

    def _args(self):
        """(W, H, R, X, Y, all-true mask) on the model's device."""
        return (self._tensor(self.W), self._tensor(self.H),
                self._tensor(self.R), self._tensor(self.coords),
                self._tensor(self.obs),
                torch.ones(len(self.obs), dtype=torch.bool,
                           device=self.device))

    def get_objective_function_value(self):
        """Negative log marginal likelihood of the stacked observations."""
        with torch.no_grad():
            return -float(mo.log_marginal_likelihood(
                self._param_dict(), *self._args(), kernel=self.kernel,
                jitter=self.jitter))

    def optimise_parameters(self, max_iter=500, fixed_params=None, gtol=1e-6,
                            ftol=1e-11, **kwargs):
        """L-BFGS (a batch of one) on the negative log marginal likelihood;
        returns True when converged."""
        if fixed_params is None:
            fixed_params = []
        Q, d = self._lengthscales.shape
        free_names = tuple(n for n in self.param_names
                           if n not in fixed_params)
        shapes = {"lengthscales": (Q, d), "kernel_variance": (Q,)}
        spec = ParamSpec([(n, shapes[n]) for n in free_names])
        args = self._args()
        bij = {n: self.transforms[n] for n in free_names}
        params = self._param_dict()
        fixed = {n: params[n] for n in self.param_names
                 if n not in free_names}
        kernel, jitter = self.kernel, self.jitter

        def objective(u):
            out = []
            for ub in u:
                p = dict(fixed)
                free = unpack(ub, spec)
                for n in free_names:
                    p[n] = bij[n].forward(free[n])
                out.append(-mo.log_marginal_likelihood(
                    p, *args, kernel=kernel, jitter=jitter))
            return torch.stack(out)

        u0 = pack({n: bij[n].inverse(params[n]) for n in free_names}, spec)
        res = batched_lbfgs(objective, u0[None], max_iter=max_iter,
                            gtol=gtol, ftol=ftol)
        opt = unpack(res.x[0], spec)
        for n in free_names:
            getattr(self, f"set_{n}")(
                self.transforms[n].forward(opt[n]).cpu().numpy())
        self._last_opt_success = bool(res.converged[0])
        return self._last_opt_success

    def predict(self, coords, full_cov=False, apply_scale=True, **kwargs):
        """Posterior of the latent field f at coords: 'f*', 'f*_var'
        [Ns, L]; observation space 'y*', 'y_var' [Ns, P]; 'f_bar'."""
        coords = self._prediction_coords(coords, apply_scale)
        args = self._args()
        Xs = self._tensor(coords)
        with torch.no_grad():
            mean, var = mo.predict_f(self._param_dict(), *args, Xs,
                                     kernel=self.kernel, jitter=self.jitter)
            ym, yc = mo.predict_y(self._param_dict(), *args, Xs,
                                  kernel=self.kernel, jitter=self.jitter)
        out = {"f*": mean.cpu().numpy(), "f*_var": var.cpu().numpy(),
               "y*": ym.cpu().numpy(),
               "y_var": torch.diagonal(yc, dim1=-2, dim2=-1).cpu().numpy()}
        out["f_bar"] = self._f_bar(len(coords))
        return out


class MultioutputSVGPModel(_MultioutputBase):
    """Sparse variational multi-output GP with a forward-model likelihood
    (reference: MultioutputSVGP, GPSat/models/multioutput/gpr.py:82).

    Observation model y = h(x, f) + eps, eps ~ N(0, R); f = W g with Q latent
    GPs sharing M inducing locations. `forward_model` selects the likelihood:
    an [P, L] array/None gives the analytic linear likelihood
    (LinearModelLikelihood, likelihoods.py:40); a callable h(X, F) -> [N, P]
    of torch ops gives the Monte-Carlo nonlinear likelihood
    (NonlinearModelLikelihood, likelihoods.py:148) with `num_mc_samples`
    draws, from a torch.Generator seeded with `mc_seed` unless the caller
    passes them.
    """

    def __init__(self, data=None, coords_col=None, obs_col=None, coords=None,
                 obs=None, coords_scale=None, obs_scale=None, obs_mean=None,
                 verbose=False, *,
                 kernel="Matern32",
                 num_latent_gps=None,
                 W=None, H=None, R=None,
                 forward_model=None,
                 num_inducing_points=None,
                 num_mc_samples=100,
                 mc_seed=0,
                 inducing_seed=42,
                 kernel_kwargs=None,
                 jitter=1e-6, device=None, dtype=None, **kwargs):
        super().__init__(data=data, coords_col=coords_col, obs_col=obs_col,
                         coords=coords, obs=obs, coords_scale=coords_scale,
                         obs_scale=obs_scale, obs_mean=obs_mean,
                         verbose=verbose, device=device, dtype=dtype)
        P = self.obs.shape[1]
        self.h = None
        if callable(forward_model):
            self.h = forward_model
            assert num_latent_gps is not None, \
                "num_latent_gps required with a nonlinear forward model"
            L = num_latent_gps if W is None else np.asarray(W).shape[0]
        elif forward_model is not None:
            H = np.asarray(forward_model, dtype=float)
            L = H.shape[1]
        elif H is not None:
            H = np.asarray(H, dtype=float)
            L = H.shape[1]
        else:
            L = num_latent_gps or P
        if W is None:
            W = np.eye(L, num_latent_gps or L)
        self.W = np.asarray(W, dtype=float)            # [L, Q]
        L, Q = self.W.shape
        self.H = None
        if self.h is None:
            self.H = np.eye(P, L) if H is None else np.asarray(H, dtype=float)
            assert self.H.shape == (P, L), f"H must be [P={P}, L={L}]"
        self.R = 0.1 * np.eye(P) if R is None else np.asarray(R, dtype=float)
        assert self.R.shape == (P, P)
        self.kernel = kernel
        self.jitter = float(jitter)
        self.num_latent_gps = Q
        self.num_mc_samples = int(num_mc_samples)
        self.mc_seed = int(mc_seed)

        # seeded random-subset inducing locations (reference pattern:
        # gpflow_models.py:807-819), the JAX package's numpy draws
        N = len(self.coords)
        M = N if num_inducing_points is None \
            else min(int(num_inducing_points), N)
        rng = np.random.default_rng(inducing_seed)
        self.inducing_points = self.coords[rng.permutation(N)[:M]].copy()
        self._q_mu = np.zeros((M, Q))
        self._q_sqrt_raw = np.broadcast_to(np.eye(M), (Q, M, M)).copy()
        self._init_hypers(kernel_kwargs, Q)

    # -- parameter surface ---------------------------------------------------

    @property
    def param_names(self):
        return ["lengthscales", "kernel_variance", "inducing_points",
                "inducing_mean", "inducing_chol"]

    def get_inducing_points(self):
        return self.inducing_points.copy()

    def set_inducing_points(self, Z):
        self.inducing_points = np.asarray(Z, dtype=float).reshape(
            self.inducing_points.shape)

    def get_inducing_mean(self):
        return self._q_mu.copy()

    def set_inducing_mean(self, q_mu):
        self._q_mu = np.asarray(q_mu, dtype=float).reshape(self._q_mu.shape)

    def get_inducing_chol(self):
        return np.stack([np.tril(q) for q in self._q_sqrt_raw])

    def set_inducing_chol(self, q_sqrt):
        self._q_sqrt_raw = np.asarray(q_sqrt, dtype=float).reshape(
            self._q_sqrt_raw.shape)

    def _args(self):
        """(W, R, X, Y, mask, Z, zmask) on the model's device."""
        N, M = len(self.coords), len(self.inducing_points)
        return (self._tensor(self.W), self._tensor(self.R),
                self._tensor(self.coords), self._tensor(self.obs),
                torch.ones(N, dtype=torch.bool, device=self.device),
                self._tensor(self.inducing_points),
                torch.ones(M, dtype=torch.bool, device=self.device))

    def draw_eps(self, generator=None):
        """One [S, N, Q] standard normal draw of the Monte-Carlo likelihood
        from `generator` (on the model's device), by default the first draw
        of a generator seeded with `mc_seed`."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                self.mc_seed)
        return torch.randn(
            (self.num_mc_samples, len(self.coords), self.num_latent_gps),
            generator=generator, dtype=self.dtype, device=self.device)

    def _elbo_kwargs(self):
        """svgp_elbo's likelihood arguments, on the device, but the draws."""
        kw = dict(kernel=self.kernel, jitter=self.jitter)
        if self.h is None:
            kw["H"] = self._tensor(self.H)
        else:
            kw["h"] = self.h
        return kw

    def get_objective_function_value(self, eps=None):
        """The ELBO (for nonlinear h, Monte-Carlo with `eps` [S, N, Q], by
        default the first draw from `mc_seed`)."""
        W, R, X, Y, m, Z, zm = self._args()
        kw = self._elbo_kwargs()
        if self.h is not None:
            kw["eps"] = self.draw_eps() if eps is None else self._tensor(eps)
        with torch.no_grad():
            return float(mo.svgp_elbo(
                self._param_dict(), W, R, self._tensor(self._q_mu),
                self._tensor(self._q_sqrt_raw), X, Y, m, Z, zm, **kw))

    def optimise_parameters(self, max_iter=2000, learning_rate=1e-2,
                            fixed_params=None, check_every=10,
                            persistence=100, early_stop=True, verbose=False,
                            mc_draws=None, **kwargs):
        """Adam on (hypers, q_mu, q_sqrt) with the reference's plateau early
        stop, reading the loss back once a check. For nonlinear h, each step
        takes a fresh Monte-Carlo draw: `mc_draws` (a callable of the step
        number, or a stacked [steps, S, N, Q] tensor) or, by default, the
        next draw of a generator seeded with `mc_seed`."""
        if fixed_params is None:
            fixed_params = []
        free_names = tuple(n for n in ("lengthscales", "kernel_variance")
                           if n not in fixed_params)
        train_qm = "inducing_mean" not in fixed_params
        train_qs = "inducing_chol" not in fixed_params
        W, R, X, Y, m, Z, zm = self._args()
        params = self._param_dict()
        bij = {n: self.transforms[n] for n in free_names}
        fixed = {n: params[n] for n in ("lengthscales", "kernel_variance")
                 if n not in free_names}
        theta = {n: bij[n].inverse(params[n]) for n in free_names}
        theta["qm"] = self._tensor(self._q_mu)
        theta["qs"] = self._tensor(self._q_sqrt_raw)
        # a frozen leaf gets no gradient and stays where it is, as a
        # stop_gradient leaf does under optax's Adam
        trained = list(free_names) + (["qm"] if train_qm else []) \
            + (["qs"] if train_qs else [])

        def unpack_theta(th):
            p = dict(fixed)
            for n in free_names:
                p[n] = bij[n].forward(th[n])
            return p

        if mc_draws is None:
            gen = torch.Generator(device=self.device).manual_seed(
                self.mc_seed)
            draw = lambda it: self.draw_eps(gen)  # noqa: E731
        elif callable(mc_draws):
            draw = mc_draws
        else:
            draw = lambda it: mc_draws[it]  # noqa: E731
        kw = self._elbo_kwargs()

        opt = Adam(learning_rate)
        max_elbo, max_count = -np.inf, 0
        stopped_early, opt_success = False, np.nan
        for it in range(int(max_iter)):
            if self.h is not None:
                kw["eps"] = self._tensor(draw(it))
            with torch.enable_grad():
                leaves = {k: theta[k].detach().requires_grad_(True)
                          for k in trained}
                th = {**theta, **leaves}
                v = -mo.svgp_elbo(unpack_theta(th), W, R, th["qm"], th["qs"],
                                  X, Y, m, Z, zm, **kw)
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
        for n in free_names:
            getattr(self, f"set_{n}")(p_final[n].cpu().numpy())
        self._q_mu = theta["qm"].cpu().numpy().astype(float)
        self._q_sqrt_raw = theta["qs"].cpu().numpy().astype(float)
        self._last_opt_success = opt_success if stopped_early else np.nan
        self._last_opt_steps = it + 1
        return self._last_opt_success

    def predict(self, coords, full_cov=False, apply_scale=True, **kwargs):
        """Latent-field posterior f at coords ('f*', 'f*_var' [Ns, L]);
        observation-space 'y*'/'y_var' added for the linear likelihood."""
        coords = self._prediction_coords(coords, apply_scale)
        W, R, X, Y, m, Z, zm = self._args()
        Xs = self._tensor(coords)
        qm, qs = self._tensor(self._q_mu), self._tensor(self._q_sqrt_raw)
        with torch.no_grad():
            mean, var = mo.svgp_predict_f(
                self._param_dict(), W, qm, qs, Z, zm, Xs,
                kernel=self.kernel, jitter=self.jitter)
            out = {"f*": mean.cpu().numpy(), "f*_var": var.cpu().numpy()}
            if self.H is not None:
                ym, yc = mo.svgp_predict_y(
                    self._param_dict(), W, self._tensor(self.H), R, qm, qs,
                    Z, zm, Xs, kernel=self.kernel, jitter=self.jitter)
                out["y*"] = ym.cpu().numpy()
                out["y_var"] = torch.diagonal(
                    yc, dim1=-2, dim2=-1).cpu().numpy()
        out["f_bar"] = self._f_bar(len(coords))
        return out
