"""Batched exact-GPR engine: fit + predict for a whole padded bucket of local
experts (torch port of BatchedGPR in gpsat_tpu/models/batched.py).

A bucket of B experts with identical padded shapes is optimised by one
batched L-BFGS and predicted in one masked batched posterior evaluation. On a
CUDA device, shapes inside the kernels' gates go through the fused CUDA
kernels (ops/cuda_gpr.py); everything else runs the ops/gpr torch path, as the
JAX engine runs XLA outside its Pallas gates.

Inputs may be numpy arrays or tensors; results come back as numpy arrays.
"""

import numpy as np
import torch

from gpsat_tpu_torch import default_dtype, resolve_device
from gpsat_tpu_torch.models.exact_gpr import (make_gpr_objective,
                                              make_gpr_vg_fun,
                                              move_within_bounds)
from gpsat_tpu_torch.ops import cuda_gpr
from gpsat_tpu_torch.ops import gpr as gpr_math
from gpsat_tpu_torch.ops.lbfgs import (batched_lbfgs, batched_lbfgs_pool,
                                       linesearch_policy)
from gpsat_tpu_torch.ops.packing import ParamSpec, pack, unpack
from gpsat_tpu_torch.ops.transforms import Sigmoid, Softplus

__all__ = ["BatchedGPR"]


def _min_valid_size(mask, n_padded):
    """Smallest per-expert VALID (masked) data count in the bucket, for the
    linesearch_policy recovery gate, quantized to the policy breakpoint."""
    if mask is None:
        return int(n_padded)
    n_min = int(_np(mask).sum(axis=1).min())
    return 256 if n_min >= 256 else 128


def _np(a):
    """Host numpy view of a tensor or array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _kernel_path(device):
    """Whether work on `device` goes through the CUDA kernel wrappers: on a
    CUDA device, or (on the CPU, for tests) when cuda_gpr._FORCE_KERNEL_PATH
    is set, which makes the wrappers run their plain versions."""
    return device.type == "cuda" or cuda_gpr._FORCE_KERNEL_PATH


def _constrained(u, spec, free_names, bijectors, fixed):
    free = unpack(u, spec)
    params = dict(fixed)
    for n in free_names:
        params[n] = bijectors[n].forward(free[n])
    return params


def _gpr_fit_predict(u0, X, y, mask, Xs, bijectors, fixed, *, kernel,
                     free_names, d, optimise, do_predict, max_iter, gtol,
                     ftol, compute_fval=True, ls_n=None):
    """(Optional) batched L-BFGS fit + masked batched posterior prediction
    for a [B, N(, P)] bucket."""
    objective, spec = make_gpr_objective(kernel, free_names, d)
    B = u0.shape[0]
    kernels = _kernel_path(X.device)

    if optimise and free_names:
        # every L-BFGS trial evaluates value_and_grad: through the fused CUDA
        # kernel inside its gate, else autograd through ops/gpr.nlml_fused
        vg_fun = make_gpr_vg_fun(kernel, free_names, d) \
            if kernels and cuda_gpr.cuda_vg_supported(kernel, d, X.shape[1]) \
            else None
        mls, rec = linesearch_policy(
            X.dtype, "gpr", n=X.shape[1] if ls_n is None else ls_n)
        res = batched_lbfgs(objective, u0, (X, y, mask, bijectors, fixed),
                            max_iter, gtol, ftol, 10, mls, rec,
                            vg_fun=vg_fun)
        u, fval, conv, iters = res.x, res.fun, res.converged, res.iterations
    else:
        u = u0
        if compute_fval:
            with torch.no_grad():
                fval = objective(u0, X, y, mask, bijectors, fixed)
        else:
            # prediction-fill path: the caller discards fval
            fval = torch.zeros(B, dtype=X.dtype, device=X.device)
        conv = torch.zeros(B, dtype=torch.bool, device=X.device)
        iters = torch.zeros(B, dtype=torch.int32, device=X.device)

    with torch.no_grad():
        params = _constrained(u, spec, free_names, bijectors, fixed)
        if not do_predict:
            preds = {}
        elif kernels and cuda_gpr.cuda_predict_supported(
                kernel, d, X.shape[1], Xs.shape[1]):
            preds = cuda_gpr.posterior_predict_batched(
                params, X, y, mask.to(X.dtype), Xs, kernel, 0.0)
            preds = {k: v.to(X.dtype) for k, v in preds.items()}
        else:
            preds = gpr_math.predict(params, X, y, mask, Xs, kernel=kernel)
    return params, fval, conv, iters, preds


class BatchedGPR:
    """Configured batched exact-GPR engine.

    Holds the *shared* per-run configuration (kernel, initial values,
    constraint bijectors, scales); `fit_predict` consumes padded bucket
    arrays and `fit_predict_many` sweeps many same-shape experts. Runs on
    `device` ("cuda" unless the caller passes another), in `dtype` (f32 on
    the card, f64 on the host by default).

    `jitter` is accepted for configuration compatibility and, as in the JAX
    engine, never reaches the objective or the prediction (both run with
    jitter 0; see ROADMAP.md Queue C).
    """

    HYPER_NAMES = ("lengthscales", "kernel_variance", "likelihood_variance")
    model_name = "GPRModel"
    linesearch_kind = "gpr"     # ops/lbfgs.linesearch_policy family

    def __init__(self, coords_dim, kernel="Matern32", kernel_kwargs=None,
                 noise_variance=None, likelihood_variance=None,
                 constraints=None, coords_scale=None, optim_kwargs=None,
                 jitter=0.0, dtype=None, device=None, **unused):
        self.d = int(coords_dim)
        self.kernel = kernel
        self.device = resolve_device(device)
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        self.dtype = default_dtype(self.device) if dtype is None else dtype
        kernel_kwargs = dict(kernel_kwargs or {})
        if "smoothness" in kernel_kwargs:
            from gpsat_tpu_torch.ops.kernels import kernel_from_smoothness
            self.kernel = kernel = kernel_from_smoothness(
                kernel_kwargs.pop("smoothness"), kernel)

        self.user_set = {
            "lengthscales": "lengthscales" in kernel_kwargs,
            "kernel_variance": "variance" in kernel_kwargs,
            "likelihood_variance": (noise_variance is not None or
                                    likelihood_variance is not None),
        }
        ls = np.asarray(kernel_kwargs.pop("lengthscales", np.ones(self.d)),
                        dtype=float)
        if ls.ndim == 0:
            ls = np.full(self.d, float(ls))
        kv = float(kernel_kwargs.pop("variance", 1.0))
        if likelihood_variance is None:
            likelihood_variance = 1.0 if noise_variance is None else noise_variance
        lv = float(likelihood_variance)
        self.init_values = {"lengthscales": ls, "kernel_variance": kv,
                            "likelihood_variance": lv}
        self.coords_scale = np.atleast_2d(
            1.0 if coords_scale is None else np.asarray(coords_scale, dtype=float))

        optim_kwargs = dict(optim_kwargs or {})
        self.max_iter = int(optim_kwargs.pop("max_iter", 1000))
        self.gtol = float(optim_kwargs.pop("gtol", 1e-6))
        self.ftol = float(optim_kwargs.pop("ftol", 1e-11))
        fixed = optim_kwargs.pop("fixed_params", None) or []
        self.free_names = tuple(n for n in self.HYPER_NAMES if n not in fixed)

        # constraint bijectors (bounds divided by coords_scale for lengthscales
        # when 'scale' is set, mirroring GPSat/local_experts.py:1110-1115)
        self.bijectors = {n: Softplus() for n in self.HYPER_NAMES}
        self.bounds = {}
        constraints = constraints or {}
        for name, c in constraints.items():
            if name not in self.HYPER_NAMES:
                continue
            low = np.atleast_1d(np.asarray(c["low"], dtype=float))
            high = np.atleast_1d(np.asarray(c["high"], dtype=float))
            if name == "lengthscales" and c.get("scale", False):
                low = low / self.coords_scale[0, :]
                high = high / self.coords_scale[0, :]
            if name == "lengthscales":
                self.bijectors[name] = Sigmoid(low=torch.as_tensor(low),
                                               high=torch.as_tensor(high))
            else:
                self.bijectors[name] = Sigmoid(low=torch.as_tensor(low[0]),
                                               high=torch.as_tensor(high[0]))
            self.bounds[name] = (low, high)

        # shared initial values moved inside bounds (tol matches the
        # orchestrator call in the reference, GPSat/local_experts.py:1115)
        for name, (low, high) in self.bounds.items():
            cur = move_within_bounds(np.atleast_1d(self.init_values[name]),
                                     low, high, tol=1e-2)
            self.init_values[name] = cur if name == "lengthscales" else float(cur[0])

    def param_shape(self, name):
        return (self.d,) if name == "lengthscales" else ()

    # -- helpers --------------------------------------------------------------

    def _tensor(self, a, dtype=None):
        """Tensor on the engine's device (engine dtype unless given)."""
        dtype = self.dtype if dtype is None else dtype
        if isinstance(a, torch.Tensor):
            return a.to(self.device, dtype)
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _spec(self):
        return ParamSpec([(n, self.param_shape(n)) for n in self.free_names])

    def _unconstrained(self, init, B):
        """[B, P] unconstrained start from the free parameters of `init`."""
        free = {n: self.bijectors[n].inverse(self._tensor(init[n]))
                for n in self.free_names}
        return pack(free, self._spec(), batch_shape=(B,)).to(self.dtype)

    def _batched_bijectors(self, B):
        """Free-parameter bijectors with [B]-leading tensors in the engine
        dtype (unbatched float64 bounds would otherwise promote the whole
        optimisation to f64)."""
        return {n: self.bijectors[n].map_tensors(
            lambda a: self._tensor(a).expand((B,) + tuple(a.shape)))
            for n in self.free_names}

    # -- per-bucket execution ------------------------------------------------

    def _initial_params_batch(self, B, overrides=None, y_var=None, scale=1.0,
                              clamp=True):
        """[B]-batched initial parameter dict (numpy).

        Initial values resolve in priority order: per-expert `overrides`
        (loaded parameters; NaN = absent) > user-specified config values >
        data-driven defaults (kernel variance ~ per-expert signal variance).
        All clamped into constraint bounds when `clamp`.
        """
        out = {}
        for name in self.HYPER_NAMES:
            shape = self.param_shape(name)
            base = np.broadcast_to(np.asarray(self.init_values[name], dtype=float),
                                   (B,) + shape).copy()
            if y_var is not None and not self.user_set.get(name, True):
                if name == "kernel_variance":
                    base = np.maximum(y_var, 1e-10) * scale
                elif name == "likelihood_variance":
                    base = np.maximum(0.1 * y_var, 1e-10) * scale
                elif name == "lengthscales" and scale != 1.0:
                    base = base * scale
            if overrides and name in overrides and overrides[name] is not None:
                ov = np.asarray(overrides[name], dtype=float).reshape((B,) + shape)
                use = ~np.isnan(ov)
                base[use] = ov[use]
            if clamp and name in self.bounds:
                low, high = self.bounds[name]
                base = move_within_bounds(base, low, high, tol=1e-2)
            out[name] = base
        return out

    def _execute(self, init, X, y, mask, Xs_in, optimise, do_predict):
        B = X.shape[0]
        fixed = {n: self._tensor(init[n]) for n in self.HYPER_NAMES
                 if n not in self.free_names}
        u0 = self._unconstrained(init, B)
        return self._call_program(u0, X, y, mask, Xs_in,
                                  self._batched_bijectors(B), fixed,
                                  optimise, do_predict)

    def _call_program(self, u0, X, y, mask, Xs_in, bij_b, fixed, optimise,
                      do_predict, compute_fval=True):
        return _gpr_fit_predict(
            u0, X, y, self._tensor(mask, torch.bool), Xs_in, bij_b, fixed,
            kernel=self.kernel, free_names=self.free_names, d=self.d,
            optimise=bool(optimise), do_predict=bool(do_predict),
            max_iter=self.max_iter, gtol=self.gtol, ftol=self.ftol,
            compute_fval=bool(compute_fval),
            ls_n=_min_valid_size(mask, X.shape[1]))

    @staticmethod
    def _signal_variance(y_np, mask_np):
        cnt = np.maximum(mask_np.sum(axis=1), 1)
        y_mean = (y_np * mask_np).sum(axis=1) / cnt
        return ((y_np - y_mean[:, None]) ** 2 * mask_np).sum(axis=1) / cnt

    def _collapsed(self, kv, fval, y_var, mask_np):
        """Experts that fell into the zero-signal optimum (or failed)."""
        B = len(fval)
        kv_eff = np.asarray(kv).reshape(B, -1).prod(axis=1)
        active = mask_np.any(axis=1)
        return active & ((kv_eff < np.maximum(1e-4 * y_var, 1e-12)) |
                         ~np.isfinite(fval))

    def fit_predict(self, X, y, mask, Xs=None, optimise=True, predict=True,
                    param_overrides=None):
        """Fit + predict one padded bucket.

        X: [B, N, D] scaled coords; y: [B, N] de-meaned scaled obs;
        mask: [B, N]; Xs: [B, P, D] scaled prediction coords or None.

        Optimisation is restarted from an alternative initial point for
        experts that collapse into the degenerate zero-signal optimum
        (kernel variance -> 0), keeping the better NLML of the two runs.
        Returns dict of numpy arrays.
        """
        B = X.shape[0]
        mask_np = _np(mask).astype(bool)
        y_var = self._signal_variance(_np(y), mask_np)

        Xj = self._tensor(X)
        yj = self._tensor(y)
        do_predict = predict and Xs is not None
        Xs_in = torch.zeros(B, 1, self.d, dtype=self.dtype, device=self.device) \
            if Xs is None else self._tensor(Xs)

        init = self._initial_params_batch(B, param_overrides, y_var=y_var,
                                          clamp=bool(optimise))
        params, fval, conv, iters, preds = self._execute(
            init, Xj, yj, mask_np, Xs_in, optimise, do_predict)
        params = {k: _np(v) for k, v in params.items()}
        fval, conv, iters = _np(fval), _np(conv), _np(iters)
        preds = {k: _np(v) for k, v in preds.items()}

        if optimise and self.free_names:
            collapsed = self._collapsed(
                params.get("kernel_variance", np.ones(B)), fval, y_var,
                mask_np)
            if collapsed.any():
                alt = self._initial_params_batch(B, param_overrides,
                                                 y_var=y_var, scale=3.0)
                p2, f2, c2, i2, pr2 = self._execute(
                    alt, Xj, yj, mask_np, Xs_in, optimise, do_predict)
                f2 = _np(f2)
                use2 = collapsed & (f2 < fval) & np.isfinite(f2)
                if use2.any():
                    def pick(a, b):
                        return np.where(use2.reshape((B,) + (1,) * (a.ndim - 1)),
                                        _np(b), a)
                    params = {k: pick(v, p2[k]) for k, v in params.items()}
                    fval = np.where(use2, f2, fval)
                    conv = np.where(use2, _np(c2), conv)
                    iters = np.where(use2, _np(i2), iters)
                    preds = {k: pick(v, pr2[k]) for k, v in preds.items()}

        return {"params": params, "objective": fval, "converged": conv,
                "iterations": iters, "preds": preds}

    # -- pooled multi-chunk execution ---------------------------------------

    def _chunked_fit_predict(self, X, y, mask, Xs, optimise, predict,
                             param_overrides, B):
        """Sequential fit_predict over B-sized chunks."""
        E = X.shape[0]
        outs = []
        for s in range(0, E, B):
            e = min(s + B, E)
            ov = None if param_overrides is None else \
                {k: v[s:e] for k, v in param_overrides.items()}
            outs.append(self.fit_predict(
                X[s:e], y[s:e], mask[s:e], Xs=None if Xs is None else Xs[s:e],
                optimise=optimise, predict=predict, param_overrides=ov))

        def cat(key):
            return np.concatenate([o[key] for o in outs], axis=0)
        return {
            "params": {k: np.concatenate([o["params"][k] for o in outs])
                       for k in outs[0]["params"]},
            "objective": cat("objective"),
            "converged": cat("converged"),
            "iterations": cat("iterations"),
            "preds": {k: np.concatenate([o["preds"][k] for o in outs])
                      for k in outs[0]["preds"]},
        }

    def _pool_objective(self, N=None):
        """(objective, vg_fun) over (u, X, y, mask, bij, fixed)."""
        objective, _ = make_gpr_objective(self.kernel, self.free_names,
                                          self.d)
        vg_fun = make_gpr_vg_fun(self.kernel, self.free_names, self.d) \
            if _kernel_path(self.device) and cuda_gpr.cuda_vg_supported(
                self.kernel, self.d, N) else None
        return objective, vg_fun

    def _fill_chunk_width(self, E, X, Xs, B_pool, do_predict):
        """Chunk width for the post-pool prediction/param-fill loop: the pool
        slot width on the torch path (it holds [B, N, N] temporaries); up to
        1024 experts per call when the fused prediction kernel runs, whose
        workspace is [B, N, 2N + P] f32."""
        from gpsat_tpu_torch.parallel.scheduler import bucket_level
        if do_predict and _kernel_path(self.device) and \
                cuda_gpr.cuda_predict_supported(self.kernel, self.d,
                                                X.shape[1], Xs.shape[1]):
            return min(1024, bucket_level(E))
        return B_pool

    def _pool_optimize(self, init, X, y, mask, slots):
        """Pooled L-BFGS over E same-shape experts (see
        ops/lbfgs.batched_lbfgs_pool). Returns numpy (u [E,P], f, conv,
        iters)."""
        E = X.shape[0]
        fixed = {n: self._tensor(init[n]) for n in self.HYPER_NAMES
                 if n not in self.free_names}
        u0 = self._unconstrained(init, E)
        objective, vg_fun = self._pool_objective(N=X.shape[1])
        mls, rec = linesearch_policy(self.dtype, self.linesearch_kind,
                                     n=_min_valid_size(mask, X.shape[1]))
        res = batched_lbfgs_pool(
            objective, u0,
            (self._tensor(X), self._tensor(y), self._tensor(mask, torch.bool),
             self._batched_bijectors(E), fixed),
            slots=slots, max_iter=self.max_iter, gtol=self.gtol,
            ftol=self.ftol, vg_fun=vg_fun, max_linesearch_steps=mls,
            recovery_steps=rec)
        self._last_pool_iterations = int(res.pool_iterations)
        return (_np(res.x).copy(), _np(res.fun).copy(),
                _np(res.converged).copy(), _np(res.iterations).copy())

    def _constrained_np(self, u):
        """[E, P] unconstrained -> parameter dict of numpy arrays."""
        free = unpack(self._tensor(u), self._spec())
        return {n: _np(self.bijectors[n].forward(free[n]))
                for n in self.free_names}

    def fit_predict_many(self, X, y, mask, Xs=None, optimise=True,
                         predict=True, param_overrides=None, slots=None):
        """Sweep E same-padded-shape experts.

        Runs the L-BFGS *pool* (ops/lbfgs.batched_lbfgs_pool): a `slots`-wide
        batch whose slots refill from the expert queue the moment they
        converge, so the batch never waits for its slowest expert. With
        `optimise=False`, no free parameters, or E <= slots, falls back to
        chunked fit_predict.
        """
        from gpsat_tpu_torch.parallel.scheduler import auto_batch_size
        E, N = X.shape[0], X.shape[1]
        P = 0 if Xs is None else Xs.shape[1]
        B = int(slots or min(E, auto_batch_size(N, P, device=self.device)))
        if not (optimise and self.free_names) or E <= B:
            return self._chunked_fit_predict(X, y, mask, Xs, optimise,
                                             predict, param_overrides,
                                             min(B, E))

        mask_np = _np(mask).astype(bool)
        y_np = _np(y)
        y_var = self._signal_variance(y_np, mask_np)
        init = self._initial_params_batch(E, param_overrides, y_var=y_var,
                                          clamp=True)
        u, fval, conv, iters = self._pool_optimize(init, X, y, mask_np, B)

        # collapse-restart (same policy as fit_predict) on the failed subset
        params = self._constrained_np(u)
        collapsed = self._collapsed(params.get("kernel_variance", np.ones(E)),
                                    fval, y_var, mask_np)
        if collapsed.any():
            ids = np.flatnonzero(collapsed)
            alt = self._initial_params_batch(E, param_overrides, y_var=y_var,
                                             scale=3.0)
            alt_rows = {k: np.asarray(v)[ids] for k, v in alt.items()}
            u2, f2, c2, i2 = self._pool_optimize(
                alt_rows, _np(X)[ids], y_np[ids], mask_np[ids], B)
            take = np.isfinite(f2) & (f2 < fval[ids])
            if take.any():
                rows = ids[take]
                u[rows] = u2[take]
                fval[rows] = f2[take]
                conv[rows] = c2[take]
                iters[rows] = i2[take]

        # predictions + fixed-param fill through the optimise=False program
        do_predict = predict and Xs is not None
        B = self._fill_chunk_width(E, X, Xs, B, do_predict)
        out_params = {n: np.empty((E,) + self.param_shape(n))
                      for n in self.HYPER_NAMES}
        preds_out = {}
        X_t, y_t = self._tensor(X), self._tensor(y)
        Xs_t = None if Xs is None else self._tensor(Xs)
        u_t = self._tensor(u)
        for s in range(0, E, B):
            sl = slice(s, min(s + B, E))
            n = sl.stop - s
            Xs_in = torch.zeros(n, 1, self.d, dtype=self.dtype,
                                device=self.device) if Xs_t is None \
                else Xs_t[sl]
            fixed_chunk = {k: self._tensor(np.asarray(init[k])[sl])
                           for k in self.HYPER_NAMES
                           if k not in self.free_names}
            p_chunk, _, _, _, pr = self._call_program(
                u_t[sl], X_t[sl], y_t[sl], mask_np[sl], Xs_in,
                self._batched_bijectors(n), fixed_chunk, False, do_predict,
                compute_fval=False)
            for k in self.HYPER_NAMES:
                out_params[k][sl] = _np(p_chunk[k]).reshape(
                    (n,) + self.param_shape(k))
            for k, v in pr.items():
                if k not in preds_out:
                    preds_out[k] = np.empty((E,) + tuple(v.shape[1:]))
                preds_out[k][sl] = _np(v)

        return {"params": out_params, "objective": fval, "converged": conv,
                "iterations": iters, "preds": preds_out}
