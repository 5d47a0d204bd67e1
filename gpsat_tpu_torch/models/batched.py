"""Batched engines: fit + predict for a whole padded bucket of local experts
(torch port of gpsat_tpu/models/batched.py): BatchedGPR (exact GPR),
BatchedSGPR (Titsias SGPR), BatchedSVGP (whitened SVGP by Adam), BatchedVFF
and BatchedASVGP (collapsed Fourier and B-spline feature bounds).

A bucket of B experts with identical padded shapes is optimised by one
batched L-BFGS (by Adam for SVGP) and predicted in one masked batched
posterior evaluation. On a CUDA device, GPR and SGPR shapes inside the
kernels' gates go through the fused CUDA kernels (ops/cuda_gpr.py,
ops/cuda_sgpr.py); everything else runs the torch paths of ops/ (autograd
for the gradients), as the JAX engines run XLA outside their Pallas gates.

Inputs may be numpy arrays or tensors; results come back as numpy arrays.

With a `mesh` (parallel/mesh.Mesh), `fit_predict_many` splits the experts
over its shards as the JAX engines shard them over a device mesh: one L-BFGS
pool per shard, the prediction fill of each chunk split across the shards,
and chunks of the chunked path run as one `fit_predict` per shard, each
under its shard's device and stream.
"""

from contextlib import contextmanager
from functools import lru_cache

import numpy as np
import torch

from gpsat_tpu_torch import default_dtype, resolve_device
from gpsat_tpu_torch.models.exact_gpr import (make_gpr_objective,
                                              make_gpr_vg_fun,
                                              move_within_bounds)
from gpsat_tpu_torch.ops import asvgp as asvgp_math
from gpsat_tpu_torch.ops import cuda_gpr, cuda_sgpr
from gpsat_tpu_torch.ops import gpr as gpr_math
from gpsat_tpu_torch.ops import sgpr as sgpr_math
from gpsat_tpu_torch.ops import svgp as svgp_math
from gpsat_tpu_torch.ops import vff as vff_math
from gpsat_tpu_torch.ops.lbfgs import (batched_lbfgs, batched_lbfgs_pool,
                                       linesearch_policy)
from gpsat_tpu_torch.ops.packing import ParamSpec, pack, unpack
from gpsat_tpu_torch.ops.transforms import Sigmoid, Softplus

__all__ = ["BatchedGPR", "BatchedSGPR", "BatchedSVGP", "BatchedVFF",
           "BatchedASVGP", "Adam", "make_sgpr_objective", "make_sgpr_vg_fun",
           "make_vff_objective"]


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
        # (mask of the chunk, first row of this call) while a chunk runs as
        # one fit_predict per shard: the call then takes the chunk's
        # line-search gate and continues the chunk's seeded draws, as one
        # call over the whole chunk would (None: the call is the chunk)
        self._chunk_ctx = None
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

    @property
    def param_names(self):
        """Parameters stored per expert."""
        return list(self.HYPER_NAMES)

    def param_shape(self, name):
        return (self.d,) if name == "lengthscales" else ()

    # -- helpers --------------------------------------------------------------

    def _tensor(self, a, dtype=None):
        """Tensor on the engine's device (engine dtype unless given)."""
        dtype = self.dtype if dtype is None else dtype
        if isinstance(a, torch.Tensor):
            return a.to(self.device, dtype)
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    @contextmanager
    def _on_shard(self, mesh, k):
        """Run the enclosed engine work as shard k of `mesh` (its device and
        scope); without a mesh, on the engine's device as it is."""
        if mesh is None:
            yield
            return
        saved = self.device
        self.device = mesh.devices[k]
        try:
            with mesh.scope(k):
                yield
        finally:
            self.device = saved

    def _seeded_rng(self, seed, consumes):
        """default_rng(seed) advanced past the draws of the chunk's experts
        before this call's (see _chunk_ctx): consumes(n_valid) says whether
        an expert with n_valid points draws a permutation of them."""
        rng = np.random.default_rng(seed)
        if self._chunk_ctx is not None:
            chunk_mask, first = self._chunk_ctx
            for n_valid in chunk_mask[:first].sum(axis=1):
                if consumes(int(n_valid)):
                    rng.permutation(int(n_valid))
        return rng

    def _spec(self):
        return ParamSpec([(n, self.param_shape(n)) for n in self.free_names])

    def _unconstrained(self, init, B):
        """[B, P] unconstrained start from the free parameters of `init`."""
        free = {n: self.bijectors[n].inverse(self._tensor(init[n]))
                for n in self.free_names}
        return pack(free, self._spec(), batch_shape=(B,)).to(self.dtype)

    def _batched_bijectors(self, B):
        """Free-parameter bijectors with [B, *param_shape] tensors in the
        engine dtype (unbatched float64 bounds would otherwise promote the
        whole optimisation to f64; a scalar bound or shift of the
        lengthscales, as the default Softplus has, is broadcast over them)."""
        return {n: self.bijectors[n].map_tensors(
            lambda a, n=n: self._tensor(a).expand(
                (B,) + tuple(self.param_shape(n))))
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
            ls_n=_min_valid_size(mask if self._chunk_ctx is None
                                 else self._chunk_ctx[0], X.shape[1]))

    def _snapshot_state(self):
        """Engine side-state captured before a collapse-restart re-run
        (subclasses carrying per-expert state override)."""
        return None

    def _merge_state(self, state1, use2):
        """Keep run-1 side-state for experts where run 2 was not adopted."""

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
                    param_overrides=None, expert_locs=None):
        """Fit + predict one padded bucket.

        X: [B, N, D] scaled coords; y: [B, N] de-meaned scaled obs;
        mask: [B, N]; Xs: [B, P, D] scaled prediction coords or None;
        expert_locs: [B, D] scaled expert locations or None (read by the
        engines with box domains, VFF and ASVGP; the others ignore it).

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
                state1 = self._snapshot_state()
                alt = self._initial_params_batch(B, param_overrides,
                                                 y_var=y_var, scale=3.0)
                p2, f2, c2, i2, pr2 = self._execute(
                    alt, Xj, yj, mask_np, Xs_in, optimise, do_predict)
                f2 = _np(f2)
                use2 = collapsed & (f2 < fval) & np.isfinite(f2)
                self._merge_state(state1, use2)
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
                             param_overrides, B, expert_locs=None,
                             mesh=None):
        """Sequential fit_predict over B-sized chunks. Under a mesh of n
        shards, a chunk whose width is a multiple of n runs as n fit_predict
        calls, one per contiguous block, each on its shard's device (B is
        then the whole-mesh width); its line-search gate is the chunk's, as
        the JAX engine's sharded chunk is one program. A ragged chunk runs
        unsharded (gpsat_tpu/models/batched.py:359-389)."""
        E = X.shape[0]
        n_sh = 1 if mesh is None else mesh.size
        outs = []
        for s in range(0, E, B):
            e = min(s + B, E)
            sharded = n_sh > 1 and (e - s) % n_sh == 0
            parts = np.array_split(np.arange(s, e), n_sh if sharded else 1)
            try:
                for k, rows in enumerate(parts):
                    a, b = rows[0], rows[-1] + 1
                    ov = None if param_overrides is None else \
                        {n: v[a:b] for n, v in param_overrides.items()}
                    self._chunk_ctx = (_np(mask[s:e]).astype(bool), a - s) \
                        if sharded else None
                    with self._on_shard(mesh if sharded else None, k):
                        outs.append(self.fit_predict(
                            X[a:b], y[a:b], mask[a:b],
                            Xs=None if Xs is None else Xs[a:b],
                            optimise=optimise, predict=predict,
                            param_overrides=ov,
                            expert_locs=None if expert_locs is None
                            else expert_locs[a:b]))
            finally:
                self._chunk_ctx = None

        def cat(key):
            return np.concatenate([o[key] for o in outs], axis=0)
        out = {
            "params": {k: np.concatenate([o["params"][k] for o in outs])
                       for k in outs[0]["params"]},
            "objective": cat("objective"),
            "converged": cat("converged"),
            "iterations": cat("iterations"),
            "preds": {k: np.concatenate([o["preds"][k] for o in outs])
                      for k in outs[0]["preds"]},
        }
        for k in set(outs[0]) - set(out):   # engine extras (inducing_mask, …)
            out[k] = cat(k)
        return out

    # -- pool hooks (engines that support pooled L-BFGS override) -----------

    def _pool_supported(self, optimise):
        """Whether this engine can run the L-BFGS pool."""
        return type(self) is BatchedGPR and optimise and bool(self.free_names)

    def _pool_extra_args(self, X, mask, param_overrides, expert_locs=None):
        """Engine-specific per-expert numpy arrays inserted between mask and
        the bijectors in the objective args (e.g. SGPR inducing points)."""
        return ()

    def _pool_select_chunk(self, ids):
        """Point per-expert engine state at rows `ids` before _call_program
        in the prediction-fill loop (default: stateless)."""

    def _pool_finalize(self, out):
        """Engine-specific output decoration (e.g. objective sign flip)."""
        return out

    def _pool_objective(self, N=None):
        """(objective, vg_fun) over (u, X, y, mask, *extra, bij, fixed)."""
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
        workspace is [B, M, M + P + 2] f32 (N and P padded to 64: the
        factor and its border). Only this class's own prediction runs that
        kernel: a subclass that does not choose its width gets the pool's."""
        from gpsat_tpu_torch.parallel.scheduler import bucket_level
        if do_predict and type(self) is BatchedGPR and \
                _kernel_path(self.device) and \
                cuda_gpr.cuda_predict_supported(self.kernel, self.d,
                                                X.shape[1], Xs.shape[1]):
            return min(1024, bucket_level(E))
        return B_pool

    def _pool_optimize(self, init, X, y, mask, slots, extra=(), mesh=None):
        """Pooled L-BFGS over E same-shape experts (see
        ops/lbfgs.batched_lbfgs_pool; under `mesh`, one pool per shard, the
        line-search policy taken once over the whole level). Returns numpy
        (u [E,P], f, conv, iters)."""
        E = X.shape[0]
        fixed = {n: self._tensor(init[n]) for n in self.HYPER_NAMES
                 if n not in self.free_names}
        u0 = self._unconstrained(init, E)
        objective, vg_fun = self._pool_objective(N=X.shape[1])
        mls, rec = linesearch_policy(self.dtype, self.linesearch_kind,
                                     n=_min_valid_size(mask, X.shape[1]))
        extra = tuple(self._tensor(a, torch.bool if a.dtype == bool else None)
                      for a in map(_np, extra))
        res = batched_lbfgs_pool(
            objective, u0,
            (self._tensor(X), self._tensor(y), self._tensor(mask, torch.bool))
            + extra + (self._batched_bijectors(E), fixed),
            slots=slots, max_iter=self.max_iter, gtol=self.gtol,
            ftol=self.ftol, vg_fun=vg_fun, max_linesearch_steps=mls,
            recovery_steps=rec, mesh=mesh)
        self._last_pool_iterations = int(res.pool_iterations)
        self._last_shard_pool_iterations = res.get(
            "shard_pool_iterations", [self._last_pool_iterations])
        return (_np(res.x).copy(), _np(res.fun).copy(),
                _np(res.converged).copy(), _np(res.iterations).copy())

    def _constrained_np(self, u):
        """[E, P] unconstrained -> parameter dict of numpy arrays."""
        free = unpack(self._tensor(u), self._spec())
        return {n: _np(self.bijectors[n].forward(free[n]))
                for n in self.free_names}

    def fit_predict_many(self, X, y, mask, Xs=None, optimise=True,
                         predict=True, param_overrides=None, slots=None,
                         expert_locs=None, mesh=None):
        """Sweep E same-padded-shape experts (arguments as fit_predict's,
        with E in place of B).

        Engines whose optimiser is L-BFGS (exact GPR; SGPR with fixed
        inducing points) run the *pool* (ops/lbfgs.batched_lbfgs_pool): a
        `slots`-wide batch whose slots refill from the expert queue the
        moment they converge, so the batch never waits for its slowest
        expert. With `optimise=False`, no free parameters, E <= slots or an
        engine without pool support, falls back to chunked fit_predict.

        With `mesh` (parallel/mesh.Mesh, on devices of the engine's type),
        the experts split over its shards (gpsat_tpu/models/batched.py:
        491-620): the pool runs one pool per shard (`slots` is the
        per-shard width; E <= slots * shards falls back to the chunked
        path, whose chunks then span the mesh), and each chunk of the
        prediction fill is split across the shards, every shard's launches
        issued before the chunk's first read back to the host.
        """
        from gpsat_tpu_torch.parallel.scheduler import auto_batch_size
        E, N = X.shape[0], X.shape[1]
        P = 0 if Xs is None else Xs.shape[1]
        n_sh = 1 if mesh is None else mesh.size
        if mesh is not None and any(d.type != self.device.type
                                    for d in mesh.devices):
            raise ValueError(f"mesh {mesh} is not on the engine's device "
                             f"type ({self.device})")
        B = int(slots or min(E, auto_batch_size(N, P, device=self.device)))
        if not self._pool_supported(optimise) or E <= B * n_sh:
            return self._chunked_fit_predict(X, y, mask, Xs, optimise,
                                             predict, param_overrides,
                                             min(B * n_sh, E), expert_locs,
                                             mesh=mesh)

        mask_np = _np(mask).astype(bool)
        y_np = _np(y)
        y_var = self._signal_variance(y_np, mask_np)
        extra = self._pool_extra_args(X, mask_np, param_overrides,
                                      expert_locs)
        init = self._initial_params_batch(E, param_overrides, y_var=y_var,
                                          clamp=True)
        u, fval, conv, iters = self._pool_optimize(init, X, y, mask_np, B,
                                                   extra=extra, mesh=mesh)

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
                alt_rows, _np(X)[ids], y_np[ids], mask_np[ids], B,
                extra=tuple(_np(a)[ids] for a in extra), mesh=mesh)
            take = np.isfinite(f2) & (f2 < fval[ids])
            if take.any():
                rows = ids[take]
                u[rows] = u2[take]
                fval[rows] = f2[take]
                conv[rows] = c2[take]
                iters[rows] = i2[take]

        # predictions + fixed-param fill through the optimise=False program,
        # in chunks (a mesh multiple under a mesh), each split across the
        # shards
        do_predict = predict and Xs is not None
        B = self._fill_chunk_width(E, X, Xs, B, do_predict)
        sharded = n_sh > 1 and B >= n_sh
        if sharded:
            B -= B % n_sh
        out_params = {n: np.empty((E,) + self.param_shape(n))
                      for n in self.HYPER_NAMES}
        preds_out = {}
        X_np, y_np = _np(X), _np(y)
        Xs_np = None if Xs is None else _np(Xs)

        def launch(rows):
            n = len(rows)
            Xs_in = torch.zeros(n, 1, self.d, dtype=self.dtype,
                                device=self.device) if Xs_np is None \
                else self._tensor(Xs_np[rows])
            fixed_chunk = {k: self._tensor(np.asarray(init[k])[rows])
                           for k in self.HYPER_NAMES
                           if k not in self.free_names}
            self._pool_select_chunk(rows)
            p_chunk, _, _, _, pr = self._call_program(
                self._tensor(u[rows]), self._tensor(X_np[rows]),
                self._tensor(y_np[rows]), mask_np[rows], Xs_in,
                self._batched_bijectors(n), fixed_chunk, False, do_predict,
                compute_fval=False)
            return p_chunk, pr

        for s in range(0, E, B):
            parts = [p for p in np.array_split(np.arange(s, min(s + B, E)),
                                               n_sh if sharded else 1)
                     if len(p)]
            shard_mesh = mesh if sharded else None
            pending = []
            for k, rows in enumerate(parts):
                with self._on_shard(shard_mesh, k):
                    pending.append(launch(rows))
            for k, (rows, (p_chunk, pr)) in enumerate(zip(parts, pending)):
                with self._on_shard(shard_mesh, k):
                    n = len(rows)
                    for name in self.HYPER_NAMES:
                        out_params[name][rows] = _np(p_chunk[name]).reshape(
                            (n,) + self.param_shape(name))
                    for key, v in pr.items():
                        if key not in preds_out:
                            preds_out[key] = np.empty((E,) + tuple(v.shape[1:]))
                        preds_out[key][rows] = _np(v)

        return self._pool_finalize(
            {"params": out_params, "objective": fval, "converged": conv,
             "iterations": iters, "preds": preds_out})


# ---------------------------------------------------------------------------
# SGPR (Titsias) batched engine
# ---------------------------------------------------------------------------

def _sgpr_spec(names, d, M=0):
    """Layout of the L-BFGS vector: the free hyperparameters, then (when
    trained) the inducing locations [M, d]."""
    shapes = {"lengthscales": (d,), "kernel_variance": (),
              "likelihood_variance": (), "inducing_points": (M, d)}
    return ParamSpec([(n, shapes[n]) for n in names])


@lru_cache(maxsize=None)
def make_sgpr_objective(kernel, free_names, d, jitter):
    """Batched collapsed negative-ELBO objective over flat unconstrained
    hyper vectors, fixed inducing points:
    objective(u [B,P], X, y, mask, Z, zmask, bijectors, fixed) -> [B].
    lru_cache gives the pooled path one stable callable."""
    spec = _sgpr_spec(free_names, d)

    def objective(u, X, y, mask, Z, zmask, bijectors, fixed):
        params = _constrained(u, spec, free_names, bijectors, fixed)
        return sgpr_math.neg_elbo(params, X, y, mask, Z, zmask,
                                  kernel=kernel, jitter=jitter)

    return objective


@lru_cache(maxsize=None)
def make_sgpr_vg_fun(kernel, free_names, d, jitter, route="hybrid"):
    """Batch-level value_and_grad of the collapsed negative ELBO through the
    fused path (ops/cuda_sgpr.sgpr_vg_batched on `route`), which returns
    raw-parameter gradients. The chain rule through the constraint bijectors
    is torch.autograd.grad of the elementwise u -> params map (cf.
    models/exact_gpr.make_gpr_vg_fun)."""
    spec = _sgpr_spec(free_names, d)

    def vg_fun(u, X, y, mask, Z, zmask, bijectors, fixed):
        with torch.enable_grad():
            ur = u.detach().requires_grad_(True)
            params = _constrained(ur, spec, free_names, bijectors, fixed)
        val, gparams = cuda_sgpr.sgpr_vg_batched(
            {n: v.detach() for n, v in params.items()}, X, y,
            mask.to(X.dtype), Z, zmask.to(X.dtype), kernel, jitter,
            route=route)
        outs = [params[n] for n in free_names]
        cots = [gparams[n].to(params[n].dtype).reshape(params[n].shape)
                for n in free_names]
        (gu,) = torch.autograd.grad(outs, ur, cots)
        return val.to(u.dtype), gu

    return vg_fun


def _sgpr_fit_predict(u0, X, y, mask, Z, zmask, Xs, bijectors, fixed, *,
                      kernel, free_names, d, optimise, do_predict, max_iter,
                      gtol, ftol, jitter, train_z=False, compute_fval=True,
                      route="hybrid"):
    """Batched SGPR: L-BFGS on the collapsed negative ELBO + posterior.

    train_z packs the inducing locations [M, d] into the L-BFGS vector
    (identity transform; padded rows have zero gradient and never move) —
    the reference's train_inducing_points=True
    (GPSat/models/gpflow_models.py:864-877)."""
    B, M = Z.shape[0], Z.shape[1]
    opt_names = tuple(free_names) + (("inducing_points",) if train_z else ())
    spec = _sgpr_spec(opt_names, d, M)
    fused = _kernel_path(X.device) and cuda_sgpr.sgpr_vg_supported(
        kernel, d, X.shape[1], M)

    def objective(u, X, y, mask, Z, zmask, bijectors, fixed):
        params = _constrained(u, spec, free_names, bijectors, fixed)
        Zu = unpack(u, spec)["inducing_points"] if train_z else Z
        return sgpr_math.neg_elbo(params, X, y, mask, Zu, zmask,
                                  kernel=kernel, jitter=jitter)

    args = (X, y, mask, Z, zmask, bijectors, fixed)
    if optimise and opt_names:
        # fixed-Z runs evaluate every L-BFGS trial through the fused SGPR
        # value+gradient path when supported (trainable Z packs Z into u,
        # which the fused path does not cover)
        vg_fun = make_sgpr_vg_fun(kernel, free_names, d, jitter, route) \
            if (fused and not train_z and cuda_sgpr.sgpr_vg_supported(
                kernel, d, X.shape[1], M, route)) else None
        mls, rec = linesearch_policy(X.dtype, "sgpr")
        res = batched_lbfgs(objective, u0, args, max_iter, gtol, ftol, 10,
                            mls, rec, vg_fun=vg_fun)
        u, fval, conv, iters = res.x, res.fun, res.converged, res.iterations
    else:
        u = u0
        if compute_fval:
            with torch.no_grad():
                fval = objective(u0, *args)
        else:
            fval = torch.zeros(B, dtype=X.dtype, device=X.device)
        conv = torch.zeros(B, dtype=torch.bool, device=X.device)
        iters = torch.zeros(B, dtype=torch.int32, device=X.device)

    with torch.no_grad():
        params = _constrained(u, spec, free_names, bijectors, fixed)
        if train_z:
            Z = unpack(u, spec)["inducing_points"]
            Z = torch.where(zmask[:, :, None], Z, torch.zeros_like(Z))
        if not do_predict:
            preds = {}
        elif fused:
            # hybrid batched posterior (cholinv kernel + torch matmuls, with
            # the escalating-jitter recovery for near-singular Kuu)
            preds = cuda_sgpr.sgpr_predict_batched(
                params, X, y, mask.to(X.dtype), Z, zmask.to(X.dtype), Xs,
                kernel, jitter)
            preds = {k: v.to(X.dtype) for k, v in preds.items()}
        else:
            preds = sgpr_math.predict(params, X, y, mask, Z, zmask, Xs,
                                      kernel=kernel, jitter=jitter)
    return params, fval, conv, iters, preds, Z


class BatchedSGPR(BatchedGPR):
    """Batched Titsias SGPR engine (reference model: GPflowSGPRModel,
    GPSat/models/gpflow_models.py:666; the production model of the IS2 runs).

    Inducing points are a seeded random subset of each expert's (scaled)
    inputs, fixed during optimisation (the reference default,
    gpflow_models.py:864 train_inducing_points=False). The optimiser
    minimises the *negative* ELBO; the reported objective is the ELBO.

    `route` picks how the fused value_and_grad runs on the card: "hybrid"
    (torch matmuls around the cholinv kernel, the default), "stream" (the
    two N-streamed kernels) or "mega" (one launch entry for the whole
    evaluation; N at most 4096, autograd beyond); see ops/cuda_sgpr.py.
    """

    model_name = "SGPRModel"
    linesearch_kind = "sgpr"

    def __init__(self, coords_dim, num_inducing_points=500, inducing_seed=42,
                 jitter=None, route="hybrid", **kwargs):
        optim_kwargs = dict(kwargs.pop("optim_kwargs", None) or {})
        if not hasattr(self, "train_inducing_points"):
            self.train_inducing_points = bool(optim_kwargs.pop(
                "train_inducing_points", False))
        else:
            optim_kwargs.pop("train_inducing_points", None)
        if route not in cuda_sgpr.ROUTES:
            raise ValueError(f"route must be one of {cuda_sgpr.ROUTES}")
        jitter = sgpr_math.DEFAULT_JITTER if jitter is None else jitter
        super().__init__(coords_dim, jitter=jitter, optim_kwargs=optim_kwargs,
                         **kwargs)
        self.num_inducing = int(num_inducing_points)
        self.inducing_seed = int(inducing_seed)
        self.jitter = float(jitter)
        self.route = route
        self._Z = None
        self._zmask = None

    @property
    def param_names(self):
        """Hyperparameters and per-expert inducing locations. A reload of the
        inducing points (load_params) falls back to the seeded re-selection
        for missing/NaN rows; stored padded rows are zeros, which is only
        exact when the reload uses the same local data (the smoothed
        re-prediction case)."""
        return list(self.HYPER_NAMES) + ["inducing_points"]

    def param_shape(self, name):
        if name == "inducing_points":
            return (self.num_inducing, self.d)
        return super().param_shape(name)

    def _build_inducing(self, X, mask):
        """Seeded random-subset inducing points per expert, padded + masked
        (numpy, the same draws as the JAX engine)."""
        X = _np(X)
        mask = _np(mask)
        B, N, d = X.shape
        M = min(self.num_inducing, N)
        Z = np.zeros((B, M, d))
        zmask = np.zeros((B, M), dtype=bool)
        rng = self._seeded_rng(self.inducing_seed, lambda n: n > M)
        for b in range(B):
            valid = np.where(mask[b])[0]
            if len(valid) == 0:
                continue
            if len(valid) <= M:
                sel = valid
            else:
                sel = valid[rng.permutation(len(valid))[:M]]
            Z[b, :len(sel)] = X[b, sel]
            zmask[b, :len(sel)] = True
        return Z, zmask

    def fit_predict(self, X, y, mask, Xs=None, optimise=True, predict=True,
                    param_overrides=None, expert_locs=None):
        self._Z, self._zmask = self._build_inducing(X, mask)
        self._apply_inducing_override(param_overrides)
        out = super().fit_predict(X, y, mask, Xs=Xs, optimise=optimise,
                                  predict=predict,
                                  param_overrides=param_overrides)
        # report the ELBO (positive) and expose the inducing points
        out["objective"] = -out["objective"]
        Z_out = getattr(self, "_Z_final", self._Z)
        out["params"]["inducing_points"] = Z_out * (
            self._zmask[:, :, None])  # zero padded rows for storage
        out["inducing_mask"] = self._zmask
        return out

    def _apply_inducing_override(self, param_overrides):
        """Adopt loaded inducing locations row-wise: a loaded row replaces the
        seeded one when it is finite and the slot is valid (zmask). NaN rows
        (expert missing from the table, or stored M < configured M) keep the
        seeded selection."""
        if not (param_overrides and
                param_overrides.get("inducing_points") is not None):
            return
        ov = np.asarray(param_overrides["inducing_points"], dtype=float)
        ov = ov.reshape(len(self._Z), -1, self.d)
        k = min(self._Z.shape[1], ov.shape[1])
        adopt = (~np.isnan(ov[:, :k]).any(axis=2)) & self._zmask[:, :k]
        self._Z[:, :k][adopt] = ov[:, :k][adopt]

    def _snapshot_state(self):
        return {"Z": getattr(self, "_Z_final", None)}

    def _merge_state(self, state1, use2):
        if state1 and state1.get("Z") is not None:
            keep1 = ~use2
            self._Z_final[keep1] = state1["Z"][keep1]

    def _call_program(self, u0, X, y, mask, Xs_in, bij_b, fixed, optimise,
                      do_predict, compute_fval=True):
        train_z = bool(self.train_inducing_points) and bool(optimise)
        Z = self._tensor(self._Z)
        if train_z:
            u0 = torch.cat([u0, Z.reshape(u0.shape[0], -1)], dim=1)
        params, fval, conv, iters, preds, Z = _sgpr_fit_predict(
            u0, X, y, self._tensor(mask, torch.bool), Z,
            self._tensor(self._zmask, torch.bool), Xs_in, bij_b, fixed,
            kernel=self.kernel, free_names=self.free_names, d=self.d,
            optimise=bool(optimise), do_predict=bool(do_predict),
            max_iter=self.max_iter, gtol=self.gtol, ftol=self.ftol,
            jitter=self.jitter, train_z=train_z,
            compute_fval=bool(compute_fval), route=self.route)
        # fixed Z comes back as it went in: its engine-dtype values on the
        # host, with no read from the device (a read here would wait for
        # the prediction, and serialise the shards of a mesh's fill)
        self._Z_final = _np(Z).copy() if train_z else \
            self._Z.astype(_np(torch.empty(0, dtype=self.dtype)).dtype)
        return params, fval, conv, iters, preds

    # -- pooled execution hooks ----------------------------------------------

    def _pool_supported(self, optimise):
        """Pooled L-BFGS with *fixed* inducing points (the reference
        default); trainable-Z runs fall back to chunked one-shot batches."""
        return (type(self) is BatchedSGPR and optimise
                and bool(self.free_names) and not self.train_inducing_points)

    def _pool_objective(self, N=None):
        vg_fun = make_sgpr_vg_fun(self.kernel, self.free_names, self.d,
                                  self.jitter, self.route) \
            if _kernel_path(self.device) and cuda_sgpr.sgpr_vg_supported(
                self.kernel, self.d, N, self.num_inducing, self.route) \
            else None
        return make_sgpr_objective(self.kernel, self.free_names, self.d,
                                   self.jitter), vg_fun

    def _pool_extra_args(self, X, mask, param_overrides, expert_locs=None):
        self._Z, self._zmask = self._build_inducing(X, mask)
        self._apply_inducing_override(param_overrides)
        self._Z_all, self._zmask_all = self._Z, self._zmask
        return (self._Z, self._zmask)

    def _pool_select_chunk(self, ids):
        self._Z = self._Z_all[ids]
        self._zmask = self._zmask_all[ids]

    def _pool_finalize(self, out):
        self._Z, self._zmask = self._Z_all, self._zmask_all
        out["objective"] = -out["objective"]   # stored objective = ELBO
        out["params"]["inducing_points"] = \
            self._Z_all * self._zmask_all[:, :, None]
        out["inducing_mask"] = self._zmask_all
        return out

    def _fill_chunk_width(self, E, X, Xs, B_pool, do_predict):
        """Hybrid SGPR prediction has no [B, N, N] temporaries: its dominant
        buffers are [B, M_pad, N] (Kuf/At and their r2 builds), so the fill
        runs far wider chunks than the pool (fewer cholinv launches). Width =
        canonical bucket of E capped by a budget of 2**27 elements per live
        buffer, floored to a multiple of 16, never below the pool width."""
        if not (do_predict and type(self) is BatchedSGPR
                and _kernel_path(self.device)
                and cuda_sgpr.sgpr_vg_supported(self.kernel, self.d,
                                                X.shape[1],
                                                self.num_inducing)):
            return B_pool
        from gpsat_tpu_torch.parallel.scheduler import bucket_level
        M_pad = -(-self.num_inducing // 128) * 128
        cap = max(16, 2**27 // max(M_pad * X.shape[1], 1))
        B = min(bucket_level(E), cap - cap % 16)
        return max(B, B_pool)


# ---------------------------------------------------------------------------
# SVGP batched engine: Adam with per-expert plateau early stop
# ---------------------------------------------------------------------------

class Adam:
    """optax.adam(lr) written out on a dict of tensors: b1 0.9, b2 0.999,
    eps 1e-8 outside the square root, bias-corrected moments (optax's
    scale_by_adam, then scale(-lr) and apply_updates), so that f64
    trajectories equal the JAX package's to rounding; torch.optim.Adam
    rounds the same formula differently. `step` updates the keys of `grads`
    only: a leaf that is never given a gradient keeps its value, as optax
    keeps a leaf whose gradients are all zero."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, lr):
        self.lr = float(lr)
        self.count = 0
        self.mu, self.nu = {}, {}

    def step(self, theta, grads):
        """theta with grads' leaves moved by one Adam step (theta is not
        modified)."""
        b1, b2 = self.B1, self.B2
        self.count += 1
        bc1 = 1.0 - b1 ** self.count
        bc2 = 1.0 - b2 ** self.count
        out = dict(theta)
        for k, g in grads.items():
            mu = self.mu.get(k, torch.zeros_like(g))
            nu = self.nu.get(k, torch.zeros_like(g))
            self.mu[k] = mu = (1 - b1) * g + b1 * mu
            self.nu[k] = nu = (1 - b2) * (g * g) + b2 * nu
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.EPS)
            out[k] = theta[k] + (-self.lr) * upd
        return out


def _epoch_order(mask, seed, epoch):
    """[B, N] order of each expert's rows for one epoch of the reshuffled
    minibatch: a fresh uniform draw from a torch.Generator seeded from
    (seed, epoch), the valid rows first. (The JAX engine draws from
    jax.random; the port keeps its invariants, not its bits.)"""
    words = np.random.SeedSequence([int(seed), int(epoch)])
    gen = torch.Generator().manual_seed(int(words.generate_state(1)[0]))
    r = torch.rand(tuple(mask.shape), generator=gen, dtype=torch.float64)
    r = torch.where(mask.cpu(), r, torch.full_like(r, 2.0))
    return torch.argsort(r, dim=1).to(mask.device)


def _epoch_window(order, mask, start, mb):
    """[B, mb] rows of the window at `start`: positions wrap within each
    expert's valid count, so every window is all-valid, ragged experts
    too."""
    nv = torch.clamp_min(torch.sum(mask, dim=1), 1)
    pos = (start + torch.arange(mb, device=mask.device))[None, :] \
        % nv[:, None]
    return torch.take_along_dim(order, pos, dim=1)


def _svgp_fit_predict(u0, qm0, qs0, X, y, mask, Z, zmask, Xs, perm, bijectors,
                      fixed, *, kernel, free_names, d, optimise, do_predict,
                      max_iter, lr, check_every, persistence, jitter,
                      early_stop, natural_gradients, gamma, train_z, train_qm,
                      train_qs, mb, reshuffle=False, mb_seed=0):
    """Batched SVGP: Adam on (hypers[, Z], q_mu, q_sqrt) with per-expert early
    stopping, then posterior prediction (the JAX package's
    _svgp_fit_predict, gpsat_tpu/models/batched.py:984-1153).

    Reference semantics (GPSat/models/gpflow_models.py:1117-1245):
    - natural_gradients: a NaturalGradient step (step length `gamma`) on
      (q_mu, q_sqrt) precedes each Adam step, and the variational pair
      leaves the Adam variables.
    - train_z: the inducing locations join the Adam variables.
    - mb > 0: per-iteration minibatch of mb points per expert, a window over
      `perm` (a per-expert shuffled index cycle), data term scaled by
      N_valid / mb; with `reshuffle`, a fresh order of each expert's valid
      points every epoch instead.

    The loop runs on the host. An expert's `done` changes only on a check
    iteration (it % check_every == 0), so `done` is read back once per check
    and the loop stops at the iteration the JAX while_loop stops at. A
    finished expert gets zero gradients but keeps its Adam state, so its
    momentum still moves it, as in the reference.
    """
    B, N = X.shape[:2]
    dev, dt = X.device, X.dtype
    spec = ParamSpec([(n, {"lengthscales": (d,)}.get(n, ()))
                      for n in free_names])
    n_valid = torch.sum(mask.to(dt), dim=1)                    # [B]

    def constrained(u):
        return _constrained(u, spec, free_names, bijectors, fixed)

    epoch_order = [None, None]        # (epoch, its order) when reshuffling

    def batch_at(it):
        """Minibatch view for iteration `it` (the full data when mb == 0)."""
        if mb == 0:
            return X, y, mask, 1.0
        start = (it * mb) % N
        if reshuffle:
            # per-epoch reshuffle (the reference's tf.data pipeline
            # reshuffles every pass, gpflow_models.py:1073)
            epoch = (it * mb) // N
            if epoch_order[0] != epoch:
                epoch_order[:] = [epoch, _epoch_order(mask, mb_seed, epoch)]
            idx = _epoch_window(epoch_order[1], mask, start, mb)
        else:
            idx = perm[:, start:start + mb]                    # [B, mb]
        Xb = torch.take_along_dim(X, idx[:, :, None], dim=1)
        yb = torch.take_along_dim(y, idx, dim=1)
        mbk = torch.take_along_dim(mask, idx, dim=1)
        mb_valid = torch.clamp_min(torch.sum(mbk.to(dt), dim=1), 1.0)
        return Xb, yb, mbk, n_valid / mb_valid

    def per_elbo(theta, Xb, yb, mbk, scale):
        return svgp_math.elbo(constrained(theta["u"]), theta["qm"],
                              theta["qs"], Xb, yb, mbk, theta["z"], zmask,
                              kernel=kernel, jitter=jitter, scale=scale)

    def finite(qm, qs):
        return torch.isfinite(qm).all(dim=-1) & \
            torch.isfinite(qs).all(dim=-1).all(dim=-1)

    theta = {"u": u0, "qm": qm0, "qs": qs0, "z": Z}
    # leaves Adam moves; the others have zero gradients, on which optax's
    # Adam leaves them where they are
    trained = ["u"] + (["z"] if train_z else []) + (
        [] if natural_gradients else
        (["qm"] if train_qm else []) + (["qs"] if train_qs else []))
    it = 0
    conv = torch.zeros(B, dtype=torch.bool, device=dev)
    if optimise:
        opt = Adam(lr)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        best = torch.full((B,), -torch.inf, dtype=dt, device=dev)
        cnt = torch.zeros(B, dtype=torch.int32, device=dev)
        vals = torch.zeros(B, dtype=dt, device=dev)
        while it < max_iter:
            Xb, yb, mbk, scale = batch_at(it)
            if natural_gradients:
                # natgrad on (q_mu, q_sqrt) precedes the Adam step
                # (reference: gpflow_models.py:1204-1214 optimisation_step)
                with torch.no_grad():
                    qm_n, qs_n = svgp_math.natgrad_step(
                        constrained(theta["u"]), theta["qm"], theta["qs"], Xb,
                        yb, mbk, theta["z"], zmask, gamma, kernel=kernel,
                        jitter=jitter, scale=scale)
                    keep = done | ~finite(qm_n, qs_n)
                    if train_qm:
                        theta["qm"] = torch.where(keep[:, None], theta["qm"],
                                                  qm_n)
                    if train_qs:
                        theta["qs"] = torch.where(keep[:, None, None],
                                                  theta["qs"], qs_n)
            with torch.enable_grad():
                leaves = {k: theta[k].detach().requires_grad_(True)
                          for k in trained}
                vals = per_elbo({**theta, **leaves}, Xb, yb, mbk, scale)
                grads = torch.autograd.grad(-vals.sum(), list(leaves.values()),
                                            allow_unused=True)
            vals = vals.detach()
            g = {k: torch.zeros_like(leaves[k]) if gk is None else gk
                 for k, gk in zip(leaves, grads)}
            with torch.no_grad():
                if "z" in g:    # padded inducing rows never move
                    g["z"] = g["z"] * zmask[:, :, None]
                # finished experts: zero gradients (their Adam state still
                # moves them)
                g = {k: torch.where(done.reshape((B,) + (1,) * (v.ndim - 1)),
                                    torch.zeros_like(v), v)
                     for k, v in g.items()}
                theta = opt.step(theta, g)
                check = it % check_every == 0
                it += 1
                if check:
                    nan_fail = ~torch.isfinite(vals)
                    improved = vals > best
                    best = torch.where(improved & ~done, vals, best)
                    cnt = torch.where(improved | done, torch.zeros_like(cnt),
                                      cnt + check_every)
                    stop = nan_fail | ((cnt >= persistence) & early_stop)
                    done = done | stop
                    if bool(done.all()):
                        break
        conv = done & torch.isfinite(vals)

        if natural_gradients and (train_qm or train_qs):
            # full-batch polish: one gamma=1 conjugate step lands q(u) on its
            # optimum at the final hyperparameters (a strict ELBO
            # improvement; removes minibatch noise from the stored state)
            with torch.no_grad():
                qm_n, qs_n = svgp_math.natgrad_step(
                    constrained(theta["u"]), theta["qm"], theta["qs"], X, y,
                    mask, theta["z"], zmask, 1.0, kernel=kernel,
                    jitter=jitter)
                bad = ~finite(qm_n, qs_n)
                if train_qm:
                    theta["qm"] = torch.where(bad[:, None], theta["qm"], qm_n)
                if train_qs:
                    theta["qs"] = torch.where(bad[:, None, None], theta["qs"],
                                              qs_n)
    iters = torch.full((B,), it, dtype=torch.int32, device=dev)

    with torch.no_grad():
        # final objective on the full data (the stored objective_value is
        # the full ELBO even when optimisation was minibatched)
        vals = per_elbo(theta, X, y, mask, 1.0)
        params = constrained(theta["u"])
        preds = svgp_math.predict(params, theta["qm"], theta["qs"],
                                  theta["z"], zmask, Xs, kernel=kernel,
                                  jitter=jitter) if do_predict else {}
    # the *negative* ELBO, so that the base class's restart logic (lower is
    # better) holds; BatchedSVGP flips the sign on output
    return (params, -vals, conv, iters, preds, theta["qm"], theta["qs"],
            theta["z"])


class BatchedSVGP(BatchedSGPR):
    """Batched SVGP engine (reference: GPflowSVGPModel,
    GPSat/models/gpflow_models.py:904). Full-batch Adam by default (the
    reference's default when minibatch_size is None), with the reference's
    natural_gradients, train_inducing_points and minibatch options. No pool:
    fit_predict_many runs chunks of fit_predict, as the JAX engine does."""

    model_name = "SVGPModel"

    def __init__(self, coords_dim, num_inducing_points=500,
                 learning_rate=1e-2, minibatch_size=None, **kwargs):
        optim_kwargs = dict(kwargs.pop("optim_kwargs", None) or {})
        self.learning_rate = float(optim_kwargs.pop("learning_rate",
                                                    learning_rate))
        self.check_every = int(optim_kwargs.pop("check_every", 10))
        self.persistence = int(optim_kwargs.pop("persistence", 100))
        self.early_stop = bool(optim_kwargs.pop("early_stop", True))
        self.natural_gradients = bool(optim_kwargs.pop("natural_gradients",
                                                       False))
        self.gamma = float(optim_kwargs.pop("gamma", 0.1))
        self.train_inducing_points = bool(optim_kwargs.pop(
            "train_inducing_points", False))
        mb = optim_kwargs.pop("minibatch_size", minibatch_size)
        self.minibatch_size = None if mb is None else int(mb)
        self.minibatch_seed = int(optim_kwargs.pop("minibatch_seed", 0))
        # per-epoch seeded reshuffle (the reference's tf.data
        # shuffle(N).repeat(), gpflow_models.py:1073); the default is one
        # fixed shuffled cycle
        self.minibatch_reshuffle = bool(
            optim_kwargs.pop("minibatch_reshuffle", False))
        optim_kwargs.setdefault("max_iter", 2000)
        fixed = set(optim_kwargs.get("fixed_params") or [])
        self.train_qm = "inducing_mean" not in fixed
        self.train_qs = "inducing_chol" not in fixed
        if "inducing_points" in fixed:
            self.train_inducing_points = False
        super().__init__(coords_dim, num_inducing_points=num_inducing_points,
                         optim_kwargs=optim_kwargs, **kwargs)

    @property
    def param_names(self):
        """Stored and re-loadable per expert: the hyperparameters, inducing
        locations, q_mu and q_sqrt (the reference's load_params reads every
        param table, GPSat/local_experts.py:609-689). A reload falls back to
        the seeded selection, a zero mean and an identity factor where an
        entry is NaN or missing."""
        return list(self.HYPER_NAMES) + ["inducing_points", "inducing_mean",
                                         "inducing_chol"]

    def param_shape(self, name):
        if name == "inducing_mean":
            return (self.num_inducing,)
        if name == "inducing_chol":
            return (self.num_inducing, self.num_inducing)
        return super().param_shape(name)

    def _build_perm(self, mask, mb):
        """Per-expert shuffled index cycle for minibatch windows: the valid
        indices shuffled, then tiled to N + mb (numpy, the JAX engine's
        draws)."""
        mask = _np(mask)
        B, N = mask.shape
        rng = self._seeded_rng(self.minibatch_seed, lambda n: n > 0)
        perm = np.zeros((B, N + mb), dtype=np.int64)
        for b in range(B):
            valid = np.where(mask[b])[0]
            if len(valid) == 0:
                continue
            perm[b] = np.resize(rng.permutation(valid), N + mb)
        return perm

    def fit_predict(self, X, y, mask, Xs=None, optimise=True, predict=True,
                    param_overrides=None, expert_locs=None):
        B, N = _np(mask).shape
        self._Z, self._zmask = self._build_inducing(X, mask)
        M = self._zmask.shape[1]
        self._qm0 = np.zeros((B, M))
        self._qs0 = np.broadcast_to(np.eye(M), (B, M, M)).copy()
        if param_overrides:
            self._apply_inducing_override(param_overrides)
            if param_overrides.get("inducing_mean") is not None:
                ov = np.asarray(param_overrides["inducing_mean"],
                                dtype=float).reshape(B, -1)[:, :M]
                use = ~np.isnan(ov)
                self._qm0[:, :ov.shape[1]][use] = ov[use]
            if param_overrides.get("inducing_chol") is not None:
                ov = np.asarray(param_overrides["inducing_chol"], dtype=float)
                Mo = int(round(np.sqrt(ov.reshape(B, -1).shape[1])))
                ov = ov.reshape(B, Mo, Mo)
                k = min(M, Mo)
                # an expert's chol loads whole or not at all (a partial
                # triangle is not a valid factor)
                ok = ~np.isnan(ov[:, :k, :k]).any(axis=(1, 2))
                self._qs0[np.ix_(ok, range(k), range(k))] = ov[ok, :k, :k]
        self._mb = 0
        self._perm = np.zeros((B, 1), dtype=np.int64)
        if self.minibatch_size is not None and self.minibatch_size < N:
            self._mb = int(self.minibatch_size)
            self._perm = self._build_perm(mask, self._mb)
        out = BatchedGPR.fit_predict(self, X, y, mask, Xs=Xs,
                                     optimise=optimise, predict=predict,
                                     param_overrides=param_overrides)
        out["objective"] = -out["objective"]   # report the ELBO
        out["params"]["inducing_points"] = \
            self._Z_final * self._zmask[:, :, None]
        out["params"]["inducing_mean"] = self._qm_final
        out["params"]["inducing_chol"] = self._qs_final
        out["inducing_mask"] = self._zmask
        return out

    def _snapshot_state(self):
        return {"Z": getattr(self, "_Z_final", None),
                "qm": getattr(self, "_qm_final", None),
                "qs": getattr(self, "_qs_final", None)}

    def _merge_state(self, state1, use2):
        keep1 = ~use2
        if state1 and state1.get("Z") is not None:
            self._Z_final[keep1] = state1["Z"][keep1]
        if state1 and state1.get("qm") is not None:
            self._qm_final[keep1] = state1["qm"][keep1]
            self._qs_final[keep1] = state1["qs"][keep1]

    def _call_program(self, u0, X, y, mask, Xs_in, bij_b, fixed, optimise,
                      do_predict, compute_fval=True):
        (params, fval, conv, iters, preds, qm, qs, z) = _svgp_fit_predict(
            u0, self._tensor(self._qm0), self._tensor(self._qs0), X, y,
            self._tensor(mask, torch.bool), self._tensor(self._Z),
            self._tensor(self._zmask, torch.bool), Xs_in,
            self._tensor(self._perm, torch.int64), bij_b, fixed,
            kernel=self.kernel, free_names=self.free_names, d=self.d,
            optimise=bool(optimise), do_predict=bool(do_predict),
            max_iter=self.max_iter, lr=self.learning_rate,
            check_every=self.check_every, persistence=self.persistence,
            jitter=self.jitter, early_stop=self.early_stop,
            natural_gradients=self.natural_gradients, gamma=self.gamma,
            train_z=self.train_inducing_points, train_qm=self.train_qm,
            train_qs=self.train_qs, mb=self._mb,
            reshuffle=self.minibatch_reshuffle, mb_seed=self.minibatch_seed)
        self._qm_final = _np(qm).copy()
        self._qs_final = _np(qs).copy()
        self._Z_final = _np(z).copy()
        return params, fval, conv, iters, preds


# ---------------------------------------------------------------------------
# VFF and ASVGP batched engines: per-expert box domains, Kronecker features
# ---------------------------------------------------------------------------

def _vff_spec(free_names, d):
    shapes = {"lengthscales": (d,), "kernel_variance": (d,),
              "likelihood_variance": ()}
    return ParamSpec([(n, shapes[n]) for n in free_names])


@lru_cache(maxsize=None)
def make_vff_objective(mathmod, kernel, free_names, d, ms, jitter):
    """Batched collapsed negative-ELBO objective over flat unconstrained hyper
    vectors for the VFF or ASVGP feature math `mathmod`:
    objective(u [B,P], X, y, mask, a, b, bijectors, fixed) -> [B]. Its
    gradient comes by autograd. lru_cache gives the pooled path one stable
    callable."""
    spec = _vff_spec(free_names, d)

    def objective(u, X, y, mask, a, b, bijectors, fixed):
        params = _constrained(u, spec, free_names, bijectors, fixed)
        return mathmod.neg_elbo(params, X, y, mask, a, b, ms, kernel=kernel,
                                jitter=jitter)

    return objective


def _vff_fit_predict(u0, X, y, mask, a, b, Xs, bijectors, fixed, *, mathmod,
                     kernel, free_names, d, ms, optimise, do_predict,
                     max_iter, gtol, ftol, jitter, compute_fval=True):
    """Batched VFF/ASVGP: L-BFGS on the collapsed negative ELBO (autograd) +
    posterior, for a [B, N(, P)] bucket with per-expert boxes a, b [B, d]."""
    objective = make_vff_objective(mathmod, kernel, free_names, d, ms,
                                   jitter)
    args = (X, y, mask, a, b, bijectors, fixed)
    B = u0.shape[0]
    if optimise and free_names:
        mls, rec = linesearch_policy(X.dtype, "vff")
        res = batched_lbfgs(objective, u0, args, max_iter, gtol, ftol, 10,
                            mls, rec)
        u, fval, conv, iters = res.x, res.fun, res.converged, res.iterations
    else:
        u = u0
        if compute_fval:
            with torch.no_grad():
                fval = objective(u0, *args)
        else:
            fval = torch.zeros(B, dtype=X.dtype, device=X.device)
        conv = torch.zeros(B, dtype=torch.bool, device=X.device)
        iters = torch.zeros(B, dtype=torch.int32, device=X.device)

    with torch.no_grad():
        params = _constrained(u, _vff_spec(free_names, d), free_names,
                              bijectors, fixed)
        preds = mathmod.predict(params, X, y, mask, Xs, a, b, ms,
                                kernel=kernel, jitter=jitter) \
            if do_predict else {}
    return params, fval, conv, iters, preds


class BatchedVFF(BatchedGPR):
    """Batched VFF engine (reference model: GPflowVFFModel,
    GPSat/models/vff_model.py:48). Needs per-expert box domains: the
    orchestrator passes `expert_locs` ([B, D] scaled expert coordinates) to
    fit_predict; domains are expert_loc +- domain_size (scaled), expanded to
    cover each expert's data (the data centroid stands in for the location
    when none is given)."""

    model_name = "VFFModel"
    # the GPR size-gated recovery drop was validated only on the exact NLML
    # objective; VFF/ASVGP keep the (8, 4) chain at every size (see
    # ops/lbfgs.linesearch_policy)
    linesearch_kind = "vff"
    _math = vff_math     # subclasses swap the feature math

    def __init__(self, coords_dim, kernel="Matern32",
                 num_inducing_features=None, domain_size=None,
                 jitter=None, **kwargs):
        assert num_inducing_features is not None, \
            "num_inducing_features must be specified for VFF"
        jitter = self._math.DEFAULT_JITTER if jitter is None else jitter
        super().__init__(coords_dim, kernel=kernel, jitter=jitter, **kwargs)
        self.jitter = float(jitter)
        d = self.d
        if isinstance(num_inducing_features, int):
            num_inducing_features = [num_inducing_features] * d
        self.ms = tuple(int(m) for m in num_inducing_features)
        if isinstance(domain_size, (int, float)) or domain_size is None:
            domain_size = [domain_size] * d
        self.domain_size = domain_size
        # per-dim kernel variance: widen the scalar init
        kv0 = float(np.atleast_1d(self.init_values["kernel_variance"])[0])
        self.init_values["kernel_variance"] = np.full(d, kv0 ** (1.0 / d))

    def param_shape(self, name):
        if name == "kernel_variance":
            return (self.d,)
        return super().param_shape(name)

    def _initial_params_batch(self, B, overrides=None, y_var=None, scale=1.0,
                              clamp=True):
        out = super()._initial_params_batch(B, overrides, y_var=None,
                                            clamp=clamp)
        # per-dim variance init: the product equals the expert's signal
        # variance
        if y_var is not None and not self.user_set.get("kernel_variance",
                                                       True):
            kv = np.maximum(y_var, 1e-10)[:, None] ** (1.0 / self.d) * scale
            if overrides is None or overrides.get("kernel_variance") is None:
                out["kernel_variance"] = np.broadcast_to(
                    kv, (B, self.d)).copy()
        if y_var is not None and not self.user_set.get("likelihood_variance",
                                                       True):
            if overrides is None or \
                    overrides.get("likelihood_variance") is None:
                out["likelihood_variance"] = \
                    np.maximum(0.1 * y_var, 1e-10) * scale
        return out

    def _build_domains(self, X, mask, expert_locs):
        """Per-expert boxes (a, b) [B, d] in scaled units (numpy)."""
        X = _np(X)
        mask = _np(mask).astype(bool)
        B, N, d = X.shape
        big = 1e30
        data_min = np.where(mask[:, :, None], X, big).min(axis=1)
        data_max = np.where(mask[:, :, None], X, -big).max(axis=1)
        # empty experts: a harmless placeholder domain
        empty = ~mask.any(axis=1)
        data_min[empty] = 0.0
        data_max[empty] = 1.0
        if expert_locs is not None:
            el = np.asarray(expert_locs)
        else:
            cnt = np.maximum(mask.sum(axis=1), 1)[:, None]
            el = (X * mask[:, :, None]).sum(axis=1) / cnt
        a = np.empty((B, d))
        b = np.empty((B, d))
        cs = np.broadcast_to(self.coords_scale.reshape(-1), (d,))
        for i in range(d):
            ds = self.domain_size[i]
            if ds is None:
                a[:, i] = data_min[:, i] - 1e-8
                b[:, i] = data_max[:, i] + 1e-8
            else:
                a[:, i] = np.minimum(el[:, i] - ds / cs[i],
                                     data_min[:, i] - 1e-8)
                b[:, i] = np.maximum(el[:, i] + ds / cs[i],
                                     data_max[:, i] + 1e-8)
        return a, b

    def fit_predict(self, X, y, mask, Xs=None, optimise=True, predict=True,
                    param_overrides=None, expert_locs=None):
        self._a, self._b = self._build_domains(X, mask, expert_locs)
        out = BatchedGPR.fit_predict(self, X, y, mask, Xs=Xs,
                                     optimise=optimise, predict=predict,
                                     param_overrides=param_overrides)
        out["objective"] = -out["objective"]   # report the ELBO
        return out

    def _call_program(self, u0, X, y, mask, Xs_in, bij_b, fixed, optimise,
                      do_predict, compute_fval=True):
        return _vff_fit_predict(
            u0, X, y, self._tensor(mask, torch.bool), self._tensor(self._a),
            self._tensor(self._b), Xs_in, bij_b, fixed, mathmod=self._math,
            kernel=self.kernel, free_names=self.free_names, d=self.d,
            ms=self.ms, optimise=bool(optimise), do_predict=bool(do_predict),
            max_iter=self.max_iter, gtol=self.gtol, ftol=self.ftol,
            jitter=self.jitter, compute_fval=bool(compute_fval))

    # -- pooled execution hooks ----------------------------------------------

    def _pool_supported(self, optimise):
        """VFF/ASVGP optimise with L-BFGS over hyperparameters only, so the
        pool applies directly; the per-expert box domains ride along as
        extra args, like SGPR's inducing points."""
        return optimise and bool(self.free_names)

    def _pool_objective(self, N=None):
        return make_vff_objective(self._math, self.kernel, self.free_names,
                                  self.d, self.ms, self.jitter), None

    def _pool_extra_args(self, X, mask, param_overrides, expert_locs=None):
        self._a, self._b = self._build_domains(X, mask, expert_locs)
        self._a_all, self._b_all = self._a, self._b
        return (self._a, self._b)

    def _pool_select_chunk(self, ids):
        self._a = self._a_all[ids]
        self._b = self._b_all[ids]

    def _pool_finalize(self, out):
        self._a, self._b = self._a_all, self._b_all
        out["objective"] = -out["objective"]   # stored objective = ELBO
        return out


class BatchedASVGP(BatchedVFF):
    """Batched ASVGP engine: B-spline inducing features on per-expert box
    domains (reference: GPflowASVGPModel, GPSat/models/asvgp_model.py:18;
    feature math in ops/asvgp.py). The collapsed bound and domain logic of
    BatchedVFF; `num_inducing_features` counts spline basis functions per
    dimension, which must exceed the spline degree of the kernel."""

    model_name = "ASVGPModel"
    _math = asvgp_math

    def __init__(self, coords_dim, kernel="Matern32", **kwargs):
        super().__init__(coords_dim, kernel=kernel, **kwargs)
        degree = asvgp_math.spline_degree(kernel)
        for m in self.ms:
            assert m > degree, (
                f"ASVGP needs num_inducing_features > spline degree "
                f"({degree}) for kernel {kernel}; got {m}")
