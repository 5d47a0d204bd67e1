"""Batched L-BFGS with per-expert convergence (torch port of
gpsat_tpu/ops/lbfgs.py).

The loop lives at the *batch* level and only the objective is batched: one
value-and-gradient trial per slot per iteration, a [B] done-mask, and a
scalar ring pointer into the [m, B, P] curvature history. JAX's
``while_loop``s become host loops here: each iteration reads one boolean
(are any slots still running?) back from the device, and everything else
stays on the device.

The pooled variant (`batched_lbfgs_pool`) runs a `slots`-wide batch whose
slots refill from the expert queue the moment they converge, so the batch
never waits for its slowest expert; under a device mesh, one such pool per
shard. `batched_lbfgs(engine="optax")` is the JAX package's per-expert
cross-check engine.
"""

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["batched_lbfgs", "batched_lbfgs_pool", "LBFGSResult",
           "linesearch_policy"]


def linesearch_policy(dtype, kind="gpr", n=None):
    """(max_linesearch_steps, recovery_steps) by working precision, objective
    family, and (for exact GPR) a LOWER BOUND on the per-expert VALID data
    size. The measurements behind each branch are recorded at
    gpsat_tpu/ops/lbfgs.py:linesearch_policy.

    - f32 "gpr": the steepest-descent recovery chain (4 halvings) only when
      some expert has fewer than 256 valid points.
    - f32 "vff": always (8, 4).  f32 "sgpr": no recovery halvings.
    - f64: the conservative scipy-style policy (12, 12) for every family.
    """
    if dtype == torch.float32:
        if kind == "sgpr":
            return 8, 0
        if kind == "gpr" and n is not None and n >= 256:
            return 8, 0
        return 8, 4
    return 12, 12


class LBFGSResult(dict):
    """dict with attribute access: x, fun, converged, iterations."""

    def __getattr__(self, item):
        try:
            return self[item]
        except KeyError as e:  # pragma: no cover
            raise AttributeError(item) from e


class Carry(NamedTuple):
    """The per-iteration L-BFGS state (the JAX carry tuple, in order).

    `it` is the global iteration (ring-pointer base), a host int; `iters`
    counts per-slot ACCEPTED steps, so slots refilled mid-run get correct
    per-expert budgets."""
    it: int
    x: torch.Tensor         # [B, P]
    f: torch.Tensor         # [B]
    g: torch.Tensor         # [B, P]
    S: torch.Tensor         # [m, B, P]
    Y: torch.Tensor         # [m, B, P]
    rho: torch.Tensor       # [m, B]
    gamma: torch.Tensor     # [B]
    done: torch.Tensor      # [B] bool
    iters: torch.Tensor     # [B] int32
    fail_cnt: torch.Tensor  # [B] int32
    t: torch.Tensor         # [B] backtracking scale
    backed: torch.Tensor    # [B] bool


def _make_step(batched_value_and_grad, B, P, dtype, max_iter,
               gtol, ftol, memory_size, max_linesearch_steps,
               recovery_steps=None):
    """Build the per-iteration body over the L-BFGS `Carry`.

    ONE trial point per iteration, evaluated with value_and_grad; `t` [B]
    carries each slot's Armijo backtracking scale ACROSS iterations (halved
    on rejection, reset on acceptance), so rejections never stall the rest
    of the batch. Rejected iterations retain the slot's previous ring-history
    entry, so the preconditioner is not diluted."""
    m = memory_size

    def two_loop(g, S, Y, rho, gamma, ptr):
        """Search direction -H g for all experts; ptr is the scalar ring
        position of the next write."""
        q = g
        alpha = [None] * m
        for i in range(m):
            idx = (ptr - 1 - i) % m
            a_i = rho[idx] * torch.sum(S[idx] * q, dim=-1)   # rho=0 -> no-op
            q = q - a_i[:, None] * S[idx]
            alpha[idx] = a_i
        r = gamma[:, None] * q
        for i in range(m):
            idx = (ptr - m + i) % m
            b_i = rho[idx] * torch.sum(Y[idx] * r, dim=-1)
            coef = torch.where(rho[idx] > 0, alpha[idx] - b_i,
                               torch.zeros_like(b_i))
            r = r + coef[:, None] * S[idx]
        return -r

    t_min = 0.5 ** max_linesearch_steps
    # the post-reset steepest-descent recovery chain may be shorter (f32
    # policy: 4 halvings) — see linesearch_policy
    t_min_rec = 0.5 ** (recovery_steps if recovery_steps is not None
                        else max_linesearch_steps)
    # unit-trial cap for steepest-descent-like directions only (no usable
    # curvature history, or a non-descent two-loop result)
    _DMAX = 2.0
    f32 = dtype == torch.float32

    def body(c):
        it, x, f, g, S, Y, rho, gamma, done, iters, fail_cnt, t, backed = c
        d = two_loop(g, S, Y, rho, gamma, it)
        gd = torch.sum(g * d, dim=-1)
        bad_dir = ~torch.isfinite(gd) | (gd >= 0)
        d = torch.where(bad_dir[:, None], -g, d)
        gd = torch.where(bad_dir, -torch.sum(g * g, dim=-1), gd)
        no_hist = ~torch.any(rho > 0, dim=0)
        dinf = torch.amax(torch.abs(d), dim=-1)
        t_base = torch.where(
            bad_dir | no_hist,
            torch.clamp_max(_DMAX / torch.clamp_min(dinf, 1e-30), 1.0),
            torch.ones_like(dinf))
        step = t * t_base

        x_try = x + step[:, None] * d
        f_try, g_try = batched_value_and_grad(x_try)
        accept = (~done) & torch.isfinite(f_try) & (
            f_try <= f + 1e-4 * step * gd)

        s = x_try - x
        yv = g_try - g
        sy = torch.sum(s * yv, dim=-1)
        s_norm = torch.linalg.vector_norm(s, dim=-1)
        y_norm = torch.linalg.vector_norm(yv, dim=-1)
        keep = accept & (sy > 1e-10 * s_norm * y_norm)

        # rejected slots RETAIN their previous entry at the ring position
        ptr = it % m
        S = S.clone()
        Y = Y.clone()
        rho = rho.clone()
        S[ptr] = torch.where(keep[:, None], s, S[ptr])
        Y[ptr] = torch.where(keep[:, None], yv, Y[ptr])
        rho[ptr] = torch.where(
            keep, 1.0 / torch.where(sy == 0, torch.ones_like(sy), sy),
            rho[ptr])
        yy = torch.sum(yv * yv, dim=-1)
        gamma = torch.where(keep & (yy > 0), sy / torch.clamp_min(yy, 1e-300),
                            gamma)

        grad_small = accept & (torch.amax(torch.abs(g_try), dim=-1) < gtol)
        # f-stagnation on any accepted step from a finite point (pool-
        # refilled slots carry f=inf through their bootstrap pass, so
        # isfinite(f) keeps them alive)
        f_change = accept & torch.isfinite(f) & (
            torch.abs(f - f_try) <= ftol * torch.clamp_min(
                torch.maximum(torch.abs(f), torch.abs(f_try)), 1.0))
        # a slot fails when its backtracking scale is exhausted without an
        # acceptable point: the first failure resets its curvature history
        # (steepest-descent recovery with a possibly shorter chain), a second
        # exhausted chain ends the slot
        fail = (~accept) & (~done) & (
            t <= torch.where(fail_cnt >= 1, torch.full_like(t, t_min_rec),
                             torch.full_like(t, t_min)))
        fail_cnt = torch.where(
            fail, fail_cnt + 1,
            torch.where(accept, torch.zeros_like(fail_cnt), fail_cnt))
        hard_fail = fail & (fail_cnt >= 2)
        reset = fail & (~hard_fail) & (fail_cnt == 1)
        rho = torch.where(reset[None, :], torch.zeros_like(rho), rho)
        gamma = torch.where(reset, torch.ones_like(gamma), gamma)
        iters = iters + accept.to(iters.dtype)
        hit_cap = iters >= max_iter
        newly_done = (~done) & (grad_small | f_change | hard_fail | hit_cap)

        x = torch.where(accept[:, None], x_try, x)
        f = torch.where(accept, f_try, f)
        g = torch.where(accept[:, None], g_try, g)
        # warm-started trial scale, precision-dependent (see
        # gpsat_tpu/ops/lbfgs.py:237-265): f32 regrows 2x only after a
        # CLEAN (first-trial) accept; f64 regrows 4x on every accept
        one = torch.ones_like(t)
        if f32:
            t_new = torch.where(
                accept & ~backed, torch.minimum(one, t * 2.0),
                torch.where(accept, t, torch.where(fail, one, t * 0.5)))
        else:
            t_new = torch.where(accept, torch.minimum(one, t * 4.0),
                                torch.where(fail, one, t * 0.5))
        t = torch.where(done, t, t_new)
        backed = torch.where(done, backed, ~(accept | fail))
        done = done | newly_done
        return Carry(it + 1, x, f, g, S, Y, rho, gamma, done, iters,
                     fail_cnt, t, backed)

    return body


def _init_carry(batched_value_and_grad, x0, gtol, memory_size):
    B, P = x0.shape
    m = memory_size
    dtype, dev = x0.dtype, x0.device
    f0, g0 = batched_value_and_grad(x0)
    done0 = ~torch.isfinite(f0) | (torch.amax(torch.abs(g0), dim=-1) < gtol)
    zi = torch.zeros(B, dtype=torch.int32, device=dev)
    return Carry(0, x0, f0, g0,
                 torch.zeros(m, B, P, dtype=dtype, device=dev),
                 torch.zeros(m, B, P, dtype=dtype, device=dev),
                 torch.zeros(m, B, dtype=dtype, device=dev),
                 torch.ones(B, dtype=dtype, device=dev),
                 done0, zi, zi.clone(),
                 torch.ones(B, dtype=dtype, device=dev),
                 torch.zeros(B, dtype=torch.bool, device=dev))


def _batch_lbfgs_loop(batched_value_and_grad, x0, max_iter,
                      gtol, ftol, memory_size, max_linesearch_steps,
                      recovery_steps=None):
    """Core batch-level loop. x0: [B, P]. Returns (x, f, converged, iters)."""
    B, P = x0.shape
    body = _make_step(batched_value_and_grad, B, P, x0.dtype,
                      max_iter, gtol, ftol, memory_size, max_linesearch_steps,
                      recovery_steps)
    # a slot needs at most (max_linesearch_steps + 1) trials per accepted
    # step and hard-fail / hit_cap bound every slot: a pure backstop
    it_cap = max_iter * (max_linesearch_steps + 2)
    c = _init_carry(batched_value_and_grad, x0, gtol, memory_size)
    while c.it < it_cap and bool(torch.any(~c.done)):
        c = body(c)
    # slots that only exhausted their per-slot budget are not converged
    return c.x, c.f, c.done & (c.iters < max_iter), c.iters


def _value_and_grad_of(fun, args):
    """Batched value_and_grad of `fun(x [B,P], *args) -> [B]` by autograd
    (experts are independent, so the gradient of the sum is per expert)."""
    def vg(x):
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            f = fun(xr, *args)
            (g,) = torch.autograd.grad(f.sum(), xr)
        return f.detach(), g
    return vg


def batched_lbfgs(fun, x0, args=(), max_iter=500, gtol=1e-6, ftol=1e-11,
                  memory_size=10, max_linesearch_steps=12,
                  recovery_steps=None, vg_fun=None, engine="custom"):
    """Minimise the batched objective `fun(x [B, P], *args) -> [B]`.

    `args` leaves have a leading batch dim B. `vg_fun(x, *args) -> (f, g)`,
    if given, replaces autograd through `fun` (the fused CUDA kernel path).
    `engine="optax"` runs the numerical cross-check instead (_optax_engine:
    one minimisation per expert, autograd through `fun`, vg_fun unused).
    Returns LBFGSResult with x [B, P], fun [B], converged [B], iterations [B].
    """
    args = tuple(args)
    if engine == "optax":
        return _optax_engine(fun, x0, args, max_iter, gtol, ftol,
                             memory_size, max_linesearch_steps)
    if engine != "custom":
        raise ValueError(f"engine must be 'custom' or 'optax', not {engine!r}")
    vg = (lambda x: vg_fun(x, *args)) if vg_fun is not None \
        else _value_and_grad_of(fun, args)
    x, f, conv, iters = _batch_lbfgs_loop(vg, x0, max_iter, gtol, ftol,
                                          memory_size, max_linesearch_steps,
                                          recovery_steps)
    return LBFGSResult(x=x, fun=f, converged=conv, iterations=iters)


# ---------------------------------------------------------------------------
# the cross-check engine: one minimisation per expert (the JAX package's
# optax engine, gpsat_tpu/ops/lbfgs.py:600-650, which vmaps optax.lbfgs with
# its zoom line search). Here torch.optim.LBFGS with its strong-Wolfe line
# search takes the steps, so trajectories differ from optax's while the
# contract is the same: the best finite point seen, and converged = done
# (gradient or f-change test, or a non-finite step) within max_iter, each
# step's line search at most max_linesearch_steps evaluations. On no sweep
# path.
# ---------------------------------------------------------------------------

def _optax_single(f, x0, max_iter, gtol, ftol, memory_size,
                  max_linesearch_steps):
    """Minimise the scalar f(x [P]) from x0: (best x, best f, converged,
    iterations). One LBFGS.step is one iteration: its first evaluation is
    at the point the step starts from, the rest are its line search. The
    optimiser's own stopping tests are off: the contract's decide."""
    x = x0.detach().clone().requires_grad_(True)
    opt = torch.optim.LBFGS([x], lr=1.0, max_iter=1,
                            max_eval=max_linesearch_steps + 1,
                            history_size=memory_size, tolerance_grad=0.0,
                            tolerance_change=0.0,
                            line_search_fn="strong_wolfe")
    first = []

    def closure():
        opt.zero_grad()
        val = f(x)
        val.backward()
        if not first:      # (value, grad) at the point the step starts from
            first.append((float(val.detach()), x.grad.detach().clone()))
        if not torch.isfinite(val):
            # the line search takes a non-finite trial as infinitely bad
            # (it cannot bracket a NaN) and backs off from it
            x.grad.zero_()
            return torch.full_like(val.detach(), torch.inf)
        return val

    with torch.no_grad():
        f0 = float(f(x0))
    best_f = f0 if np.isfinite(f0) else np.inf
    best_x = x0.detach().clone()
    prev_f, done, it = np.inf, False, 0
    with torch.enable_grad():
        while it < max_iter and not done:
            x_at = x.detach().clone()
            first.clear()
            opt.step(closure)
            value, grad = first[0]
            finite = np.isfinite(value) and bool(torch.isfinite(x).all())
            if finite and value < best_f:
                best_f, best_x = value, x_at
            grad_small = float(grad.abs().max()) < gtol
            f_change = abs(prev_f - value) <= ftol * max(abs(prev_f),
                                                         abs(value), 1.0)
            done = grad_small or (it > 0 and f_change) or not finite
            it += 1
            prev_f = value
    with torch.no_grad():
        f_final = float(f(x))
    if np.isfinite(f_final) and bool(torch.isfinite(x).all()) \
            and f_final < best_f:
        best_f, best_x = f_final, x.detach().clone()
    return best_x, best_f, done and it <= max_iter, it


def _optax_engine(fun, x0, args, max_iter, gtol, ftol, memory_size,
                  max_linesearch_steps):
    B = x0.shape[0]
    xs, fs, cs, its = [], [], [], []
    for i in range(B):
        args_i = _tree_map(lambda a: a[i:i + 1]
                           if a.ndim >= 1 and a.shape[0] == B else a, args)

        def f(x, args_i=args_i):
            return fun(x[None], *args_i)[0]
        x, fv, c, it = _optax_single(f, x0[i], max_iter, gtol, ftol,
                                     memory_size, max_linesearch_steps)
        xs.append(x)
        fs.append(fv)
        cs.append(c)
        its.append(it)
    dev = x0.device
    return LBFGSResult(
        x=torch.stack(xs), fun=torch.tensor(fs, dtype=x0.dtype, device=dev),
        converged=torch.tensor(cs, dtype=torch.bool, device=dev),
        iterations=torch.tensor(its, dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# pooled execution: a fixed-width slot batch whose slots are refilled from
# the expert queue the moment they converge. All E experts' data stays on the
# device; the active slots' args are gathered by expert index for each
# objective call, and results scatter into [E]-shaped outputs. The harvest /
# refill step runs every iteration: with no finished slot it changes nothing.
# A shared ring pointer is safe across refills because refilled slots get
# zeroed history (rho=0 rows are no-ops in the two-loop recursion).
# ---------------------------------------------------------------------------


def _tree_map(fn, tree):
    """Apply `fn` to every tensor (and numpy array) of a
    tuple/list/dict/Bijector tree."""
    from gpsat_tpu_torch.ops.transforms import Bijector
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, Bijector):
        return tree.map_tensors(fn)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


class _Pool:
    """The state of one slot pool over E experts, advanced one iteration at
    a time by `step`; `running()` is a device bool (is any slot live?).
    A one-device run is one pool; a mesh runs one pool per shard (see
    _pool_mesh)."""

    def __init__(self, fun, x0_all, args_all, slots, max_iter, gtol, ftol,
                 memory_size, max_linesearch_steps, vg_fun=None,
                 recovery_steps=None):
        E, P = x0_all.shape
        B = slots
        dtype, dev = x0_all.dtype, x0_all.device
        self.E, self.B, self.P, self.dtype = E, B, P, dtype
        self.x0_all, self.args_all = x0_all, args_all
        self.fun, self.vg_fun = fun, vg_fun
        self.opts = (max_iter, gtol, ftol, memory_size, max_linesearch_steps,
                     recovery_steps)
        ids0 = torch.arange(B, device=dev)
        self.carry = _init_carry(self._vg_at(ids0), x0_all[:B], gtol,
                                 memory_size)
        self.slot_expert = ids0
        self.next_expert = torch.tensor(B, device=dev)
        self.live = torch.ones(B, dtype=torch.bool, device=dev)
        # [E + 1] outputs: row E takes the writes of slots that harvest
        # nothing
        self.ox = torch.cat([x0_all, x0_all[:1]], dim=0)
        self.of = torch.zeros(E + 1, dtype=dtype, device=dev)
        self.oc = torch.zeros(E + 1, dtype=torch.bool, device=dev)
        self.oi = torch.zeros(E + 1, dtype=torch.int32, device=dev)
        self.inf = torch.tensor(torch.inf, dtype=dtype, device=dev)

    def _vg_at(self, ids):
        """value_and_grad over the per-slot arg rows `ids`."""
        E = self.E
        args = _tree_map(lambda a: a.index_select(0, ids)
                         if a.ndim >= 1 and a.shape[0] == E else a,
                         self.args_all)
        if self.vg_fun is not None:
            return lambda x: self.vg_fun(x, *args)
        return _value_and_grad_of(self.fun, args)

    def running(self):
        return torch.any(self.live)

    def step(self):
        """One iteration of every slot, then harvest and refill."""
        E, B = self.E, self.B
        max_iter, gtol, ftol, m, mls, rec = self.opts
        step = _make_step(self._vg_at(self.slot_expert), B, self.P,
                          self.dtype, max_iter, gtol, ftol, m, mls, rec)
        c = step(self.carry)
        slot_expert = self.slot_expert
        harvest = c.done & self.live
        idx = torch.where(harvest, slot_expert,
                          torch.full_like(slot_expert, E))
        self.ox[idx] = c.x
        self.of[idx] = c.f
        self.oc[idx] = c.iters < max_iter
        self.oi[idx] = c.iters
        # refill freed slots from the queue (prefix-sum assignment)
        order = torch.cumsum(harvest.to(torch.int64), dim=0)
        new_id = self.next_expert + order - 1
        ok = harvest & (new_id < E)
        self.slot_expert = torch.where(ok, new_id, slot_expert)
        self.live = (self.live & ~harvest) | ok
        self.next_expert = torch.clamp_max(self.next_expert + order[-1], E)
        okc = ok[:, None]
        x = torch.where(okc, self.x0_all.index_select(
            0, torch.clamp(new_id, 0, E - 1)), c.x)
        # a refilled slot bootstraps through the NEXT regular iteration:
        # with f=inf, g=0 the direction is 0, the unchanged point is accepted
        # on its first trial and that trial's value_and_grad delivers its
        # (f0, g0); iters=-1 keeps the bootstrap pass off its budget
        self.carry = Carry(
            c.it, x,
            torch.where(ok, self.inf, c.f),
            torch.where(okc, torch.zeros_like(c.g), c.g),
            torch.where(ok[None, :, None], torch.zeros_like(c.S), c.S),
            torch.where(ok[None, :, None], torch.zeros_like(c.Y), c.Y),
            torch.where(ok[None, :], torch.zeros_like(c.rho), c.rho),
            torch.where(ok, torch.ones_like(c.gamma), c.gamma),
            torch.where(ok, torch.zeros_like(c.done), c.done),
            torch.where(ok, torch.full_like(c.iters, -1), c.iters),
            torch.where(ok, torch.zeros_like(c.fail_cnt), c.fail_cnt),
            torch.where(ok, torch.ones_like(c.t), c.t),
            torch.where(ok, torch.zeros_like(c.backed), c.backed))

    def result(self):
        """(x, f, converged, iterations) [E], and the pool iterations (=
        trials per slot, a diagnostic)."""
        E = self.E
        return (self.ox[:E], self.of[:E], self.oc[:E], self.oi[:E],
                self.carry.it)


def _pool_mesh(pool_args, x0_all, args_all, slots, mesh):
    """One independent pool per shard of `mesh`, with no collective: E is
    padded to a mesh multiple by repeating the leading experts, each shard
    drains its contiguous block through a pool of width min(slots, E_pad /
    n), and the repeats are dropped. A slot's trajectory depends only on its
    own expert, so every expert ends as in the one-device pool
    (gpsat_tpu/ops/lbfgs.py:402-440).

    One host thread drives the shards in lockstep: each turn issues one
    iteration of every live shard under its scope (device and stream), and
    only then reads each shard's any(live). Returns ((x, f, converged,
    iterations) on x0_all's device, [pool iterations of each shard])."""
    from gpsat_tpu_torch.parallel.mesh import pad_to_multiple, shard_experts
    E = x0_all.shape[0]
    n = mesh.size
    pad = pad_to_multiple(E, n) - E
    if pad:
        def rep(a):
            return torch.cat([a, a[:pad]], dim=0) \
                if a.ndim >= 1 and a.shape[0] == E else a
        x0_all, args_all = rep(x0_all), _tree_map(rep, args_all)
    B = int(min(slots, (E + pad) // n))
    x0_sh = shard_experts(x0_all, mesh)
    args_sh = shard_experts(args_all, mesh)
    pools = []
    for k in range(n):
        with mesh.scope(k):
            pools.append(_Pool(pool_args[0], x0_sh[k], args_sh[k], B,
                               *pool_args[1:]))
    live = list(range(n))
    while live:
        flags = []
        for k in live:
            with mesh.scope(k):
                pools[k].step()
                flags.append(pools[k].running())
        still = []
        for k, flag in zip(live, flags):
            with mesh.scope(k):
                if bool(flag):
                    still.append(k)
        live = still
    parts, nits = [], []
    for k in range(n):
        with mesh.scope(k):
            *out, nit = pools[k].result()
            parts.append([t.cpu() for t in out])
            nits.append(int(nit))
    out = tuple(torch.cat(ts, dim=0)[:E].to(x0_all.device)
                for ts in zip(*parts))
    return out, nits


def batched_lbfgs_pool(fun, x0_all, args_all, slots, max_iter=500, gtol=1e-6,
                       ftol=1e-11, memory_size=10, max_linesearch_steps=12,
                       vg_fun=None, recovery_steps=None, mesh=None):
    """Minimise `fun` for E independent problems through a `slots`-wide pool
    (see the block comment above).

    x0_all: [E, P]; args_all: tree with [E, ...] leaves. Returns LBFGSResult
    with [E]-shaped fields and `pool_iterations`. Per-expert results equal
    the one-shot batched loop's.

    With `mesh` (parallel/mesh.Mesh) of more than one shard, the experts
    split over the shards and each shard drains its own pool (`slots` is the
    per-shard width; see _pool_mesh): per-expert results equal the
    one-device pool's, `pool_iterations` is the largest of the shards' and
    `shard_pool_iterations` lists them.
    """
    E, P = x0_all.shape
    args_all = tuple(args_all)
    pool_args = (fun, max_iter, gtol, ftol, memory_size,
                 max_linesearch_steps, vg_fun, recovery_steps)
    if mesh is not None and mesh.size > 1:
        (x, f, conv, iters), nits = _pool_mesh(pool_args, x0_all, args_all,
                                               slots, mesh)
        return LBFGSResult(x=x, fun=f, converged=conv, iterations=iters,
                           pool_iterations=max(nits),
                           shard_pool_iterations=nits)
    pool = _Pool(fun, x0_all, args_all, int(min(slots, E)), *pool_args[1:])
    while bool(pool.running()):
        pool.step()
    x, f, conv, iters, nit = pool.result()
    return LBFGSResult(x=x, fun=f, converged=conv, iterations=iters,
                       pool_iterations=nit)
