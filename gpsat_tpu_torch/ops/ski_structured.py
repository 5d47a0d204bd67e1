"""Structured SKI / KISS-GP operators: BTTB grid-kernel MVMs + CG (torch port
of gpsat_tpu/ops/ski_structured.py).

K ~= W Kg W^T + s2 I is never materialised (reference: GPyTorchKISSGPModel
wrapping gpytorch's GridInterpolationKernel,
GPSat/models/gpytorch_models.py:321):

- Kg MVM in O(G log G): a stationary kernel on a regular d-dim grid is
  block-Toeplitz with Toeplitz blocks (BTTB); it is embedded in a d-dim
  circulant (the kernel on the [2 G]*d signed-offset box) and multiplied in
  Fourier space with torch.fft, exact for every stationary kernel;
- sparse W / W^T from the 4-point Keys stencil per dim: one gather and one
  scatter-add (`index_add_`) over the 4^d stencil points of every row, the
  same weights as the dense ops/ski.interp_matrix;
- batched-RHS conjugate gradients on the implicit K, with a host check of
  convergence every `CG_CHECK_EVERY` iterations;
- GPyTorch-style training: fixed-iteration Adam on the stochastic gradient
  dNLML/dtheta = 0.5(-alpha^T dK alpha + E_z[(K^-1 z)^T dK z]) with
  Hutchinson probes and CG solves; autograd differentiates a detached
  quadratic form through the (small) embedded-kernel build, so dK never
  exists either.

Random draws: the probes are an argument; by default they are drawn from a
torch.Generator seeded with `seed` on the data's device (the JAX package
draws them from jax.random, whose bits the port does not reproduce).
"""

import numpy as np
import torch

from gpsat_tpu_torch.ops.kernels import kernel_fn

__all__ = ["grid_kernel_embed_fft", "bttb_matvec", "SparseInterp",
           "ski_matvec", "cg_solve", "draw_probes", "ski_fit_adam",
           "ski_predict_cg", "CG_CHECK_EVERY"]

# iterations between two host reads of CG's per-RHS convergence flags: a
# converged RHS is frozen (alpha = beta = 0), so iterations past the last
# convergence change nothing and the result equals a check every iteration
CG_CHECK_EVERY = 8


def grid_kernel_embed_fft(params, steps, grid_size, kernel, d):
    """rFFT of the circulant embedding of the grid kernel.

    The kernel is evaluated at every signed offset (o_1 dx_1, ..., o_d dx_d)
    with o_j in circulant order [0..G-1, G(pad), -(G-1)..-1] (length 2G per
    dim), the d-dim analogue of symmetric-Toeplitz embedding. Returns the
    real FFT over the [2G]*d box, in the dtype of the kernel variance.
    """
    k = kernel_fn(kernel)
    G = int(grid_size)
    kv = params["kernel_variance"]
    dt, dev = kv.dtype, kv.device
    steps = torch.as_tensor(steps, dtype=dt, device=dev)
    off = torch.cat([torch.arange(G + 1, dtype=dt, device=dev),
                     -torch.arange(G - 1, 0, -1, dtype=dt, device=dev)])
    coords = []
    for j in range(d):
        shape = [1] * d
        shape[j] = 2 * G
        coords.append((off * steps[j]).reshape(shape))
    mesh = torch.stack(torch.broadcast_tensors(*coords),
                       dim=-1).reshape(-1, d)
    zero = torch.zeros((1, d), dtype=dt, device=dev)
    ls = torch.as_tensor(params["lengthscales"], dtype=dt,
                         device=dev).reshape(-1)
    if ls.shape[0] == 1 and d > 1:
        ls = ls.expand(d)
    vals = k(mesh, zero, ls, kv).reshape((2 * G,) * d)
    return torch.fft.rfftn(vals)


def bttb_matvec(femb, v, grid_size, d):
    """Kg v via the embedded-circulant FFT. v: [..., G^d]. rfftn zero-pads
    each grid axis to 2G (s=), and halves the last one, as femb does."""
    G = int(grid_size)
    lead = v.shape[:-1]
    V = v.reshape(*lead, *((G,) * d))
    axes = tuple(range(len(lead), len(lead) + d))
    F = torch.fft.rfftn(V, s=(2 * G,) * d, dim=axes)
    out = torch.fft.irfftn(F * femb, s=(2 * G,) * d, dim=axes)
    sl = (Ellipsis,) + tuple(slice(0, G) for _ in range(d))
    return out[sl].reshape(*lead, G ** d).to(v.dtype)


def _keys_np(u):
    """Keys (1981) cubic, a = -1/2 (numpy; mirrors ops/ski._keys_cubic)."""
    au = np.abs(u)
    return np.where(au <= 1.0, 1.5 * au**3 - 2.5 * au**2 + 1.0,
                    np.where(au < 2.0,
                             -0.5 * au**3 + 2.5 * au**2 - 4.0 * au + 2.0,
                             0.0))


class SparseInterp:
    """Sparse 4^d-point cubic interpolation operator: stencil indices and
    weights computed on the host in numpy (f64), then held on `device` as
    int64 indices and `dtype` weights, both [4^d, N].

    Same weights as the dense ops/ski.interp_matrix rows (partition of
    unity; exact at grid nodes): per dim j the stencil reads grid nodes
    base_j..base_j+3 with Keys-cubic weights.
    """

    def __init__(self, X, starts, steps, grid_size, dtype=torch.float64,
                 device="cpu"):
        X = np.asarray(X, dtype=float)
        starts = np.asarray(starts, dtype=float)
        steps = np.asarray(steps, dtype=float)
        N, d = X.shape
        self.d = d
        self.G = int(grid_size)
        self.Gtot = self.G ** d
        w_all, base_all = [], []
        for j in range(d):
            t = (X[:, j] - starts[j]) / steps[j]
            i0 = np.clip(np.floor(t).astype(int), 1, self.G - 3)
            u = t - i0
            base = i0 - 1
            w = np.stack([_keys_np(u + 1.0), _keys_np(u),
                          _keys_np(u - 1.0), _keys_np(u - 2.0)], axis=1)
            w_all.append(w)
            base_all.append(base)
        combos = np.stack(np.meshgrid(*([np.arange(4)] * d),
                                      indexing="ij"), axis=-1).reshape(-1, d)
        flat, cw = [], []
        for cmb in combos:
            idx = np.zeros(N, dtype=np.int64)
            w = np.ones(N)
            for j in range(d):
                idx = idx * self.G + (base_all[j] + cmb[j])
                w = w * w_all[j][:, cmb[j]]
            flat.append(idx)
            cw.append(w)
        self.flat_idx = torch.as_tensor(np.stack(flat), device=device)
        self.cw = torch.as_tensor(np.stack(cw), dtype=dtype, device=device)

    def apply(self, u):
        """W u: u [..., Gtot] -> [..., N], one gather of all stencil
        points."""
        return torch.sum(self.cw * u[..., self.flat_idx], dim=-2)

    def apply_t(self, r):
        """W^T r: r [..., N] -> [..., Gtot], one scatter-add (index_add_ on
        the last axis; on the card it adds with atomics, so f32 sums differ
        between runs at rounding level)."""
        src = (self.cw * r[..., None, :]).reshape(*r.shape[:-1], -1)
        out = torch.zeros(*r.shape[:-1], self.Gtot, dtype=src.dtype,
                          device=src.device)
        return out.index_add_(-1, self.flat_idx.reshape(-1), src)

    def apply_rowdiag(self, Urows):
        """diag(W U^T) for row-matched U: Urows [N, Gtot] -> [N] with
        out[p] = W[p, :] @ Urows[p, :] (each row contracted with its own
        stencil only)."""
        picked = torch.gather(Urows, -1, self.flat_idx.mT)
        return torch.sum(self.cw.mT * picked, dim=-1)


def _matvec(femb, interp, noise, grid_size, d):
    """v -> W Kg W^T v + noise v for a fixed embedded kernel `femb`."""
    def mv(v):
        u = bttb_matvec(femb, interp.apply_t(v), grid_size, d)
        return interp.apply(u) + noise * v
    return mv


def ski_matvec(params, interp, steps, grid_size, kernel, d, v, jitter=0.0):
    """K v = W Kg W^T v + (s2 + jitter) v, v [..., N]."""
    femb = grid_kernel_embed_fft(params, steps, grid_size, kernel, d)
    return _matvec(femb, interp, params["likelihood_variance"] + jitter,
                   grid_size, d)(v)


def cg_solve(matvec, B_rhs, tol=1e-6, max_iter=200):
    """Batched-RHS conjugate gradients: solve K x = b for each row of
    B_rhs [R, N], with a per-RHS convergence freeze. The host reads whether
    any RHS still runs every CG_CHECK_EVERY iterations and never runs more
    than `max_iter`: the frozen RHSs make the result that of the JAX
    package's while_loop, which checks every iteration."""
    b = B_rhs
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = torch.sum(r * r, dim=-1)
    bnorm = torch.clamp_min(torch.sqrt(torch.sum(b * b, dim=-1)), 1e-30)
    done = torch.sqrt(rs) <= tol * bnorm
    zero = torch.zeros_like(rs)
    for it in range(int(max_iter)):
        if it % CG_CHECK_EVERY == 0 and not bool(torch.any(~done)):
            break
        Kp = matvec(p)
        alpha = rs / torch.clamp_min(torch.sum(p * Kp, dim=-1), 1e-30)
        alpha = torch.where(done, zero, alpha)
        x = x + alpha[..., None] * p
        r = r - alpha[..., None] * Kp
        rs_new = torch.sum(r * r, dim=-1)
        beta = torch.where(done, zero, rs_new / torch.clamp_min(rs, 1e-30))
        p = r + beta[..., None] * p
        done = done | (torch.sqrt(rs_new) <= tol * bnorm)
        rs = rs_new
    return x


def _grad_surrogate(params, interp, steps, grid_size, kernel, d, alpha,
                    probes, solves, jitter):
    """Scalar whose params-gradient equals the stochastic NLML gradient:
    0.5(-a^T K a + mean_i w_i^T K z_i), a/w_i/z_i detached. K appears only
    through MVMs, so dK is never formed."""
    a = alpha.detach()
    Ka = ski_matvec(params, interp, steps, grid_size, kernel, d, a, jitter)
    term1 = -0.5 * torch.sum(a * Ka)
    z = probes.detach()
    w = solves.detach()
    Kz = ski_matvec(params, interp, steps, grid_size, kernel, d, z, jitter)
    term2 = 0.5 * torch.mean(torch.sum(w * Kz, dim=-1))
    return term1 + term2


def draw_probes(n_probes, n, seed, dtype, device):
    """Rademacher probes [n_probes, n]: signs of normal draws from a
    torch.Generator seeded with `seed` on `device`."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.sign(torch.randn((n_probes, n), generator=gen, dtype=dtype,
                                  device=device))


def ski_fit_adam(params0, bijectors, X, y, starts, steps, grid_size, kernel,
                 jitter=1e-4, iterations=30, lr=0.1, n_probes=8,
                 cg_tol=1e-4, cg_iters=100, seed=0, probes=None):
    """GPyTorch-style KISS-GP fit: fixed-iteration Adam on the stochastic
    NLML gradient (reference optimiser semantics: gpytorch_models.py:181,
    Adam lr=0.1, fixed iterations). Returns (params, interp).

    y [N] is a tensor: its device and dtype are the fit's. X [N, d] (host
    array) builds the stencil. `probes` [n_probes, N] replaces the default
    draw (`draw_probes` from `seed`)."""
    from gpsat_tpu_torch.models.batched import Adam
    from gpsat_tpu_torch.ops.packing import ParamSpec, pack, unpack

    X = np.asarray(X)
    d = X.shape[1]
    dt, dev = y.dtype, y.device
    interp = SparseInterp(X, starts, steps, grid_size, dtype=dt, device=dev)
    steps_t = torch.as_tensor(np.asarray(steps), dtype=dt, device=dev)
    if probes is None:
        probes = draw_probes(n_probes, y.shape[0], seed, dt, dev)
    probes = torch.as_tensor(probes, dtype=dt, device=dev)

    names = list(params0.keys())
    spec = ParamSpec([(nm, np.shape(params0[nm])) for nm in names])
    u0 = pack({nm: bijectors[nm].inverse(torch.as_tensor(
        np.asarray(params0[nm]), dtype=dt, device=dev)) for nm in names},
        spec)

    def to_params(u):
        free = unpack(u, spec)
        return {nm: bijectors[nm].forward(free[nm]) for nm in names}

    opt = Adam(lr)
    rhs = torch.cat([y[None], probes], dim=0)
    u = u0
    for _ in range(int(iterations)):
        with torch.no_grad():
            params = to_params(u)
            femb = grid_kernel_embed_fft(params, steps_t, grid_size, kernel,
                                         d)
            mv = _matvec(femb, interp, params["likelihood_variance"] + jitter,
                         grid_size, d)
            sol = cg_solve(mv, rhs, tol=cg_tol, max_iter=cg_iters)
        with torch.enable_grad():
            ur = u.detach().requires_grad_(True)
            s = _grad_surrogate(to_params(ur), interp, steps_t, grid_size,
                                kernel, d, sol[0], probes, sol[1:], jitter)
            (g,) = torch.autograd.grad(s, ur)
        with torch.no_grad():
            u = opt.step({"u": u}, {"u": g})["u"]
    with torch.no_grad():
        return to_params(u), interp


def ski_predict_cg(params, interp, X, y, Xs, starts, steps, grid_size,
                   kernel, jitter=1e-4, cg_tol=1e-6, cg_iters=200):
    """Posterior at Xs through structured MVMs.

    mean = Ks^T K^{-1} y computed as Ws (Kg (W^T alpha)), one CG solve and
    structured products. Variance: k** - diag(Ks^T K^{-1} Ks) with the
    columns of Ks built by structured products and solved as one batched
    CG (exact, no stochastic estimators in the posterior). y [N] is a
    tensor on interp's device; X and Xs are host arrays.
    """
    d = np.shape(X)[1]
    dt, dev = y.dtype, y.device
    steps_t = torch.as_tensor(np.asarray(steps), dtype=dt, device=dev)
    femb = grid_kernel_embed_fft(params, steps_t, grid_size, kernel, d)
    interp_s = SparseInterp(np.asarray(Xs), starts, steps, grid_size,
                            dtype=dt, device=dev)
    mv = _matvec(femb, interp, params["likelihood_variance"] + jitter,
                 grid_size, d)
    alpha = cg_solve(mv, y[None], tol=cg_tol, max_iter=cg_iters)[0]
    mean = interp_s.apply(bttb_matvec(femb, interp.apply_t(alpha),
                                      grid_size, d))

    P = int(np.shape(Xs)[0])
    eye_rows = torch.eye(P, dtype=dt, device=dev)          # [P, P]
    U = interp_s.apply_t(eye_rows)                         # [P, Gtot]
    U = bttb_matvec(femb, U, grid_size, d)
    Ks_cols = interp.apply(U)                              # [P, N]
    sols = cg_solve(mv, Ks_cols, tol=cg_tol, max_iter=cg_iters)
    quad = torch.sum(Ks_cols * sols, dim=-1)               # [P]
    # SKI-consistent prior variance diag(Ws Kg Ws^T) (ops/ski.ski_predict):
    # U holds Kg Ws^T rows, so each row meets its own stencil weights
    kss = interp_s.apply_rowdiag(U)
    f_var = torch.clamp_min(kss - quad, 0.0)
    return {"f*": mean, "f*_var": f_var,
            "y_var": f_var + params["likelihood_variance"]}
