"""Fused masked-GPR kernels for Hopper: NLML value + gradient, NLML value
only, and posterior prediction (torch counterpart of
gpsat_tpu/ops/pallas_gpr.py).

The CUDA sources are in ``gpsat_tpu_torch/csrc`` (built by ``ops/_build.py``
at first use). The three kernels share one factorisation, as the TPU kernels
share ``_factor_tile_and_invert``: the many-blocks schedule of
``gp_cholinv.cu``, whose first step rebuilds the masked kernel matrix from
the coordinates, with a border of right-hand sides solved along the way
(z = U^{-T} y, and Z* = U^{-T} K* for prediction); N (and P) are padded to
its 64-wide tile inside each launch.

- ``gp_vg.cu``      replaces ``pallas_gpr._vg_kernel``: the factor with W =
                    U^{-1} and the y border, then the K^{-1} tiles and the
                    gradient lanes by tile pair.
- ``gp_predict.cu`` replaces ``pallas_gpr._predict_kernel``: the factor with
                    K* and y in its border, then mean = Z*^T z and
                    var = sf2 - |Z*|^2 by column.
- ``gp_value.cu``   replaces ``pallas_gpr._value_kernel``: the factor with
                    the y border alone, value = 0.5 z.z + log det
                    + 0.5 n log 2 pi by the function vg's value lane uses
                    (the two agree bit for bit on the same inputs).
- ``gp_common.cuh`` the shared device code (``_phi``, ``_phi_grad``, the
                    scaling of the coordinates, the value's fixed-order sum).

Wrappers (``nlml_vg_batched``, ``nlml_value_batched``,
``posterior_predict_batched``) keep the JAX signatures and output contract: raw-parameter gradients, the scalar-
lengthscale broadcast, ``f*_var`` clamped at 0. On a CUDA tensor a wrapper
launches its kernel or raises; it takes its plain PyTorch version
(``*_plain``, the same function in torch.linalg) only for tensors on the
CPU. Each wrapper counts its launches in ``<wrapper>.launches``; a
``CapturedGraph`` adds the launches it captured on each replay.

The shape gates ``cuda_vg_supported`` / ``cuda_value_supported`` /
``cuda_predict_supported`` keep the meaning of ``pallas_vg_supported`` /
``pallas_value_supported`` / ``pallas_predict_supported``: kernel in
the list, D <= 5, N padded to 128 at most 1024, P padded to 128 at most
2048. The engine takes the ops/gpr path outside them. The packing pads N and
P only to 32; each launch pads on to 64 in its own workspace.
"""

import math

import torch

from gpsat_tpu_torch.ops import _build

__all__ = ["cuda_vg_supported", "nlml_vg_batched", "nlml_vg_batched_plain",
           "cuda_value_supported", "nlml_value_batched",
           "nlml_value_batched_plain", "cuda_predict_supported", "posterior_predict_batched",
           "posterior_predict_batched_plain", "launch_counts",
           "reset_launch_counts", "CapturedGraph"]

_MAX_D = 5
_TILE = 32          # the packing's padding unit
_GATE_PAD = 128     # the JAX gates' padding unit
_LOG_2PI = math.log(2.0 * math.pi)

# test switch (the counterpart of pallas_gpr._FORCE_SUPPORTED): route a CPU
# engine through the wrappers, which then run their plain versions, so the
# kernel path's control flow runs without a card
_FORCE_KERNEL_PATH = False

# r2 scale factor per kernel: q2_j = scale * (dx_j / ls_j)^2, and the kernel
# ids of csrc/gp_common.cuh
_KERNELS = {
    "Matern12": 1.0,
    "Matern32": 3.0,
    "Matern52": 5.0,
    "RBF": 1.0,
    "SquaredExponential": 1.0,
    "Exponential": 1.0,
}
_KERNEL_IDS = {"Matern12": 0, "Matern32": 1, "Matern52": 2, "RBF": 3,
               "SquaredExponential": 3, "Exponential": 4}


def _pad_to(n, unit):
    return int(-(-int(n) // unit) * unit)


def cuda_vg_supported(kernel, d, N=None):
    """Can the fused value_and_grad kernel handle this configuration?"""
    if kernel not in _KERNELS or d > _MAX_D:
        return False
    return N is None or _pad_to(N, _GATE_PAD) <= 1024


def cuda_value_supported(kernel, d, N=None):
    """Can the fused value-only kernel handle this configuration? (The same
    limits as the value_and_grad kernel.)"""
    return cuda_vg_supported(kernel, d, N)


def cuda_predict_supported(kernel, d, N=None, P=None):
    """Can the fused prediction kernel handle this configuration?"""
    if not cuda_vg_supported(kernel, d, N):
        return False
    return P is None or _pad_to(P, _GATE_PAD) <= 2048


def _phi(kernel, r2):
    """Correlation phi(r2) (csrc gp_phi)."""
    r = torch.sqrt(torch.clamp_min(r2, 1e-36))
    if kernel == "Matern12":
        return torch.exp(-r)
    if kernel == "Matern32":
        return (1.0 + r) * torch.exp(-r)
    if kernel == "Matern52":
        return (1.0 + r + r * r * (1.0 / 3.0)) * torch.exp(-r)
    if kernel in ("RBF", "SquaredExponential"):
        return torch.exp(-0.5 * r2)
    if kernel == "Exponential":
        return torch.exp(-0.5 * r)
    raise NotImplementedError(kernel)


def _phi_grad(kernel, r2):
    """F(r2) with d phi / d log ls_j = F * q2_j (csrc gp_phi_grad)."""
    r = torch.sqrt(torch.clamp_min(r2, 1e-36))
    if kernel == "Matern12":
        return torch.exp(-r) / r
    if kernel == "Matern32":
        return torch.exp(-r)
    if kernel == "Matern52":
        return (1.0 + r) * (1.0 / 3.0) * torch.exp(-r)
    if kernel in ("RBF", "SquaredExponential"):
        return torch.exp(-0.5 * r2)
    if kernel == "Exponential":
        return torch.exp(-0.5 * r) / (2.0 * r)
    raise NotImplementedError(kernel)


# ---------------------------------------------------------------------------
# input packing (the JAX wrappers' layout, padded to the kernels' tile)
# ---------------------------------------------------------------------------

def _pack(params, X, y, maskf, jitter):
    """-> xt [B,8,Np] (dims 0..D-1, mask in row 7), yt [B,Np] (masked obs),
    p [B,8] (ls, sf2 @5, noise+jitter @6), all f32; plus ls [B,D] and
    whether a scalar lengthscale was broadcast."""
    B, N, D = X.shape
    f32 = torch.float32
    dev = X.device
    Np = _pad_to(max(N, 1), _TILE)
    mf = maskf.to(f32)
    xt = torch.zeros(B, 8, Np, dtype=f32, device=dev)
    xt[:, :D, :N] = X.to(f32).transpose(1, 2)
    xt[:, 7, :N] = mf
    yt = torch.zeros(B, Np, dtype=f32, device=dev)
    yt[:, :N] = y.to(f32) * mf
    ls_in = torch.as_tensor(params["lengthscales"]).to(dev, f32).reshape(B, -1)
    scalar_ls = ls_in.shape[1] == 1 and D > 1
    ls = ls_in.expand(B, D) if scalar_ls else ls_in
    p = torch.zeros(B, 8, dtype=f32, device=dev)
    p[:, :D] = ls
    p[:, 5] = torch.as_tensor(params["kernel_variance"]).to(dev, f32).reshape(B)
    sn2 = torch.as_tensor(params["likelihood_variance"]).to(dev, f32).reshape(B)
    p[:, 6] = sn2 + torch.tensor(jitter, dtype=f32)
    return xt, yt, p, ls, scalar_ls


def _check_cuda(*tensors):
    for t in tensors:
        if not (t.is_cuda and t.dtype == torch.float32 and t.is_contiguous()):
            raise ValueError("CUDA kernel inputs must be contiguous float32 "
                             "CUDA tensors")


# ---------------------------------------------------------------------------
# value + gradient
# ---------------------------------------------------------------------------

def _vg_lanes_plain(xt, yt, p, kernel, D):
    """Plain torch version of csrc/gp_vg.cu on the packed inputs: [B, 8]
    lanes 0 = NLML, 1..D = d/dlog ls_j, 6 = d/dlog sf2, 7 = d/dnoise."""
    B, _, Np = xt.shape
    scale = _KERNELS[kernel]
    m = xt[:, 7, :]
    sf2 = p[:, 5, None, None]
    noise = p[:, 6, None]
    xs = xt[:, :D, :] / p[:, :D, None]                        # [B,D,Np]
    q2 = (xs[:, :, :, None] - xs[:, :, None, :]) ** 2 * scale  # [B,D,Np,Np]
    r2 = q2.sum(dim=1)
    mm = m[:, :, None] * m[:, None, :]
    phi = _phi(kernel, r2)
    A = sf2 * phi * mm + torch.diag_embed(m * (noise - 1.0) + 1.0)
    L, info = torch.linalg.cholesky_ex(A)
    bad = (info != 0) | ~torch.isfinite(A).all(dim=(1, 2))
    eye = torch.eye(Np, dtype=A.dtype, device=A.device).expand_as(A)
    Wl = torch.linalg.solve_triangular(L, eye, upper=False)   # L^{-1} = W^T
    kinv = Wl.mT @ Wl
    alpha = (kinv @ yt[:, :, None])[:, :, 0]
    Q = kinv - alpha[:, :, None] * alpha[:, None, :]
    logdet = torch.log(torch.diagonal(L, dim1=1, dim2=2)).sum(dim=1)
    quad = (yt * alpha).sum(dim=1)
    out = torch.zeros(B, 8, dtype=A.dtype, device=A.device)
    out[:, 0] = 0.5 * quad + logdet + 0.5 * m.sum(dim=1) * _LOG_2PI
    qf = Q * sf2 * _phi_grad(kernel, r2) * mm
    out[:, 1:1 + D] = 0.5 * (qf[:, None] * q2).sum(dim=(2, 3))
    out[:, 6] = 0.5 * (Q * sf2 * phi * mm).sum(dim=(1, 2))
    out[:, 7] = 0.5 * (torch.diagonal(Q, dim1=1, dim2=2) * m).sum(dim=1)
    return torch.where(bad[:, None], torch.full_like(out, torch.nan), out)


def _vg_launch(xt, yt, p, kernel, D):
    """Launch csrc/gp_vg.cu on packed f32 CUDA inputs -> [B, 8] lanes."""
    _check_cuda(xt, yt, p)
    B, _, Np = xt.shape
    if Np % _TILE or Np > 1024:
        raise ValueError("nlml_vg: N must be padded to 32 and at most 1024 "
                         "(the kernel stages one expert's N in shared "
                         "memory)")
    out = torch.empty(B, 8, dtype=torch.float32, device=xt.device)
    if B == 0:
        return out
    lib = _build.load_library()
    ws = torch.empty(lib.gp_vg_ws_floats(B, Np), dtype=torch.float32,
                     device=xt.device)
    with torch.cuda.device(xt.device):
        stream = torch.cuda.current_stream(xt.device).cuda_stream
        code = lib.gp_vg_launch(xt.data_ptr(), yt.data_ptr(), p.data_ptr(),
                                out.data_ptr(), ws.data_ptr(), B, Np, D,
                                _KERNEL_IDS[kernel], stream)
    _build.check(lib, code, "gp_vg_launch")
    nlml_vg_batched.launches += 1
    return out


def _vg_unpack(out, params, ls, scalar_ls, D):
    val = out[:, 0]
    g_ls = out[:, 1:1 + D] / ls                 # d/dlog ls -> raw gradient
    if scalar_ls:
        g_ls = torch.sum(g_ls, dim=1, keepdim=True)
    g_ls = g_ls.reshape(torch.as_tensor(params["lengthscales"]).shape)
    sf2 = torch.as_tensor(params["kernel_variance"])
    g_sf2 = (out[:, 6] / sf2.to(out).reshape(-1)).reshape(sf2.shape)
    g_sn2 = out[:, 7].reshape(
        torch.as_tensor(params["likelihood_variance"]).shape)
    return val, {"lengthscales": g_ls, "kernel_variance": g_sf2,
                 "likelihood_variance": g_sn2}


def nlml_vg_batched(params, X, y, maskf, kernel, jitter):
    """Batched NLML value AND gradient via the fused kernel.

    params: dict of [B]-leading tensors (lengthscales [B, d] or [B, 1],
    kernel_variance [B], likelihood_variance [B]); X [B, N, D]; y [B, N];
    maskf [B, N] float. Returns (val [B], grads) with f32 raw-parameter
    gradients shaped like the params (equal to autodiff through
    ops.gpr.nlml_fused at f32 tolerance).
    """
    B, N, D = X.shape
    xt, yt, p, ls, scalar_ls = _pack(params, X, y, maskf, jitter)
    if X.is_cuda:
        if not cuda_vg_supported(kernel, D, N):
            raise ValueError(f"nlml_vg_batched: kernel={kernel} D={D} N={N} "
                             "is outside the CUDA kernel's gate")
        out = _vg_launch(xt, yt, p, kernel, D)
    elif X.device.type == "cpu":
        out = _vg_lanes_plain(xt, yt, p, kernel, D)
    else:
        raise ValueError(f"nlml_vg_batched: unsupported device {X.device}")
    return _vg_unpack(out, params, ls, scalar_ls, D)


nlml_vg_batched.launches = 0


def nlml_vg_batched_plain(params, X, y, maskf, kernel, jitter):
    """nlml_vg_batched computed with torch.linalg on any device."""
    D = X.shape[2]
    xt, yt, p, ls, scalar_ls = _pack(params, X, y, maskf, jitter)
    return _vg_unpack(_vg_lanes_plain(xt, yt, p, kernel, D), params, ls,
                      scalar_ls, D)


# ---------------------------------------------------------------------------
# value only
# ---------------------------------------------------------------------------

def _masked_matrix(xt, p, kernel, D):
    """(A, xd, m) of the packed inputs: the masked noisy kernel matrix
    [B,Np,Np], the lengthscale-scaled coordinates [B,D,Np], the mask."""
    m = xt[:, 7, :]
    xd = xt[:, :D, :] / p[:, :D, None]
    r2 = ((xd[:, :, :, None] - xd[:, :, None, :]) ** 2).sum(dim=1) \
        * _KERNELS[kernel]
    A = p[:, 5, None, None] * _phi(kernel, r2) \
        * (m[:, :, None] * m[:, None, :]) \
        + torch.diag_embed(m * (p[:, 6, None] - 1.0) + 1.0)
    return A, xd, m


def _value_plain(xt, yt, p, kernel, D):
    """Plain torch version of csrc/gp_value.cu on the packed inputs: [B]
    NLML values, NaN where the matrix is not positive definite."""
    A, _, m = _masked_matrix(xt, p, kernel, D)
    L, info = torch.linalg.cholesky_ex(A)
    bad = (info != 0) | ~torch.isfinite(A).all(dim=(1, 2))
    z = torch.linalg.solve_triangular(L, yt[:, :, None], upper=False)[:, :, 0]
    val = 0.5 * (z * z).sum(dim=1) \
        + torch.log(torch.diagonal(L, dim1=1, dim2=2)).sum(dim=1) \
        + 0.5 * m.sum(dim=1) * _LOG_2PI
    return torch.where(bad, torch.full_like(val, torch.nan), val)


def _value_launch(xt, yt, p, kernel, D):
    """Launch csrc/gp_value.cu on packed f32 CUDA inputs -> [B] values."""
    _check_cuda(xt, yt, p)
    B, _, Np = xt.shape
    out = torch.empty(B, dtype=torch.float32, device=xt.device)
    if B == 0:
        return out
    lib = _build.load_library()
    ws = torch.empty(lib.gp_value_ws_floats(B, Np), dtype=torch.float32,
                     device=xt.device)
    with torch.cuda.device(xt.device):
        stream = torch.cuda.current_stream(xt.device).cuda_stream
        code = lib.gp_value_launch(xt.data_ptr(), yt.data_ptr(), p.data_ptr(),
                                   out.data_ptr(), ws.data_ptr(), B, Np, D,
                                   _KERNEL_IDS[kernel], stream)
    _build.check(lib, code, "gp_value_launch")
    nlml_value_batched.launches += 1
    return out


def nlml_value_batched(params, X, y, maskf, kernel, jitter):
    """Batched NLML values via the fused value-only kernel.

    params/X/y/maskf as nlml_vg_batched. Returns [B] f32 values equal to
    ops.gpr.nlml per expert at f32 tolerance; NaN for an expert whose matrix
    is not positive definite.
    """
    B, N, D = X.shape
    xt, yt, p, _, _ = _pack(params, X, y, maskf, jitter)
    if X.is_cuda:
        if not cuda_value_supported(kernel, D, N):
            raise ValueError(f"nlml_value_batched: kernel={kernel} D={D} "
                             f"N={N} is outside the CUDA kernel's gate")
        return _value_launch(xt, yt, p, kernel, D)
    if X.device.type == "cpu":
        return _value_plain(xt, yt, p, kernel, D)
    raise ValueError(f"nlml_value_batched: unsupported device {X.device}")


nlml_value_batched.launches = 0


def nlml_value_batched_plain(params, X, y, maskf, kernel, jitter):
    """nlml_value_batched computed with torch.linalg on any device."""
    xt, yt, p, _, _ = _pack(params, X, y, maskf, jitter)
    return _value_plain(xt, yt, p, kernel, X.shape[2])


# ---------------------------------------------------------------------------
# posterior prediction
# ---------------------------------------------------------------------------

def _pack_xs(Xs):
    B, P, D = Xs.shape
    Pp = _pad_to(max(P, 1), _TILE)
    xs = torch.zeros(B, 8, Pp, dtype=torch.float32, device=Xs.device)
    xs[:, :D, :P] = Xs.to(torch.float32).transpose(1, 2)
    return xs


def _predict_plain(xt, yt, p, xs, kernel, D):
    """Plain torch version of csrc/gp_predict.cu: (mean, var) [B, Pp]."""
    scale = _KERNELS[kernel]
    sf2 = p[:, 5, None, None]
    A, xd, m = _masked_matrix(xt, p, kernel, D)
    xp = xs[:, :D, :] / p[:, :D, None]
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.where((info != 0)[:, None, None], torch.full_like(L, torch.nan),
                    L)
    alpha = torch.cholesky_solve(yt[:, :, None], L)[:, :, 0]
    r2s = ((xd[:, :, :, None] - xp[:, :, None, :]) ** 2).sum(dim=1) * scale
    ks = sf2 * _phi(kernel, r2s) * m[:, :, None]               # [B,Np,Pp]
    mean = (ks * alpha[:, :, None]).sum(dim=1)
    v = torch.linalg.solve_triangular(L, ks, upper=False)     # = W^T Ks
    var = p[:, 5, None] - (v * v).sum(dim=1)
    return mean, var


def _predict_launch(xt, yt, p, xs, kernel, D):
    """Launch csrc/gp_predict.cu on packed f32 CUDA inputs -> (mean, var)."""
    _check_cuda(xt, yt, p, xs)
    B, _, Np = xt.shape
    Pp = xs.shape[2]
    mean = torch.empty(B, Pp, dtype=torch.float32, device=xt.device)
    var = torch.empty(B, Pp, dtype=torch.float32, device=xt.device)
    if B == 0:
        return mean, var
    lib = _build.load_library()
    ws = torch.empty(lib.gp_predict_ws_floats(B, Np, Pp),
                     dtype=torch.float32, device=xt.device)
    with torch.cuda.device(xt.device):
        stream = torch.cuda.current_stream(xt.device).cuda_stream
        code = lib.gp_predict_launch(
            xt.data_ptr(), yt.data_ptr(), p.data_ptr(), xs.data_ptr(),
            mean.data_ptr(), var.data_ptr(), ws.data_ptr(), B, Np, Pp, D,
            _KERNEL_IDS[kernel], stream)
    _build.check(lib, code, "gp_predict_launch")
    posterior_predict_batched.launches += 1
    return mean, var


def _predict_unpack(mean, var, params, P):
    B = mean.shape[0]
    sn2 = torch.as_tensor(params["likelihood_variance"]).to(mean).reshape(B)
    f_var = torch.clamp_min(var[:, :P], 0.0)
    return {"f*": mean[:, :P], "f*_var": f_var, "y_var": f_var + sn2[:, None]}


def posterior_predict_batched(params, X, y, maskf, Xs, kernel, jitter):
    """Batched posterior prediction via the fused kernel.

    params/X/y/maskf as nlml_vg_batched; Xs [B, P, D]. Returns the
    prediction dict of ops.gpr.predict: 'f*' [B, P], 'f*_var' (clamped >= 0)
    and 'y_var' = f*_var + likelihood_variance, all f32.
    """
    B, N, D = X.shape
    P = Xs.shape[1]
    xt, yt, p, _, _ = _pack(params, X, y, maskf, jitter)
    xs = _pack_xs(Xs)
    if X.is_cuda:
        if not cuda_predict_supported(kernel, D, N, P):
            raise ValueError(f"posterior_predict_batched: kernel={kernel} "
                             f"D={D} N={N} P={P} is outside the CUDA "
                             "kernel's gate")
        mean, var = _predict_launch(xt, yt, p, xs, kernel, D)
    elif X.device.type == "cpu":
        mean, var = _predict_plain(xt, yt, p, xs, kernel, D)
    else:
        raise ValueError(
            f"posterior_predict_batched: unsupported device {X.device}")
    return _predict_unpack(mean, var, params, P)


posterior_predict_batched.launches = 0


def posterior_predict_batched_plain(params, X, y, maskf, Xs, kernel, jitter):
    """posterior_predict_batched computed with torch.linalg on any device."""
    D = X.shape[2]
    xt, yt, p, _, _ = _pack(params, X, y, maskf, jitter)
    mean, var = _predict_plain(xt, yt, p, _pack_xs(Xs), kernel, D)
    return _predict_unpack(mean, var, params, Xs.shape[1])


def _counted_wrappers():
    """{name: wrapper} of every kernel wrapper that counts its launches (the
    SGPR modules import this one, so they are imported here on demand)."""
    from gpsat_tpu_torch.ops import cuda_cholinv, cuda_sgpr
    return {"nlml_vg": nlml_vg_batched,
            "posterior_predict": posterior_predict_batched,
            "nlml_value": nlml_value_batched,
            "cholinv": cuda_cholinv.cholinv_batched,
            "sgpr_stream1": cuda_sgpr.sgpr_stream1,
            "sgpr_stream2": cuda_sgpr.sgpr_stream2,
            "sgpr_vg_mega": cuda_sgpr.sgpr_vg_mega}


def launch_counts():
    """{kernel name: launches since the last reset} of every wrapper."""
    return {name: fn.launches for name, fn in _counted_wrappers().items()}


def reset_launch_counts():
    """Set every wrapper's launch count to 0."""
    for fn in _counted_wrappers().values():
        fn.launches = 0


class CapturedGraph:
    """`fn`, work on device buffers that reads and uploads nothing from the
    host, captured once as a CUDA graph on a stream of its own on `device`.
    `replay()` runs it on the current stream and adds the wrapper launches
    the capture recorded to the wrappers' counts (launch_counts), as a call
    of `fn` would; the capture itself launched nothing and counts nothing.
    The graph and its memory pool go with the object.

    The capture takes its memory from the device into the graph's own pool,
    and the caching allocator cannot free what it holds for eager work while
    a capture runs: after eager work that held most of the card, the capture
    would run out of memory with the card's memory cached. So the cache, and
    the pools of graphs freed before, go back to the device first."""

    def __init__(self, fn, device):
        before = launch_counts()
        torch.cuda.empty_cache()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(torch.cuda.Stream(device)):
            self.graph.capture_begin()
            try:
                fn()
            finally:
                self.graph.capture_end()
        self.launches = []
        for name, wrapper in _counted_wrappers().items():
            n = wrapper.launches - before[name]
            if n:
                wrapper.launches -= n
                self.launches.append((wrapper, n))

    def replay(self):
        self.graph.replay()
        for wrapper, n in self.launches:
            wrapper.launches += n
