"""Fused masked SGPR collapsed-ELBO value + gradient and posterior prediction
for Hopper (torch counterpart of gpsat_tpu/ops/pallas_sgpr.py).

The gradient comes from hand-derived M-sized adjoint identities instead of
differentiating through the Choleskys:

  A~  = W_u^T Kuf                      (Kuu = U_u^T U_u, W_u = U_u^{-1})
  B   = I + s^-2 A~ A~^T,  U_B, W_B = U_B^{-1}
  a~  = A~ ybar,  dd = B^{-1} a~
  value = 0.5 n log 2pi + sum log diag U_B + 0.5 n log s2
          + 0.5 y.y/s2 - 0.5 a~.dd / s2^2 + 0.5 (sf2 n - |A~|_F^2)/s2
  Kbar_uf = -s^-2 W_u [(I - B^{-1}) A~ + dd beta^T],
            beta = s^-2 ybar - s^-4 A~^T dd
  Kbar_uu = 0.5 [W_u B W_u^T - 2 W_u W_u^T + G2 G2^T + s^-4 e e^T]
            with G2 = W_u W_B, e = W_u dd
  g_theta = <Kbar_uu, dKuu/dtheta> + <Kbar_uf, dKuf/dtheta>
            + (s^-2/2) d trKff/dtheta          (trKff = sf2 n, stationary)
  g_s2    = 0.5 s^-2 (n - M + tr B^{-1})
            - 0.5 s^-4 (y.y - a~.dd/s2 - dd.dd/s2)
            - 0.5 s^-4 (sf2 n - |A~|_F^2)

Masking matches ops/sgpr.py exactly: the data mask zeroes Kuf columns and
ybar; the (prefix) inducing mask zeroes Kuu cross terms and Kuf rows with a
unit diagonal on the padded inducing block, so padded rows contribute exactly
nothing to value or gradients (tr B^{-1} and M cancel row-wise). M is padded
to a multiple of 128, as in the JAX package (the constant M in g_s2 is the
padded one).

Three routes compute the same value and gradient (``sgpr_vg_batched(...,
route=)``):

- ``"hybrid"`` (the default): torch batched matmuls around the two
  factorisations, which run in the fused kernel of ``ops/cuda_cholinv.py``;
- ``"stream"``: the same factorisations, torch for the M x M work, and the
  two streamed kernels of ``csrc/gp_sgpr_stream.cu`` for everything N-sized
  (``sgpr_stream1`` / ``sgpr_stream2`` below, each with its plain version
  and launch counter), so no [B, M, N] array is held by torch;
- ``"mega"``: everything between the packed inputs and the [B, 8] output
  lanes in one launch entry of ``csrc/gp_sgpr_vg.cu`` (``sgpr_vg_mega``
  below, the counterpart of ``pallas_sgpr._sgpr_vg_kernel``): no torch op and
  no library call in between. It forms
  Kbar_uu = 0.5 [W_u (Bsum - P) W_u^T + s^-4 e e^T] with Bsum = B - I and
  P = I - B^{-1} = B^{-1} Bsum, the same function as the sum above.

``sgpr_predict_batched`` is hybrid style. On CUDA tensors the wrappers launch
their kernels or raise; on CPU tensors they run the plain versions. Every
matmul here runs in full f32: TF32 is switched off for the duration of a call.
Each ``sgpr_vg_batched`` call is one ``sgpr.vg`` span of the recorder
(``gpsat_tpu_torch.tracing``; attrs route, experts, n, m) and each
``sgpr_predict_batched`` call one ``sgpr.predict`` span (experts, n, m, p).
"""

import contextlib
import math

import torch

from gpsat_tpu_torch import tracing
from gpsat_tpu_torch.ops import _build
from gpsat_tpu_torch.ops.cuda_cholinv import cholinv_batched
from gpsat_tpu_torch.ops.cuda_gpr import (_GATE_PAD, _KERNEL_IDS, _KERNELS,
                                          _MAX_D, _check_cuda, _pad_to, _phi,
                                          _phi_grad)

__all__ = ["sgpr_vg_supported", "sgpr_vg_batched", "sgpr_predict_batched",
           "sgpr_stream1", "sgpr_stream2", "sgpr_vg_mega", "ROUTES"]

ROUTES = ("hybrid", "stream", "mega")
_LOG_2PI = math.log(2.0 * math.pi)
_PANEL = 128        # GS_PW in csrc/gp_sgpr_stream.cu
_SLAB = 4096        # stream1's slab width: the data columns of one pass


def sgpr_vg_supported(kernel, d, N=None, M=None, route="hybrid"):
    """Can the fused SGPR value_and_grad / prediction path handle this
    configuration? Every route streams N, so the kernel family, the
    coordinate dimension and the factor size are gated; route "mega" keeps in
    addition the data limit of the monolithic JAX kernel: N padded (to 128 up
    to 1024, to 1024 beyond) at most 4096."""
    if kernel not in _KERNELS or d > _MAX_D:
        return False
    if M is not None and _pad_to(M, _GATE_PAD) > 1024:
        return False
    if route == "mega" and N is not None:
        return _pad_to(N, 1024 if N > 1024 else _GATE_PAD) <= 4096
    return True


@contextlib.contextmanager
def _full_f32_matmul():
    """f32 matmuls in full precision for the duration of the block."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def _prepare(params, X, y, maskf, Z, zmaskf):
    """f32 inputs with the inducing axis padded to a multiple of 128."""
    f32 = torch.float32
    dev = X.device
    X = X.to(f32)
    Z = torch.as_tensor(Z).to(dev, f32)
    B, N, D = X.shape
    M = Z.shape[1]
    M_pad = _pad_to(M, _GATE_PAD)
    m = torch.as_tensor(maskf).to(dev, f32)
    zm = torch.as_tensor(zmaskf).to(dev, f32)
    if M_pad != M:
        Z = torch.cat([Z, Z.new_zeros(B, M_pad - M, D)], dim=1)
        zm = torch.cat([zm, zm.new_zeros(B, M_pad - M)], dim=1)
    ls_in = torch.as_tensor(params["lengthscales"]).to(dev, f32).reshape(B, -1)
    scalar_ls = ls_in.shape[1] == 1 and D > 1
    ls = ls_in.expand(B, D) if scalar_ls else ls_in
    sf2 = torch.as_tensor(params["kernel_variance"]).to(dev, f32).reshape(B)
    s2 = torch.as_tensor(params["likelihood_variance"]).to(dev, f32).reshape(B)
    ybar = torch.as_tensor(y).to(dev, f32) * m
    return X, Z, m, zm, ls, scalar_ls, sf2, s2, ybar


def _r2_of(A1, A2, scale):
    """[B, P, Q] scaled squared distances by explicit per-dimension
    differences (no |a|^2 + |b|^2 - 2ab: inducing points are copies of data
    points and that form cancels in f32)."""
    d2 = None
    for j in range(A1.shape[2]):
        dj = A1[:, :, None, j] - A2[:, None, :, j]
        d2 = dj * dj if d2 is None else d2 + dj * dj
    return d2 * scale


def _kuu(Zs, zm, sf2, kernel, jitter):
    """(Kuu, r2_uu, phi_uu, zmm): masked Kuu with jitter on the valid
    diagonal and a unit diagonal on the padded rows."""
    r2_uu = _r2_of(Zs, Zs, _KERNELS[kernel])
    phi_uu = _phi(kernel, r2_uu)
    zmm = zm[:, :, None] * zm[:, None, :]
    Kuu = sf2[:, None, None] * phi_uu * zmm + torch.diag_embed(
        zm * (jitter - 1.0) + 1.0)
    return Kuu, r2_uu, phi_uu, zmm


def _q2_contract(QF, Aj, Bj):
    """sum_mn QF_mn (Aj_m - Bj_n)^2, elementwise: QF carries the
    near-singular F at coincident pairs, which the rank-1 expansion would
    cancel catastrophically in f32 while this multiplies it by an exact 0."""
    dj = Aj[:, :, None] - Bj[:, None, :]
    return torch.sum(QF * dj * dj, dim=(1, 2))


def _kbar_uu(W_u, W_B, Bm, dd, s2):
    """0.5 (W_u B W_u^T - 2 W_u W_u^T + G2 G2^T + s^-4 e e^T)."""
    BW = Bm @ W_u.mT
    G2 = W_u @ W_B
    e = (W_u @ dd[:, :, None])[:, :, 0]
    return 0.5 * (W_u @ BW - 2.0 * (W_u @ W_u.mT) + G2 @ G2.mT
                  + (e[:, :, None] * e[:, None, :]) / (s2 * s2)[:, None, None])


def _finish(params, val, g_logls, g_logsf2, g_s2, ls, scalar_ls, sf2):
    """Raw-parameter gradients shaped like the params."""
    g_ls = g_logls / ls
    if scalar_ls:
        g_ls = torch.sum(g_ls, dim=1, keepdim=True)
    grads = {
        "lengthscales": g_ls.reshape(
            torch.as_tensor(params["lengthscales"]).shape),
        "kernel_variance": (g_logsf2 / sf2).reshape(
            torch.as_tensor(params["kernel_variance"]).shape),
        "likelihood_variance": g_s2.reshape(
            torch.as_tensor(params["likelihood_variance"]).shape),
    }
    return val, grads


def _value_and_gs2(n, logdetB, s2, sf2, ydoty, atdd, dddd, trA2, trBinv,
                   M_pad):
    val = (0.5 * n * _LOG_2PI + logdetB + 0.5 * n * torch.log(s2)
           + 0.5 * ydoty / s2 - 0.5 * atdd / (s2 * s2)
           + 0.5 * (sf2 * n - trA2) / s2)
    g_s2 = (0.5 / s2 * (n - float(M_pad) + trBinv)
            - 0.5 / (s2 * s2) * (ydoty - atdd / s2 - dddd / s2)
            - 0.5 / (s2 * s2) * (sf2 * n - trA2))
    return val, g_s2


# ---------------------------------------------------------------------------
# hybrid route: torch batched matmuls + the cholinv kernel
# ---------------------------------------------------------------------------

def _sgpr_vg_hybrid(params, X, y, maskf, Z, zmaskf, kernel, jitter):
    """Closed-form adjoint identities of the module docstring, no autograd
    anywhere. Holds about a dozen [B, M_pad, N] f32 temporaries."""
    X, Z, m, zm, ls, scalar_ls, sf2, s2, ybar = _prepare(
        params, X, y, maskf, Z, zmaskf)
    D = X.shape[2]
    M_pad = Z.shape[1]
    scale = _KERNELS[kernel]
    n = torch.sum(m, dim=1)
    Zs = Z / ls[:, None, :]
    Xs = X / ls[:, None, :]
    sf2c = sf2[:, None, None]
    inv_s2 = 1.0 / s2[:, None, None]
    mm = zm[:, :, None] * m[:, None, :]
    eyeM = torch.eye(M_pad, dtype=X.dtype, device=X.device)

    Kuu, r2_uu, phi_uu, zmm = _kuu(Zs, zm, sf2, kernel, jitter)
    W_u, _ = cholinv_batched(Kuu)

    r2_uf = _r2_of(Zs, Xs, scale)
    phi_uf = _phi(kernel, r2_uf)
    Kuf = sf2c * phi_uf * mm                                   # [B,M,N]
    At = W_u.mT @ Kuf                                          # A~
    Bm = (At @ At.mT) * inv_s2 + eyeM
    W_B, logdetB = cholinv_batched(Bm)

    at = (At @ ybar[:, :, None])[:, :, 0]                      # a~
    c = (at[:, None, :] @ W_B)[:, 0, :]                        # a~^T W_B
    dd = (W_B @ c[:, :, None])[:, :, 0]                        # B^{-1} a~
    atdd = torch.sum(at * dd, dim=1)
    dddd = torch.sum(dd * dd, dim=1)
    trBinv = torch.sum(W_B * W_B, dim=(1, 2))
    trA2 = torch.sum(At * At, dim=(1, 2))
    ydoty = torch.sum(ybar * ybar, dim=1)
    val, g_s2 = _value_and_gs2(n, logdetB, s2, sf2, ydoty, atdd, dddd, trA2,
                               trBinv, M_pad)

    # Kbar_uf = -s^-2 W_u [(I - B^{-1}) A~ + dd beta^T]
    beta = ybar * inv_s2[:, :, 0] - (dd[:, None, :] @ At)[:, 0, :] \
        / (s2 * s2)[:, None]
    binvA = W_B @ (W_B.mT @ At)
    v = At - binvA + dd[:, :, None] * beta[:, None, :]
    Kbar_uf = -(W_u @ v) * inv_s2
    Kbar_uu = _kbar_uu(W_u, W_B, Bm, dd, s2)

    g_logsf2 = (torch.sum(Kbar_uu * (sf2c * phi_uu * zmm), dim=(1, 2))
                + torch.sum(Kbar_uf * (sf2c * phi_uf * mm), dim=(1, 2))
                + 0.5 * sf2 * n / s2)
    QF_uu = Kbar_uu * (sf2c * _phi_grad(kernel, r2_uu) * zmm)
    QF_uf = Kbar_uf * (sf2c * _phi_grad(kernel, r2_uf) * mm)
    g_logls = torch.stack(
        [scale * (_q2_contract(QF_uu, Zs[:, :, j], Zs[:, :, j])
                  + _q2_contract(QF_uf, Zs[:, :, j], Xs[:, :, j]))
         for j in range(D)], dim=1)                            # [B, D]
    return _finish(params, val, g_logls, g_logsf2, g_s2, ls, scalar_ls, sf2)


# ---------------------------------------------------------------------------
# the streamed kernels: wrappers and plain versions
# ---------------------------------------------------------------------------

def _pack_stream(X, m, ybar, Z, zm, ls, sf2, s2):
    """-> xt [B,8,Np] (dims 0..D-1, mask in row 7), yt [B,Np] (ybar),
    zt [B,8,Mp] (inducing dims, mask in row 7), p [B,8] (ls, sf2 @5, s2 @6);
    N padded to the kernels' 128-column panel."""
    B, N, D = X.shape
    Mp = Z.shape[1]
    Np = _pad_to(max(N, 1), _PANEL)
    xt = X.new_zeros(B, 8, Np)
    xt[:, :D, :N] = X.transpose(1, 2)
    xt[:, 7, :N] = m
    yt = X.new_zeros(B, Np)
    yt[:, :N] = ybar
    zt = X.new_zeros(B, 8, Mp)
    zt[:, :D, :] = Z.transpose(1, 2)
    zt[:, 7, :] = zm
    p = X.new_zeros(B, 8)
    p[:, :D] = ls
    p[:, 5] = sf2
    p[:, 6] = s2
    return xt, yt, zt, p


def _kuf_at_plain(xt, zt, p, wu, kernel, D):
    """(A~ = W_u^T Kuf [B,Mp,Np], [q2_j], r2, mm) on the packed inputs."""
    scale = _KERNELS[kernel]
    xs = xt[:, :D, :] / p[:, :D, None]
    zs = zt[:, :D, :] / p[:, :D, None]
    q2 = [(zs[:, j, :, None] - xs[:, j, None, :]) ** 2 * scale
          for j in range(D)]
    r2 = sum(q2)
    mm = zt[:, 7, :, None] * xt[:, 7, None, :]
    kuf = p[:, 5, None, None] * _phi(kernel, r2) * mm
    return wu.mT @ kuf, q2, r2, mm


def _stream1_plain(xt, yt, zt, p, wu, kernel, D):
    """Plain torch version of gp_sgpr_stream1: (Bsum = A~A~^T/s2 [B,Mp,Mp],
    a~ = A~ ybar [B,Mp], trA2 = |A~|_F^2 [B])."""
    At, _, _, _ = _kuf_at_plain(xt, zt, p, wu, kernel, D)
    Bsum = (At @ At.mT) / p[:, 6, None, None]
    at = (At @ yt[:, :, None])[:, :, 0]
    return Bsum, at, torch.sum(At * At, dim=(1, 2))


def _stream2_plain(xt, yt, zt, p, wu, pmat, dd, kernel, D):
    """Plain torch version of gp_sgpr_stream2: gout [B, 8], lanes 1..D the
    uf part of d/dlog ls_j, lane 6 the uf part of d/dlog sf2."""
    At, q2, r2, mm = _kuf_at_plain(xt, zt, p, wu, kernel, D)
    sf2c = p[:, 5, None, None]
    inv_s2 = 1.0 / p[:, 6, None]
    beta = yt * inv_s2 - (dd[:, None, :] @ At)[:, 0, :] * inv_s2 * inv_s2
    v = pmat @ At + dd[:, :, None] * beta[:, None, :]
    kbar = -(wu @ v) * inv_s2[:, :, None]
    gout = xt.new_zeros(xt.shape[0], 8)
    gout[:, 6] = torch.sum(kbar * (sf2c * _phi(kernel, r2) * mm), dim=(1, 2))
    qf = kbar * (sf2c * _phi_grad(kernel, r2) * mm)
    for j in range(D):
        gout[:, 1 + j] = torch.sum(qf * q2[j], dim=(1, 2))
    return gout


def _slab_width(Np):
    """stream1's slab: all Np data columns up to _SLAB (the bench's N=2000
    and route mega's whole gate are one slab), else _SLAB, so the [B, slab,
    Mp] workspace does not grow with N beyond one slab."""
    return min(Np, _SLAB)


def _item_blocks(B, Np, device):
    """The grid of the streamed kernels' (expert, panel) items (stream1's
    build, stream2): one block per SM (256 threads with 8x8 micro-tiles need
    most of an SM's registers) takes the B x panels items in turn, at most
    one block per item. Each block has its own panel buffers, so the
    workspace does not grow with B or N."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(B * (-(-Np // _PANEL)), sms))


def _check_stream(xt, yt, zt, p, wu, kernel, D):
    _check_cuda(xt, yt, zt, p, wu)
    Mp = zt.shape[2]
    if not sgpr_vg_supported(kernel, D, None, Mp) or Mp % _GATE_PAD:
        raise ValueError(f"sgpr stream kernels: kernel={kernel} D={D} "
                         f"M_pad={Mp} is outside the CUDA kernels' gate")
    if xt.shape[2] % _PANEL:
        raise ValueError("sgpr stream kernels: N must be padded to 128")


def _stream1_launch(xt, yt, zt, p, wu, kernel, D):
    _check_stream(xt, yt, zt, p, wu, kernel, D)
    if wu.data_ptr() % 16:
        raise ValueError("sgpr_stream1: W_u must start on 16 bytes")
    B, _, Np = xt.shape
    Mp = zt.shape[2]
    dev = xt.device
    Ns = _slab_width(Np)
    G = _item_blocks(B, Ns, dev)

    def empty(*shape):
        return torch.empty(*shape, dtype=torch.float32, device=dev)
    Bsum, at, trA2 = empty(B, Mp, Mp), empty(B, Mp), empty(B)
    if B == 0:
        return Bsum, at, trA2
    slab, pans = empty(B, Ns, Mp), empty(G, Mp, _PANEL)
    partA, partT = empty(B, Ns // _PANEL, Mp), empty(B, Ns // _PANEL)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.gp_sgpr_stream1_launch(
            xt.data_ptr(), yt.data_ptr(), zt.data_ptr(), p.data_ptr(),
            wu.data_ptr(), Bsum.data_ptr(), at.data_ptr(), trA2.data_ptr(),
            slab.data_ptr(), partA.data_ptr(), partT.data_ptr(),
            pans.data_ptr(), B, Np, Mp, D, Ns, G, _KERNEL_IDS[kernel],
            stream)
    _build.check(lib, code, "gp_sgpr_stream1_launch")
    sgpr_stream1.launches += 1
    return Bsum, at, trA2


def _stream2_launch(xt, yt, zt, p, wu, pmat, dd, kernel, D):
    _check_stream(xt, yt, zt, p, wu, kernel, D)
    _check_cuda(pmat, dd)
    if wu.data_ptr() % 16 or pmat.data_ptr() % 16:
        raise ValueError("sgpr_stream2: W_u and P must start on 16 bytes")
    B, _, Np = xt.shape
    Mp = zt.shape[2]
    dev = xt.device
    G = _item_blocks(B, Np, dev)
    gout = torch.empty(B, 8, dtype=torch.float32, device=dev)
    partG = torch.empty(B, Np // _PANEL, 8, dtype=torch.float32, device=dev)
    ws = torch.empty(G, 2, Mp, _PANEL, dtype=torch.float32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.gp_sgpr_stream2_launch(
            xt.data_ptr(), yt.data_ptr(), zt.data_ptr(), p.data_ptr(),
            wu.data_ptr(), pmat.data_ptr(), dd.data_ptr(), gout.data_ptr(),
            partG.data_ptr(), ws.data_ptr(), B, Np, Mp, D, G,
            _KERNEL_IDS[kernel], stream)
    _build.check(lib, code, "gp_sgpr_stream2_launch")
    sgpr_stream2.launches += 1
    return gout


def sgpr_stream1(xt, yt, zt, p, wu, kernel, D):
    """(Bsum, a~, trA2) of the packed inputs (see _pack_stream); wu is the
    upper-triangular W_u of cholinv_batched. Kernel on CUDA tensors, plain
    version on CPU tensors."""
    if xt.is_cuda:
        return _stream1_launch(xt, yt, zt, p, wu, kernel, D)
    if xt.device.type == "cpu":
        return _stream1_plain(xt, yt, zt, p, wu, kernel, D)
    raise ValueError(f"sgpr_stream1: unsupported device {xt.device}")


def sgpr_stream2(xt, yt, zt, p, wu, pmat, dd, kernel, D):
    """gout [B, 8] of the packed inputs plus P = I - B^{-1} and dd = B^{-1}a~.
    Kernel on CUDA tensors, plain version on CPU tensors."""
    if xt.is_cuda:
        return _stream2_launch(xt, yt, zt, p, wu, pmat, dd, kernel, D)
    if xt.device.type == "cpu":
        return _stream2_plain(xt, yt, zt, p, wu, pmat, dd, kernel, D)
    raise ValueError(f"sgpr_stream2: unsupported device {xt.device}")


sgpr_stream1.launches = 0
sgpr_stream2.launches = 0


# ---------------------------------------------------------------------------
# stream route
# ---------------------------------------------------------------------------

def _sgpr_vg_stream(params, X, y, maskf, Z, zmaskf, kernel, jitter):
    """The hybrid's identities with everything N-sized in the two streamed
    kernels; torch keeps the M x M work between them."""
    X, Z, m, zm, ls, scalar_ls, sf2, s2, ybar = _prepare(
        params, X, y, maskf, Z, zmaskf)
    D = X.shape[2]
    M_pad = Z.shape[1]
    scale = _KERNELS[kernel]
    n = torch.sum(m, dim=1)
    Zs = Z / ls[:, None, :]
    sf2c = sf2[:, None, None]
    eyeM = torch.eye(M_pad, dtype=X.dtype, device=X.device)

    Kuu, r2_uu, phi_uu, zmm = _kuu(Zs, zm, sf2, kernel, jitter)
    W_u, _ = cholinv_batched(Kuu)

    xt, yt, zt, p = _pack_stream(X, m, ybar, Z, zm, ls, sf2, s2)
    Bsum, at, trA2 = sgpr_stream1(xt, yt, zt, p, W_u, kernel, D)
    Bm = Bsum + eyeM
    W_B, logdetB = cholinv_batched(Bm)

    c = (at[:, None, :] @ W_B)[:, 0, :]
    dd = (W_B @ c[:, :, None])[:, :, 0]
    atdd = torch.sum(at * dd, dim=1)
    dddd = torch.sum(dd * dd, dim=1)
    trBinv = torch.sum(W_B * W_B, dim=(1, 2))
    ydoty = torch.sum(ybar * ybar, dim=1)
    val, g_s2 = _value_and_gs2(n, logdetB, s2, sf2, ydoty, atdd, dddd, trA2,
                               trBinv, M_pad)

    Kbar_uu = _kbar_uu(W_u, W_B, Bm, dd, s2)
    # P = I - B^{-1} in the product form B^{-1} S (S = A~A~^T/s2 = Bsum):
    # eigenvalues in [0, 1), no I - W_B W_B^T subtraction
    Pmat = W_B @ (W_B.mT @ Bsum)
    gout = sgpr_stream2(xt, yt, zt, p, W_u, Pmat.contiguous(),
                        dd.contiguous(), kernel, D)

    g_logsf2 = (torch.sum(Kbar_uu * (sf2c * phi_uu * zmm), dim=(1, 2))
                + gout[:, 6] + 0.5 * sf2 * n / s2)
    QF_uu = Kbar_uu * (sf2c * _phi_grad(kernel, r2_uu) * zmm)
    g_logls = torch.stack(
        [scale * _q2_contract(QF_uu, Zs[:, :, j], Zs[:, :, j])
         + gout[:, 1 + j] for j in range(D)], dim=1)
    return _finish(params, val, g_logls, g_logsf2, g_s2, ls, scalar_ls, sf2)


# ---------------------------------------------------------------------------
# mega route: one launch entry from the packed inputs to the output lanes
# ---------------------------------------------------------------------------

def _mega_plain(xt, yt, zt, p, kernel, D, jitter):
    """Plain torch version of csrc/gp_sgpr_vg.cu on the packed inputs: [B, 8]
    lanes 0 = negative ELBO, 1..D = d/dlog ls_j, 6 = d/dlog sf2, 7 = d/ds2."""
    from gpsat_tpu_torch.ops.cuda_cholinv import cholinv_batched_plain
    scale = _KERNELS[kernel]
    Mp = zt.shape[2]
    sf2, s2 = p[:, 5], p[:, 6]
    sf2c = sf2[:, None, None]
    zm = zt[:, 7, :]
    Zs = (zt[:, :D, :] / p[:, :D, None]).transpose(1, 2)
    eyeM = torch.eye(Mp, dtype=xt.dtype, device=xt.device)

    Kuu, r2_uu, phi_uu, zmm = _kuu(Zs, zm, sf2, kernel, jitter)
    W_u, _ = cholinv_batched_plain(Kuu)
    Bsum, at, trA2 = _stream1_plain(xt, yt, zt, p, W_u, kernel, D)
    W_B, logdetB = cholinv_batched_plain(Bsum + eyeM)

    c = (at[:, None, :] @ W_B)[:, 0, :]
    dd = (W_B @ c[:, :, None])[:, :, 0]
    val, g_s2 = _value_and_gs2(
        torch.sum(xt[:, 7, :], dim=1), logdetB, s2, sf2,
        torch.sum(yt * yt, dim=1), torch.sum(at * dd, dim=1),
        torch.sum(dd * dd, dim=1), trA2, torch.sum(W_B * W_B, dim=(1, 2)), Mp)

    Pmat = W_B @ (W_B.mT @ Bsum)
    e = (W_u @ dd[:, :, None])[:, :, 0]
    Kbar_uu = 0.5 * (W_u @ ((Bsum - Pmat) @ W_u.mT)
                     + (e[:, :, None] * e[:, None, :])
                     / (s2 * s2)[:, None, None])
    out = _stream2_plain(xt, yt, zt, p, W_u, Pmat, dd, kernel, D)
    out[:, 0] = val
    QF_uu = Kbar_uu * (sf2c * _phi_grad(kernel, r2_uu) * zmm)
    for j in range(D):
        out[:, 1 + j] += scale * _q2_contract(QF_uu, Zs[:, :, j], Zs[:, :, j])
    out[:, 6] += torch.sum(Kbar_uu * (sf2c * phi_uu * zmm), dim=(1, 2)) \
        + 0.5 * sf2 * torch.sum(xt[:, 7, :], dim=1) / s2
    out[:, 7] = g_s2
    return out


def _mega_launch(xt, yt, zt, p, kernel, D, jitter):
    _check_cuda(xt, yt, zt, p)
    B, _, Np = xt.shape
    Mp = zt.shape[2]
    if not sgpr_vg_supported(kernel, D, None, Mp) or Mp % _GATE_PAD:
        raise ValueError(f"sgpr_vg_mega: kernel={kernel} D={D} M_pad={Mp} is "
                         "outside the CUDA kernels' gate")
    if Np % _PANEL or Np > 4096:
        raise ValueError("sgpr_vg_mega: N must be padded to 128 and at most "
                         "4096")
    dev = xt.device
    out = torch.empty(B, 8, dtype=torch.float32, device=dev)
    if B == 0:
        return out
    G = _item_blocks(B, Np, dev)
    lib = _build.load_library()
    ws = torch.empty(lib.gp_sgpr_vg_ws_floats(B, Np, Mp, G),
                     dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.gp_sgpr_vg_launch(
            xt.data_ptr(), yt.data_ptr(), zt.data_ptr(), p.data_ptr(),
            out.data_ptr(), ws.data_ptr(), B, Np, Mp, D, G, float(jitter),
            _KERNEL_IDS[kernel], stream)
    _build.check(lib, code, "gp_sgpr_vg_launch")
    sgpr_vg_mega.launches += 1
    return out


def sgpr_vg_mega(xt, yt, zt, p, kernel, D, jitter):
    """[B, 8] lanes (0 negative ELBO, 1..D d/dlog ls_j, 6 d/dlog sf2, 7
    d/ds2) of the packed inputs (see _pack_stream). Kernel on CUDA tensors,
    plain version on CPU tensors."""
    if xt.is_cuda:
        return _mega_launch(xt, yt, zt, p, kernel, D, jitter)
    if xt.device.type == "cpu":
        return _mega_plain(xt, yt, zt, p, kernel, D, jitter)
    raise ValueError(f"sgpr_vg_mega: unsupported device {xt.device}")


sgpr_vg_mega.launches = 0


def _sgpr_vg_mega(params, X, y, maskf, Z, zmaskf, kernel, jitter):
    """Pack, one launch, unpack to raw-parameter gradients."""
    X, Z, m, zm, ls, scalar_ls, sf2, s2, ybar = _prepare(
        params, X, y, maskf, Z, zmaskf)
    D = X.shape[2]
    xt, yt, zt, p = _pack_stream(X, m, ybar, Z, zm, ls, sf2, s2)
    out = sgpr_vg_mega(xt, yt, zt, p, kernel, D, jitter)
    return _finish(params, out[:, 0], out[:, 1:1 + D], out[:, 6], out[:, 7],
                   ls, scalar_ls, sf2)


def sgpr_vg_batched(params, X, y, maskf, Z, zmaskf, kernel, jitter,
                    route="hybrid"):
    """Batched SGPR collapsed negative-ELBO value AND gradient.

    params: dict of [B]-leading tensors (lengthscales [B,d] or [B,1],
    kernel_variance [B], likelihood_variance [B]); X [B,N,D]; y [B,N]; maskf
    [B,N] float; Z [B,M,D]; zmaskf [B,M] float. Returns (val [B], grads) in
    f32 with raw-parameter gradients equal to autograd through
    ops/sgpr.neg_elbo at f32 tolerance. `route` picks "hybrid" (default),
    "stream" or "mega" (module docstring).
    """
    if route not in ROUTES:
        raise ValueError(f"sgpr_vg_batched: route must be one of {ROUTES}")
    if not sgpr_vg_supported(kernel, X.shape[2], X.shape[1], Z.shape[1],
                             route):
        raise ValueError(f"sgpr_vg_batched: kernel={kernel} D={X.shape[2]} "
                         f"N={X.shape[1]} M={Z.shape[1]} is outside the "
                         f"gate of route {route!r}")
    fn = {"hybrid": _sgpr_vg_hybrid, "stream": _sgpr_vg_stream,
          "mega": _sgpr_vg_mega}[route]
    with torch.no_grad(), _full_f32_matmul(), tracing.span(
            "sgpr.vg", route=route, experts=int(X.shape[0]),
            n=int(X.shape[1]), m=int(Z.shape[1])):
        return fn(params, X, y, maskf, Z, zmaskf, kernel, float(jitter))


# ---------------------------------------------------------------------------
# posterior prediction
# ---------------------------------------------------------------------------

def sgpr_predict_batched(params, X, y, maskf, Z, zmaskf, Xs, kernel, jitter):
    """Batched SGPR posterior prediction, hybrid style: the factorisations
    run in the fused cholinv kernel, everything else is torch batched
    matmuls. Same outputs as ops/sgpr.predict: 'f*', 'f*_var', 'y_var' (f32).

    A near-singular Kuu (long-lengthscale optima make it near rank 1) can
    defeat an f32 factorisation even though the optimiser's objective stayed
    finite; the failed experts (non-finite log-determinant) are refactored
    once with a relative jitter of 1e-4 * kernel_variance. Whether any expert
    failed is one device-to-host read per call (`tracing.host`); the
    refactorisation runs only then.
    """
    if not sgpr_vg_supported(kernel, X.shape[2], X.shape[1], Z.shape[1]):
        raise ValueError(f"sgpr_predict_batched: kernel={kernel} "
                         f"D={X.shape[2]} M={Z.shape[1]} is outside the "
                         "fused path's gate")
    jitter = float(jitter)
    with torch.no_grad(), _full_f32_matmul(), tracing.span(
            "sgpr.predict", experts=int(X.shape[0]), n=int(X.shape[1]),
            m=int(Z.shape[1]), p=int(Xs.shape[1])):
        X, Z, m, zm, ls, _, sf2, s2, ybar = _prepare(params, X, y, maskf, Z,
                                                     zmaskf)
        Xp = torch.as_tensor(Xs).to(X.device, X.dtype) / ls[:, None, :]
        M_pad = Z.shape[1]
        scale = _KERNELS[kernel]
        Zs = Z / ls[:, None, :]
        Xn = X / ls[:, None, :]
        sf2c = sf2[:, None, None]
        eyeM = torch.eye(M_pad, dtype=X.dtype, device=X.device)

        Kuu, _, _, _ = _kuu(Zs, zm, sf2, kernel, jitter)
        W_u, ld_u = cholinv_batched(Kuu)
        bad = ~torch.isfinite(ld_u)
        if bool(tracing.host(torch.any(bad))):
            extra = torch.where(bad, 1e-4 * sf2 + 100.0 * jitter,
                                torch.zeros_like(sf2))
            W2, _ = cholinv_batched(
                Kuu + torch.diag_embed(zm * extra[:, None]))
            W_u = torch.where(bad[:, None, None], W2, W_u)

        Kuf = sf2c * _phi(kernel, _r2_of(Zs, Xn, scale)) \
            * (zm[:, :, None] * m[:, None, :])
        At = W_u.mT @ Kuf
        Bm = (At @ At.mT) / s2[:, None, None] + eyeM
        W_B, _ = cholinv_batched(Bm)

        # c = LB^{-1} Aerr with Aerr = (A ybar)/sigma = (A~ ybar)/s2
        at = (At @ ybar[:, :, None])[:, :, 0]
        c = (at[:, None, :] @ W_B)[:, 0, :] / s2[:, None]

        Kus = sf2c * _phi(kernel, _r2_of(Zs, Xp, scale)) * zm[:, :, None]
        tmp1 = W_u.mT @ Kus                                    # Lu^-1 Kus
        tmp2 = W_B.mT @ tmp1                                   # LB^-1 tmp1
        mean = (c[:, None, :] @ tmp2)[:, 0, :]
        f_var = torch.clamp_min(
            sf2[:, None] + torch.sum(tmp2 * tmp2, dim=1)
            - torch.sum(tmp1 * tmp1, dim=1), 0.0)
        return {"f*": mean, "f*_var": f_var, "y_var": f_var + s2[:, None]}
