"""The launch schedule of route mega's own kernels in csrc/gp_sgpr_vg.cu (P5,
P6 and the finish), replayed tile by tile in torch on the CPU and held
against the port's plain version (f64) and the JAX package's
_sgpr_vg_kernel (Pallas, interpret mode, f32). The CUDA kernels run only on
the card; this replay reads and writes the same tiles of the same buffers in
the same launch order (scratch starts as NaN, so a tile read before its
producer ran shows): P5's c = a~^T W_B by 64-column tiles, dd = W_B c and
e = W_u dd by 64-row tiles with the tiles' partials, the scalars from those
partials; P6's four products on 64 x 64 tiles (GV_T) with their
triangular depths, T1 and P and T2 over every tile, Kbar_uu's reductions
over the upper tile pairs in their linear order; and gv_finish's
fixed-order sum. The phases before P5 (Kuu, the two factors,
stream1) and stream2 are the plain versions: their own schedules are
replayed by tests/test_torch_{cholinv,stream1}_schedule.py."""

import numpy as np
import pytest
import torch

from gpsat_tpu_torch.ops import cuda_cholinv, cuda_sgpr
from gpsat_tpu_torch.ops.cuda_gpr import _KERNELS, _phi, _phi_grad

from test_torch_sgpr import assert_vg_close, jax_vg, make_case, torch_vg

torch.set_num_threads(1)

VT = 64  # GV_VT: the P5 matvecs' row / column tile
T = 64   # GV_T: the P6 products' output tile


def replay(xt, yt, zt, p, kernel, D, jitter):
    """[B, 8] lanes of packed inputs by gp_sgpr_vg_launch's sequence, in
    xt's dtype."""
    B, _, Np = xt.shape
    Mp = zt.shape[2]
    dt = xt.dtype
    nan = float("nan")
    scale = _KERNELS[kernel]
    sf2, s2 = p[:, 5], p[:, 6]
    zs = zt[:, :D, :] / p[:, :D, None]
    zm = zt[:, 7, :]
    eye = torch.eye(Mp, dtype=dt)

    # P1-P4, the plain versions (looked up at the call: the f64 tests
    # replace the f32 factor)
    factor = cuda_cholinv.cholinv_batched_plain
    Kuu = cuda_sgpr._kuu(zs.transpose(1, 2), zm, sf2, kernel, jitter)[0]
    Wu, _ = factor(Kuu)
    Bs, at, trA2 = cuda_sgpr._stream1_plain(xt, yt, zt, p, Wu, kernel, D)
    Bs = Bs.clone()
    WB, ldB = factor(Bs + eye)

    # P5 (a): c and |W_B|_F^2 by column tile, rows q <= j of each column
    nv = Mp // VT
    c = torch.full((B, Mp), nan, dtype=dt)
    dd = torch.full((B, Mp), nan, dtype=dt)
    ev = torch.full((B, Mp), nan, dtype=dt)
    partS = torch.full((B, nv, 4), nan, dtype=dt)
    for t in range(nv):
        j0, j1 = t * VT, (t + 1) * VT
        w = WB[:, :j1, j0:j1]
        keep = torch.arange(j1)[:, None] <= torch.arange(j0, j1)[None, :]
        c[:, j0:j1] = (at[:, :j1, None] * w * keep).sum(dim=1)
        partS[:, t, 0] = (w * w * keep).sum(dim=(1, 2))

    # P5 (b), (c): out_i = sum_{q >= i} W[i][q] v_q by row tile
    def upper_matvec(W, v, out):
        for t in range(nv):
            i0, i1 = t * VT, (t + 1) * VT
            keep = torch.arange(i0, i1)[:, None] <= torch.arange(i0, Mp)[None]
            out[:, i0:i1] = (W[:, i0:i1, i0:] * keep * v[:, None, i0:]).sum(2)
    upper_matvec(WB, c, dd)
    for t in range(nv):
        rows = slice(t * VT, (t + 1) * VT)
        partS[:, t, 1] = (at[:, rows] * dd[:, rows]).sum(dim=1)
        partS[:, t, 2] = (dd[:, rows] * dd[:, rows]).sum(dim=1)
    upper_matvec(Wu, dd, ev)

    # P5 (d): the scalars from vectors and the tiles' partials, in order
    sums = partS[:, 0, :3]
    for t in range(1, nv):
        sums = sums + partS[:, t, :3]
    val, g_s2 = cuda_sgpr._value_and_gs2(
        xt[:, 7].sum(dim=1), ldB, s2, sf2, (yt * yt).sum(dim=1), sums[:, 1],
        sums[:, 2], trA2, sums[:, 0], Mp)

    # P6 on 64-tiles, each launch over the grid (B, nt, nt) with the depth
    # rank z slowest
    nt = Mp // T
    A0 = torch.full((B, Mp, Mp), nan, dtype=dt)     # T1, then T2
    Pm = torch.full((B, Mp, Mp), nan, dtype=dt)
    for z in range(nt):                              # T1, depth iT + T
        iT = (nt - 1 - z) * T
        for y in range(nt):
            jT = y * T
            A0[:, iT:iT + T, jT:jT + T] = (
                WB[:, :iT + T, iT:iT + T].mT @ Bs[:, :iT + T, jT:jT + T])
    for z in range(nt):                              # P, depth Mp - iT
        iT = z * T
        for y in range(nt):
            jT = y * T
            tile = WB[:, iT:iT + T, iT:] @ A0[:, iT:, jT:jT + T]
            Pm[:, iT:iT + T, jT:jT + T] = tile
            Bs[:, iT:iT + T, jT:jT + T] -= tile      # C = Bsum - P
    A0.fill_(nan)
    for z in range(nt):                              # T2, depth Mp - jT
        jT = z * T
        for y in range(nt):
            iT = y * T
            A0[:, iT:iT + T, jT:jT + T] = (
                Bs[:, iT:iT + T, jT:] @ Wu[:, jT:jT + T, jT:].mT)
    pairs = [(i, j) for i in range(nt) for j in range(i, nt)]
    partU = torch.full((B, len(pairs), 8), nan, dtype=dt)
    for t, (i, j) in enumerate(pairs):               # Kbar_uu, depth Mp - iT
        iT, jT = i * T, j * T
        rows, cols = slice(iT, iT + T), slice(jT, jT + T)
        kbar = 0.5 * (Wu[:, rows, iT:] @ A0[:, iT:, cols]
                      + ev[:, rows, None] * ev[:, None, cols]
                      / (s2 * s2)[:, None, None])
        q2 = [(zs[:, d, rows, None] - zs[:, d, None, cols]) ** 2 * scale
              for d in range(D)]
        r2 = q2[0]
        for q in q2[1:]:
            r2 = r2 + q
        mm = zm[:, rows, None] * zm[:, None, cols]
        wsym = 1.0 if i == j else 2.0
        qf = kbar * (sf2[:, None, None] * _phi_grad(kernel, r2) * mm)
        partU[:, t, 0] = partU[:, t, 7] = 0.0
        for d in range(5):
            partU[:, t, 1 + d] = (wsym * (qf * q2[d]).sum(dim=(1, 2))
                                  if d < D else 0.0)
        partU[:, t, 6] = wsym * (kbar * (sf2[:, None, None]
                                         * _phi(kernel, r2) * mm)).sum((1, 2))

    # P7 (the plain version) and gv_finish: the pairs' partials in order
    gout = cuda_sgpr._stream2_plain(xt, yt, zt, p, Wu, Pm, dd, kernel, D)
    out = torch.full((B, 8), nan, dtype=dt)
    out[:, 0], out[:, 7] = val, g_s2
    for lane in range(1, 7):
        s = partU[:, 0, lane]
        for t in range(1, len(pairs)):
            s = s + partU[:, t, lane]
        s = s + gout[:, lane]
        if lane == 6:
            s = s + 0.5 * sf2 * xt[:, 7].sum(dim=1) / s2
        out[:, lane] = s
    return out


def factor_f64(A):
    """cuda_cholinv.cholinv_batched_plain in A's dtype (the plain version
    factors in f32, the card's type): (W = U^{-1}, ld), NaN where A is not
    positive definite."""
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.where((info != 0)[:, None, None], torch.full_like(L, torch.nan),
                    L)
    eye = torch.eye(A.shape[1], dtype=A.dtype).expand_as(A)
    W = torch.linalg.solve_triangular(L.mT, eye, upper=True).triu()
    return W, torch.log(torch.diagonal(L, dim1=1, dim2=2)).sum(dim=1)


def packed(B, N, M, D=3, seed=0, dtype=torch.float64):
    """Packed inputs (cuda_sgpr._pack_stream: N and M padded to 128) of the
    recipe of tests/test_pallas_sgpr.py (test_torch_sgpr.make_case)."""
    X, y, mask, Z, zmask, params = make_case(B=B, N=N, M=M, D=D, seed=seed)
    Xp, Zp, m, zm, ls, _, sf2, s2, ybar = cuda_sgpr._prepare(
        {k: torch.tensor(v) for k, v in params.items()},
        *(torch.tensor(np.asarray(a, float)) for a in (X, y, mask, Z, zmask)))
    return [a.to(dtype) for a in cuda_sgpr._pack_stream(
        Xp, m, ybar, Zp, zm, ls, sf2, s2)]


@pytest.mark.parametrize("kernel,M", [
    ("Matern32", 200), ("Matern32", 300), ("Matern12", 100),
    ("Matern52", 100), ("RBF", 100), ("Exponential", 100),
    ("Matern32", 100), ("Matern32", 700)])
def test_schedule_matches_plain_in_f64(monkeypatch, kernel, M):
    """f64 replay against _mega_plain in f64 (both factor in f64): rtol
    1e-10, atol 1e-10 of the largest lane. Mp = 128 (nt = 2, three upper
    pairs), 256 (ten pairs), 384 and 768 (M = 700 with at most 320 valid
    inducing points, the rest masked)."""
    monkeypatch.setattr(cuda_cholinv, "cholinv_batched_plain", factor_f64)
    D, jitter = 3, 1e-6
    xt, yt, zt, p = packed(3, 320, M, D, seed=M)
    got = replay(xt, yt, zt, p, kernel, D, jitter)
    want = cuda_sgpr._mega_plain(xt, yt, zt, p, kernel, D, jitter)
    assert torch.isfinite(got).all()
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10,
                               atol=1e-10 * scale)
    assert (got[:, 1 + D:6] == 0).all()


def test_schedule_in_f32_matches_plain_at_the_card_tolerances():
    """The f32 replay against _mega_plain in f32 on the same plain f32
    factor (Mp = 384), at the tolerances the card's test_mega_kernel_
    matches_plain holds the kernel to: value rtol 2e-4 atol 1e-3, gradient
    lanes rtol 5e-3 atol 5e-3 of the largest lane. Only the order of P5's
    and P6's sums differs."""
    D = 3
    xt, yt, zt, p = packed(2, 320, 300, D, seed=7, dtype=torch.float32)
    got = replay(xt, yt, zt, p, "Matern32", D, 1e-6)
    want = cuda_sgpr._mega_plain(xt, yt, zt, p, "Matern32", D, 1e-6)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got[:, 0].numpy(), want[:, 0].numpy(),
                               rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(got[:, 1:].numpy(), want[:, 1:].numpy(),
                               rtol=5e-3,
                               atol=5e-3 * float(want[:, 1:].abs().max()))


@pytest.mark.parametrize("M", [200, 300])
def test_schedule_in_f32_matches_jax_interpret(monkeypatch, M):
    """The f32 replay in place of sgpr_vg_mega under
    sgpr_vg_batched(route="mega") against the JAX package's monolithic
    _sgpr_vg_kernel in interpret mode (selected by its environment switch,
    as tests/test_torch_sgpr_mega.py does): value rtol 2e-4 atol 1e-3,
    gradients rtol 5e-3 atol 5e-3 (tests/test_pallas_sgpr.py). Mp = 256 and
    384."""
    monkeypatch.setenv("GPSAT_SGPR_MEGAKERNEL", "1")
    monkeypatch.setattr(
        cuda_sgpr, "sgpr_vg_mega",
        lambda xt, yt, zt, p, kernel, D, jitter: replay(xt, yt, zt, p, kernel,
                                                        D, jitter))
    X, y, mask, Z, zmask, params = make_case(B=2, N=320, M=M, D=2, seed=M)
    got = torch_vg("mega", params, X, y, mask, Z, zmask, "Matern32")
    assert_vg_close(got, jax_vg(params, X, y, mask, Z, zmask, "Matern32"))


def test_non_pd_expert_gives_nan_in_its_own_lanes_only(monkeypatch):
    """A negative noise makes expert 1's B = I + Bsum indefinite: its lanes
    are NaN, every other expert's are those of the replay without it, bit
    for bit (no tile of one expert reads another's)."""
    monkeypatch.setattr(cuda_cholinv, "cholinv_batched_plain", factor_f64)
    D = 3
    xt, yt, zt, p = packed(3, 320, 200, D, seed=3)
    p[1, 6] = -0.05
    got = replay(xt, yt, zt, p, "Matern32", D, 1e-6)
    assert torch.isnan(got[1, [0, 1, 2, 3, 6, 7]]).all()
    keep = [0, 2]
    assert torch.equal(got[keep], replay(xt[keep], yt[keep], zt[keep],
                                         p[keep], "Matern32", D, 1e-6))
    assert torch.isfinite(got[keep]).all()

