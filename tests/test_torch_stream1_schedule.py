"""The launch schedule of stream1 in csrc/gp_sgpr_stream.cu, replayed tile by
tile in torch on the CPU and held against the port's plain version (f64) and
the JAX package's _sgpr_stream1_kernel (Pallas, interpret mode, f32). The
CUDA kernels run only on the card; this replay reads and writes the same
tiles of the same buffers in the same launch order, slab by slab (scratch
and outputs start as NaN, and a slab's scratch is NaN again before it is
filled, so a tile read before its producer ran shows): the build items
(expert, panel) taken by G blocks in turn, the full-depth gram items over
the upper 128 x 128 tile pairs, and the fixed-order reduce of a~ and
|A~|_F^2."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gpsat_tpu_torch.ops import cuda_cholinv, cuda_sgpr
from gpsat_tpu_torch.ops.cuda_gpr import _KERNELS, _phi

torch.set_num_threads(1)

PW = 128   # GS_PW: a panel's data columns
T = 128    # GS2_T: the products' output tile edge
KERNELS = ["Matern32", "Matern12", "Matern52", "RBF", "Exponential"]


def replay(xt, yt, zt, p, wu, kernel, D, Ns, G=3):
    """(Bsum, a~, trA2) of packed inputs by gp_sgpr_stream1_launch's
    sequence with slab width Ns and a build grid of G blocks, in xt's
    dtype."""
    B, _, Np = xt.shape
    Mp = zt.shape[2]
    dt = xt.dtype
    nan = float("nan")
    scale = _KERNELS[kernel]
    nt = Mp // T
    Bsum = torch.full((B, Mp, Mp), nan, dtype=dt)
    at = torch.full((B, Mp), nan, dtype=dt)
    trA2 = torch.full((B,), nan, dtype=dt)
    slab = torch.empty(B, Ns, Mp, dtype=dt)
    zs = zt[:, :D, :] / p[:, :D, None]
    zm = zt[:, 7, :]
    for n0 in range(0, Np, Ns):
        K = min(Ns, Np - n0)
        nps, first = K // PW, n0 == 0
        slab.fill_(nan)
        partA = torch.full((B, nps, Mp), nan, dtype=dt)
        partT = torch.full((B, nps), nan, dtype=dt)
        # (a) build: block b takes items b, b + G, ...
        for b in range(G):
            for w in range(b, B * nps, G):
                e, j = divmod(w, nps)
                cols = slice(n0 + j * PW, n0 + (j + 1) * PW)
                xs = xt[e, :D, cols] / p[e, :D, None]
                r2 = sum((zs[e, d, :, None] - xs[d, None, :]) ** 2
                         for d in range(D))
                kuf = p[e, 5] * _phi(kernel, r2 * scale) * (
                    zm[e, :, None] * xt[e, 7, None, cols])
                tr = 0.0
                for iT in range(0, Mp, T):
                    # A~ tile: W_u rows below iT + T are zero in its columns
                    acc = wu[e, :iT + T, iT:iT + T].mT @ kuf[:iT + T]
                    partA[e, j, iT:iT + T] = acc @ yt[e, cols]
                    tr = tr + (acc * acc).sum()
                    slab[e, j * PW:(j + 1) * PW, iT:iT + T] = acc.mT
                partT[e, j] = tr
        # (b) gram: item (t, e), the t-th upper tile pair in row order
        for e in range(B):
            inv_s2 = 1.0 / p[e, 6]
            for i in range(nt):
                for j in range(i, nt):
                    r, c = slice(i * T, (i + 1) * T), slice(j * T, (j + 1) * T)
                    v = (slab[e, :K, r].mT @ slab[e, :K, c]) * inv_s2
                    if not first:
                        v = v + Bsum[e, r, c]
                    Bsum[e, r, c] = v
                    if i != j:
                        Bsum[e, c, r] = v.mT
        # (c) reduce, in order, onto the earlier slabs' sums
        a = torch.zeros(B, Mp, dtype=dt) if first else at.clone()
        s = torch.zeros(B, dtype=dt) if first else trA2.clone()
        for j in range(nps):
            a = a + partA[:, j]
            s = s + partT[:, j]
        at, trA2 = a, s
    return Bsum, at, trA2


def packed(B, N, M, D=3, seed=0, dtype=torch.float64):
    """Packed inputs (cuda_sgpr._pack_stream: N padded to 128, M to 128) and
    W_u of Kuu by torch.linalg: ragged data masks, prefix inducing masks,
    inducing points drawn in the data's box, one expert with few valid
    points."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, (B, N, D))
    y = np.sin(X[..., 0]) + 0.1 * rng.standard_normal((B, N))
    mask = np.ones((B, N))
    for b in range(B):
        mask[b, N - rng.integers(0, N // 3 + 1):] = 0.0
    mask[-1, min(N, 40):] = 0.0
    Z = rng.uniform(-3, 3, (B, M, D))
    zmask = np.ones((B, M))
    zmask[1, M - M // 4:] = 0.0
    params = {"lengthscales": torch.tensor(rng.uniform(0.4, 1.2, (B, D))),
              "kernel_variance": torch.tensor(rng.uniform(0.5, 2.0, B)),
              "likelihood_variance": torch.tensor(rng.uniform(0.05, 0.3, B))}
    Xp, Zp, m, zm, ls, _, sf2, s2, ybar = cuda_sgpr._prepare(
        params, *(torch.tensor(a) for a in (X, y, mask, Z, zmask)))
    args = [a.double() for a in (Xp, m, ybar, Zp, zm, ls, sf2, s2)]
    Kuu = cuda_sgpr._kuu(args[3] / args[5][:, None, :], args[4], args[6],
                         "Matern32", 1e-6)[0]
    W_u, ld = cuda_cholinv.cholinv_batched_plain(Kuu.to(dtype))
    assert torch.isfinite(ld).all()
    xt, yt, zt, p = cuda_sgpr._pack_stream(*args)
    return [a.to(dtype) for a in (xt, yt, zt, p)], W_u.to(dtype)


def close(got, want, rtol, rel_atol=None, atol=None):
    for a, b, name in zip(got, want, ("Bsum", "a~", "trA2")):
        b = np.asarray(b)
        np.testing.assert_allclose(
            np.asarray(a), b, rtol=rtol,
            atol=atol if atol is not None else rel_atol * np.abs(b).max(),
            err_msg=name)


@pytest.mark.parametrize("kernel,N,M", [
    ("Matern32", 100, 100), ("Matern32", 450, 100), ("Matern32", 100, 400),
    ("Matern32", 450, 400), ("Matern12", 450, 100), ("Matern52", 450, 100),
    ("RBF", 450, 100), ("Exponential", 450, 100)])
def test_schedule_matches_plain_in_f64(kernel, N, M):
    """f64 replay in one slab against _stream1_plain in f64: rtol 1e-10,
    atol 1e-10 of the largest entry. Mp in {128, 512}, Np in {128, 512}
    (N=100, 450; M=100, 400)."""
    (xt, yt, zt, p), wu = packed(3, N, M, seed=N + M)
    got = replay(xt, yt, zt, p, wu, kernel, 3, Ns=xt.shape[2])
    want = cuda_sgpr._stream1_plain(xt, yt, zt, p, wu, kernel, 3)
    close(got, want, 1e-10, rel_atol=1e-10)
    assert torch.equal(got[0], got[0].mT)


def test_schedule_in_several_slabs_matches_plain_in_f64():
    """Np = 640 (N=600) in slabs of 256 columns (256, 256, 128: the last
    narrower), Mp = 256, against _stream1_plain in f64 at rtol 1e-10, atol
    1e-10 of the largest entry; the build grid's width G changes nothing."""
    (xt, yt, zt, p), wu = packed(3, 600, 200, seed=11)
    got = replay(xt, yt, zt, p, wu, "Matern32", 3, Ns=256, G=2)
    want = cuda_sgpr._stream1_plain(xt, yt, zt, p, wu, "Matern32", 3)
    close(got, want, 1e-10, rel_atol=1e-10)
    again = replay(xt, yt, zt, p, wu, "Matern32", 3, Ns=256, G=5)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("N,M,Ns", [(100, 100, 128), (450, 400, 512),
                                    (450, 100, 256)])
def test_schedule_in_f32_matches_jax_interpret(N, M, Ns):
    """f32 replay against pallas_sgpr._sgpr_stream1_call in interpret mode
    on the same f32 inputs and W_u (B = 8, the JAX expert group): rtol 1e-2,
    atol 1e-2 (PERF.md section 2's stream lanes). The last case runs in two
    slabs."""
    from gpsat_tpu.ops.pallas_sgpr import _sgpr_stream1_call
    (xt, yt, zt, p), wu = packed(8, N, M, seed=N + 2 * M,
                                 dtype=torch.float32)
    got = replay(xt, yt, zt, p, wu, "Matern32", 3, Ns=Ns)
    want = _sgpr_stream1_call(*(jnp.asarray(a.numpy())
                                for a in (xt, yt, zt, p, wu)),
                              kernel="Matern32", d=3, interpret=True)
    close(got, want, 1e-2, atol=1e-2)


def test_non_pd_expert_gives_nan_in_its_own_outputs_only():
    """Expert 1's W_u is NaN (its Kuu failed to factor): its Bsum, a~ and
    trA2 are NaN, every other expert's are those of the replay without it,
    bit for bit."""
    (xt, yt, zt, p), wu = packed(3, 300, 100, seed=4)
    wu = wu.clone()
    wu[1] = float("nan")
    got = replay(xt, yt, zt, p, wu, "Matern32", 3, Ns=256)
    assert torch.isnan(got[0][1]).all() and torch.isnan(got[1][1]).all()
    assert torch.isnan(got[2][1])
    keep = [0, 2]
    ref = replay(xt[keep], yt[keep], zt[keep], p[keep], wu[keep], "Matern32",
                 3, Ns=256)
    for a, b in zip(got, ref):
        assert torch.equal(a[keep], b)
