"""The launch schedule of csrc/gp_vg.cu, replayed tile by tile in torch on the
CPU and held against the port's plain version (f64) and the JAX package's
_vg_kernel (Pallas, interpret mode, f32). The CUDA kernels run only on the
card; this replay reads and writes the same tiles of the same buffers in the
same launch order (scratch starts as NaN, so a tile read before its producer
ran shows): the scale pass, cholinv's schedule with step 0 rebuilding the
tiles of K from the scaled coordinates and y riding in its border (t1 =
U^{-T} y, solved by the diag steps), alpha = W t1 by row tile, the gradient
items over the upper
64 x 64 tile pairs, and the fixed-order sums of the value (gp_nlml_warp,
shared with the value kernel) and of the items' partial lanes."""

import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gpsat_tpu_torch.ops import cuda_gpr
from gpsat_tpu_torch.ops.cuda_gpr import _KERNELS, _phi, _phi_grad
from test_torch_cholinv_schedule import replay_tiles

torch.set_num_threads(1)

T = 64  # GV_T in csrc/gp_vg.cu (CI_T of gp_cholinv.cu)
KERNELS = ["Matern32", "Matern12", "Matern52", "RBF", "Exponential"]


def scale(xt, yt, p, D, M):
    """gp_gpr_scale_kernel: xs = x / ls in rows 0..D-1, y in row 6, the mask
    in row 7, zero past Nx (rows D..5 are never written, and never read);
    yt None gives zeros in row 6."""
    B, _, Nx = xt.shape
    xs = torch.full((B, 8, M), float("nan"), dtype=xt.dtype)
    xs[:, list(range(D)) + [6, 7], Nx:] = 0.0
    xs[:, :D, :Nx] = xt[:, :D] / p[:, :D, None]
    xs[:, 6, :Nx] = 0.0 if yt is None else yt
    xs[:, 7, :Nx] = xt[:, 7]
    return xs


def q2_r2(xa, xb, kernel, D):
    """Per-dimension scaled squared distances and their sum between the
    columns of xa [B, 8, R] and xb [B, 8, C], summed over d in order."""
    scale_ = _KERNELS[kernel]
    q2 = [(xa[:, d, :, None] - xb[:, d, None, :]) ** 2 * scale_
          for d in range(D)]
    r2 = q2[0]
    for q in q2[1:]:
        r2 = r2 + q
    return q2, r2


def kernel_tiles(xs, p, kernel, D):
    """CiKernel: tile (i, j) of the masked noisy K where step 0 reads it."""
    def ktile(i, j):
        rows, cols = slice(i * T, (i + 1) * T), slice(j * T, (j + 1) * T)
        _, r2 = q2_r2(xs[:, :, rows], xs[:, :, cols], kernel, D)
        mr, mc = xs[:, 7, rows], xs[:, 7, cols]
        v = p[:, 5, None, None] * _phi(kernel, r2) * (mr[:, :, None]
                                                      * mc[:, None, :])
        if i == j:
            v = v + torch.diag_embed(mr * (p[:, 6, None] - 1.0) + 1.0)
        return v
    return ktile


def border_tiles(xs, xp, p, kernel, D):
    """CiBorderKernel: tile (i, j) of K*_rc = sf2 phi(x_r, xp_c) m_r, xp
    [B, 8, Pk], where the border step reads it."""
    def btile(i, j):
        rows, cols = slice(i * T, (i + 1) * T), slice(j * T, (j + 1) * T)
        _, r2 = q2_r2(xs[:, :, rows], xp[:, :, cols], kernel, D)
        return p[:, 5, None, None] * _phi(kernel, r2) * xs[:, 7, rows, None]
    return btile


def nlml_warp(z, m, ld):
    """gp_nlml_warp: lane l sums z_r^2 and m_r over rows l, l + 32, ... in
    order, then a butterfly over the 32 lanes; 0.5 q + ld + 0.5 n log 2 pi."""
    B, M = z.shape
    q = torch.zeros(B, 32, dtype=z.dtype)
    n = torch.zeros(B, 32, dtype=z.dtype)
    for r in range(M):
        q[:, r % 32] = q[:, r % 32] + z[:, r] * z[:, r]
        n[:, r % 32] = n[:, r % 32] + m[:, r]
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        q = q + q[:, lanes ^ o]
        n = n + n[:, lanes ^ o]
    return 0.5 * q[:, 0] + ld + 0.5 * n[:, 0] * math.log(2.0 * math.pi)


def replay(xt, yt, p, kernel, D):
    """[B, 8] lanes of packed inputs (xt [B, 8, Nx], Nx a multiple of 32)
    by gp_vg_launch's sequence, in xt's dtype."""
    B, _, Nx = xt.shape
    M = -(-Nx // T) * T
    nt = M // T
    dt = xt.dtype
    nan = float("nan")

    xs = scale(xt, yt, p, D, M)
    W, ld, _, t1 = replay_tiles(kernel_tiles(xs, p, kernel, D), B, M, dt,
                                y=xs[:, 6])

    # alpha = W t1 by row tile
    alpha = torch.full((B, M), nan, dtype=dt)
    for i in range(nt):
        rows = slice(i * T, (i + 1) * T)
        alpha[:, rows] = (W[:, rows, i * T:] @ t1[:, i * T:, None])[:, :, 0]

    # gradient items: upper tile pairs in row order, seven lanes each
    pairs = [(i, j) for i in range(nt) for j in range(i, nt)]
    part = torch.full((B, len(pairs), 8), nan, dtype=dt)
    sf2 = p[:, 5, None, None]
    for t, (i, j) in enumerate(pairs):
        rows, cols = slice(i * T, (i + 1) * T), slice(j * T, (j + 1) * T)
        kinv = W[:, rows, j * T:] @ W[:, cols, j * T:].mT
        qp = kinv - alpha[:, rows, None] * alpha[:, None, cols]
        q2, r2 = q2_r2(xs[:, :, rows], xs[:, :, cols], kernel, D)
        mr = xs[:, 7, rows]
        mm = mr[:, :, None] * xs[:, 7, None, cols]
        wsym = 0.5 if i == j else 1.0
        qf = qp * (sf2 * _phi_grad(kernel, r2) * mm)
        part[:, t, 0] = 0.0
        for d in range(5):
            part[:, t, 1 + d] = (wsym * (qf * q2[d]).sum(dim=(1, 2)) if d < D
                                 else 0.0)
        part[:, t, 6] = wsym * (qp * (sf2 * _phi(kernel, r2) * mm)).sum(
            dim=(1, 2))
        part[:, t, 7] = (0.5 * (torch.diagonal(qp, dim1=1, dim2=2)
                                * mr).sum(dim=1) if i == j else 0.0)
    # finish: the value by gp_nlml_warp, the lanes from the items' partials,
    # each added in order
    out = torch.full((B, 8), nan, dtype=dt)
    out[:, 0] = nlml_warp(t1, xs[:, 7], ld)
    for l in range(1, 8):
        s = part[:, 0, l]
        for t in range(1, len(pairs)):
            s = s + part[:, t, l]
        out[:, l] = s
    return out


def packed(B, N, D=3, seed=0, noise=(0.01, 0.2), dtype=torch.float64):
    """Packed inputs (cuda_gpr._pack, N padded to 32): ragged masks, one
    nearly empty expert."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-4, 4, (B, N, D))
    y = rng.standard_normal((B, N))
    mask = np.ones((B, N))
    mask[0, N * 4 // 5:] = 0.0
    mask[-1, min(N, 10):] = 0.0
    params = {"lengthscales": torch.tensor(rng.uniform(0.5, 3, (B, D))),
              "kernel_variance": torch.tensor(rng.uniform(0.5, 2, B)),
              "likelihood_variance": torch.tensor(rng.uniform(*noise, B))}
    xt, yt, p, _, _ = cuda_gpr._pack(params, torch.tensor(X),
                                     torch.tensor(y), torch.tensor(mask),
                                     1e-6)
    return xt.to(dtype), yt.to(dtype), p.to(dtype)


def assert_lanes(got, want, D, rtol, atol, vrtol=None, vatol=None):
    got, want = got.numpy(), want.numpy()
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=vrtol or rtol,
                               atol=vatol or atol, err_msg="value")
    lanes = [*range(1, 1 + D), 6, 7]
    np.testing.assert_allclose(got[:, lanes], want[:, lanes], rtol=rtol,
                               atol=atol, err_msg="gradient lanes")


@pytest.mark.parametrize("kernel,N", [(k, 50) for k in KERNELS]
                         + [("Matern32", 400)])
def test_schedule_matches_plain_in_f64(kernel, N):
    """f64 replay against _vg_lanes_plain in f64 (torch.linalg): rtol 1e-10,
    atol 1e-10 of the largest lane. N=50 runs on one 64-tile (xt 64 wide),
    N=400 on seven (xt 416 wide, padded to 448 by the launch)."""
    xt, yt, p = packed(4, N, seed=N)
    got = replay(xt, yt, p, kernel, 3)
    want = cuda_gpr._vg_lanes_plain(xt, yt, p, kernel, 3)
    scale = float(want[:, [0, 1, 2, 3, 6, 7]].abs().max())
    assert_lanes(got, want, 3, 1e-10, 1e-10 * scale)
    assert (got[:, 4:6] == 0).all()


@pytest.mark.parametrize("kernel,N", [("Matern32", 50), ("RBF", 50),
                                      ("Matern32", 400)])
def test_schedule_in_f32_matches_jax_interpret(kernel, N):
    """f32 replay against pallas_gpr._nlml_vg_call in interpret mode (its
    inputs padded to 128 columns and to its expert group with the JAX
    wrapper's dummy experts): value rtol 2e-5 atol 1e-3, gradient lanes
    rtol 2e-3 atol 2e-3 (tests/test_pallas_gpr.py)."""
    from gpsat_tpu.ops import pallas_gpr
    B, D = 4, 3
    xt, yt, p = packed(B, N, D, seed=N + 1, dtype=torch.float32)
    got = replay(xt, yt, p, kernel, D)
    Np = -(-xt.shape[2] // 128) * 128
    bt = pallas_gpr._vg_group_size(Np)
    jx = np.zeros((bt, 8, Np), np.float32)
    jy = np.zeros((bt, Np), np.float32)
    jp = np.zeros((bt, 8), np.float32)
    jp[B:, :D] = jp[B:, 5] = jp[B:, 6] = 1.0
    jx[:B, :, :xt.shape[2]] = xt.numpy()
    jy[:B, :yt.shape[1]] = yt.numpy()
    jp[:B] = p.numpy()
    want = np.asarray(pallas_gpr._nlml_vg_call(
        jnp.asarray(jx), jnp.asarray(jy), jnp.asarray(jp), kernel=kernel,
        d=D, interpret=True))[:B, :8]
    assert_lanes(got, torch.tensor(want), D, 2e-3, 2e-3, 2e-5, 1e-3)


def test_non_pd_expert_gives_nan_in_its_own_lanes_only():
    """A negative noise makes expert 1's matrix indefinite: its value and
    gradient lanes are NaN, every other expert's lanes are those of the
    replay without it, bit for bit."""
    xt, yt, p = packed(4, 150, seed=7)
    p[1, 6] = -5.0
    got = replay(xt, yt, p, "Matern32", 3)
    assert torch.isnan(got[1, [0, 1, 2, 3, 6, 7]]).all()
    keep = [0, 2, 3]
    assert torch.equal(got[keep], replay(xt[keep], yt[keep], p[keep],
                                         "Matern32", 3))
    assert torch.isfinite(got[keep]).all()


def test_schedule_in_f32_stays_finite_at_a_small_noise():
    """noise 1e-6 on the bench `gpr` recipe (N=400, Matern32): K is near
    singular in f32. Where the f64 replay is finite, the f32 replay of the
    schedule is too, and its value is within 1e-2 relative of f64."""
    from gpsat_tpu_torch.profile_sweep import workload
    B, D = 4, 3
    X, y, mask, _ = workload(B, 400, 1, D, seed=3)
    rng = np.random.default_rng(5)
    params = {"lengthscales": torch.tensor(rng.uniform(0.5, 2.0, (B, D))),
              "kernel_variance": torch.tensor(rng.uniform(0.05, 0.5, B)),
              "likelihood_variance": torch.full((B,), 1e-6,
                                                dtype=torch.float64)}
    xt, yt, p, _, _ = cuda_gpr._pack(params, torch.tensor(X),
                                     torch.tensor(y),
                                     torch.tensor(mask, dtype=torch.float64),
                                     0.0)
    ref = replay(xt, yt, p, "Matern32", D)
    got = replay(xt.float(), yt.float(), p.float(), "Matern32", D)
    fin = torch.isfinite(ref).all(dim=1)
    assert fin.any()
    assert torch.isfinite(got[fin]).all()
    np.testing.assert_allclose(got[fin, 0].numpy(), ref[fin, 0].numpy(),
                               rtol=1e-2)
