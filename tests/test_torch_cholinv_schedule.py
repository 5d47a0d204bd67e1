"""The launch schedule of csrc/gp_cholinv.cu, replayed tile by tile in f64 on
the CPU and held against the JAX package's cholinv_batched (Pallas, interpret
mode). The CUDA kernels run only on the card; this replay reads and writes
the same tiles of the same buffers in the same launch order (scratch and
output start as NaN, so a tile read before its producer ran shows), which
catches an error in the order of the steps before a card run does."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

T = 64  # CI_T in csrc/gp_cholinv.cu


def _diag(S):
    """Step (a) on [B, T, T] tiles: the kernel's unscaled right-looking
    column loop, then U = S_rc / sqrt(S_rr) and W = U^{-1}. A non-positive
    pivot gives NaN (sqrt) or inf, as on the card. Returns (U, W, log diag)."""
    S = S.clone()
    for c in range(T - 1):
        S[:, c + 1:, c + 1:] -= (S[:, c, c + 1:, None] * S[:, c, None, c + 1:]
                                 / S[:, c, c, None, None])
    piv = torch.sqrt(torch.diagonal(S, dim1=1, dim2=2))
    U = torch.triu(S, 1) / piv[:, :, None] + torch.diag_embed(piv)
    eye = torch.eye(T, dtype=S.dtype).expand_as(U)
    return U, torch.linalg.solve_triangular(U, eye, upper=True).triu(), \
        torch.log(piv).sum(dim=1)


def _y_solve(ws, z, r, k):
    """The diag step's y column: U_kk^T z_k = r_k by forward substitution
    down the 64 rows (r_0 = y_0; later the panels' residual)."""
    cols = slice(k * T, (k + 1) * T)
    v = r[:, cols].clone()
    U = ws[:, cols, cols]
    for i in range(T):
        zi = v[:, i] / U[:, i, i]
        v[:, i] = zi
        v[:, i + 1:] = v[:, i + 1:] - U[:, i, i + 1:] * zi[:, None]
    z[:, cols] = v


def _y_residual(ws, z, r, k, j):
    """The panel (k, j)'s part of the y column: r_j -= U_kj^T z_k, four
    parts over 16 rows each, added in order."""
    kT, cols = k * T, slice(j * T, (j + 1) * T)
    parts = []
    for part in range(4):
        a = torch.zeros(ws.shape[0], T, dtype=ws.dtype)
        for q in range(kT + 16 * part, kT + 16 * part + 16):
            a = a + ws[:, q, cols] * z[:, q, None]
        parts.append(a)
    r[:, cols] = r[:, cols] - (parts[0] + parts[1] + parts[2] + parts[3])


def replay_tiles(tile0, B, M, dtype, border0=None, nb=0, y=None,
                 want_W=True):
    """(W, ld) of B masked SPD M x M matrices by gp_cholinv_launch's
    sequence: for each k diag, panel, update; then the inverse by tile
    offset. Step 0 takes tile (i, j) of A from tile0(i, j) [B, T, T], as the
    step kernels take it from their source (a matrix, or the kernel matrix
    rebuilt from coordinates); later steps read ws. Tile (i, j) of a buffer
    X is X[:, iT:(i+1)T, jT:(j+1)T].

    With y [B, M] or nb > 0, gp_cholinv_kernel_launch's border rides along
    and (W, ld, Z, z) is returned: the diag of step k also solves the y
    column's rows k into z [B, M] (_y_solve) and the panels take them off the
    residual of the rows below (_y_residual), and the border step after it
    forms the nb tiles of row k of Z [B, M, nb T] left-looking, border0(k, j)
    less U_.k^T times Z's rows above k (one full-depth product), solved with
    U_kk. With want_W False the inverse is not formed (W is None)."""
    nt = M // T
    nan = float("nan")
    ws = torch.full((B, M, M), nan, dtype=dtype)
    W = torch.full((B, M, M), nan, dtype=dtype) if want_W else None
    Z = torch.full((B, M, nb * T), nan, dtype=dtype)
    z = torch.full((B, M), nan, dtype=dtype)
    r = None if y is None else y.clone()     # y, then the panels' residual
    ld = torch.full((B,), nan, dtype=dtype)

    def t(i, j):
        return slice(None), slice(i * T, (i + 1) * T), slice(j * T, (j + 1) * T)

    for k in range(nt):
        def src(i, j):
            return tile0(i, j) if k == 0 else ws[t(i, j)]
        Ukk, Wkk, lk = _diag(src(k, k))
        ws[t(k, k)] = Ukk
        if want_W:
            W[t(k, k)] = Wkk
        ld = lk if k == 0 else ld + lk
        if y is not None:
            _y_solve(ws, z, r, k)
        # the border step: one block a tile, the product over Z's final rows
        # above k, then a triangular solve with U_kk from ws
        rows = slice(0, k * T)
        for j in range(nb):
            cols = slice(j * T, (j + 1) * T)
            x = border0(k, j)
            if k > 0:
                x = x - ws[:, rows, k * T:(k + 1) * T].mT @ Z[:, rows, cols]
            Z[t(k, j)] = torch.linalg.solve_triangular(ws[t(k, k)].mT, x,
                                                       upper=False)
        # one block a tile, a triangular solve with U_kk from ws: every block
        # reads before any writes
        panels = {j: torch.linalg.solve_triangular(
            ws[t(k, k)].mT, src(k, j), upper=False) for j in range(k + 1, nt)}
        for j, U in panels.items():
            ws[t(k, j)] = U
            ws[t(j, k)] = U.mT
            if y is not None:
                _y_residual(ws, z, r, k, j)
        updates = {(i, j): src(i, j) - ws[t(k, i)].mT @ ws[t(k, j)]
                   for i in range(k + 1, nt) for j in range(i, nt)}
        for (i, j), v in updates.items():
            ws[t(i, j)] = v
    for d in range(1, nt if want_W else 0):
        out = {}
        for i in range(nt - d):
            j = i + d
            rows = slice((i + 1) * T, (j + 1) * T)
            acc = (ws[:, rows, i * T:(i + 1) * T].mT
                   @ W[:, rows, j * T:(j + 1) * T])
            out[i] = -W[t(i, i)] @ acc
        for i, v in out.items():
            W[t(i, i + d)] = v
            W[t(i + d, i)] = 0.0
    if y is None and not nb:
        return W, ld
    return W, ld, Z, z


def replay(A):
    """(W, ld) of [B, M, M] masked SPD matrices, in A's dtype: step 0 reads
    A, which is never written."""
    B, M, _ = A.shape
    return replay_tiles(
        lambda i, j: A[:, i * T:(i + 1) * T, j * T:(j + 1) * T], B, M,
        A.dtype)


def make_spd(M, m_valid, seed=0):
    rng = np.random.default_rng(seed)
    A = np.zeros((len(m_valid), M, M))
    for b, mv in enumerate(m_valid):
        G = rng.standard_normal((mv, mv))
        A[b, :mv, :mv] = G @ G.T / mv + np.eye(mv) * 0.5
        A[b, range(mv, M), range(mv, M)] = 1.0
    return A


@pytest.mark.parametrize("M", [128, 384])
def test_schedule_matches_jax_interpret(M):
    """W rtol 2e-3 atol 2e-3, ld rtol 1e-4 atol 1e-4 (the tolerances of
    tests/test_pallas_cholinv.py); exact zeros below the diagonal; the input
    is never written."""
    from gpsat_tpu.ops.pallas_cholinv import cholinv_batched as jax_cholinv
    A = make_spd(M, (M, M - 56, M // 2, M - 6, 1), seed=M)
    At = torch.tensor(A)
    W, ld = replay(At)
    assert torch.equal(At, torch.tensor(A))   # the input is never written
    Wj, ldj = jax_cholinv(jnp.asarray(A, jnp.float32), interpret=True)
    np.testing.assert_allclose(W.numpy(), np.asarray(Wj), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ldj), rtol=1e-4,
                               atol=1e-4)
    assert (W.numpy()[:, np.tril(np.ones((M, M)), -1).astype(bool)] == 0).all()


def test_schedule_bad_pivot_in_a_later_tile_column_stays_in_its_matrix():
    """A negative diagonal entry in tile column 2 of matrix 1: its ld is not
    finite, the other matrices come out as they do without it."""
    A = torch.tensor(make_spd(256, (256, 200, 180), seed=3))
    A[1, 150, 150] = -1.0
    W, ld = replay(A)
    assert not torch.isfinite(ld[1])
    Wg, ldg = replay(A[[0, 2]])
    assert torch.isfinite(Wg).all() and torch.isfinite(ldg).all()
    np.testing.assert_allclose(W[[0, 2]].numpy(), Wg.numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(ld[[0, 2]].numpy(), ldg.numpy(), rtol=1e-12)


def test_schedule_in_f32_keeps_a_near_singular_kuu():
    """Kuu of the bench `sgpr` recipe (M=500 padded to 512, jitter 1e-6,
    Matern32) at a point where an f32 sweep stopped (expert 98, lengthscales
    8.11 and 13.09): near singular in f32. Replayed in f32, the schedule
    stays finite, and the trace term of the collapsed bound from its W,
    |W^T Kuf|_F^2 / (2 s2), is within 1 nat of f64 (torch.linalg's f32
    factorisation: 0.13 nats). Panels multiplied by the explicit W_kk, not
    solved with U_kk, break down here: hundreds of nats or NaN."""
    from gpsat_tpu_torch.ops import cuda_sgpr
    from gpsat_tpu_torch.profile_sweep import bench_sgpr_engine, workload
    e, D = 98, 3
    X, y, mask, _ = workload(128, 2000, 1, D)
    Z, zmask = bench_sgpr_engine(D, 500, device="cpu")._build_inducing(
        X, mask)
    prm = {"lengthscales": torch.tensor([[8.109089, 13.092942, 1.0]]),
           "kernel_variance": torch.tensor([0.485842]),
           "likelihood_variance": torch.tensor([0.002596])}
    Xp, Zp, m, zm, ls, _, sf2, s2, ybar = cuda_sgpr._prepare(
        prm, torch.tensor(X[e:e + 1]), torch.tensor(y[e:e + 1]),
        torch.tensor(mask[e:e + 1], dtype=torch.float32),
        torch.tensor(Z[e:e + 1]),
        torch.tensor(zmask[e:e + 1], dtype=torch.float32))
    Kuu = cuda_sgpr._kuu(Zp / ls[:, None, :], zm, sf2, "Matern32", 1e-6)[0]
    xt, _, zt, p = cuda_sgpr._pack_stream(Xp, m, ybar, Zp, zm, ls, sf2, s2)
    Kuf = cuda_sgpr._kuf_at_plain(xt, zt, p, torch.eye(Zp.shape[1])[None],
                                  "Matern32", D)[0].double()
    W, ld = replay(Kuu)
    assert torch.isfinite(W).all() and torch.isfinite(ld).all()
    exact = torch.linalg.solve_triangular(
        torch.linalg.cholesky(Kuu.double()), Kuf, upper=False)
    err = 0.5 * float((W.double().mT @ Kuf).square().sum()
                      - exact.square().sum()) / float(s2)
    assert abs(err) < 1.0, err
