"""The launch schedules of csrc/gp_predict.cu and csrc/gp_value.cu, replayed
tile by tile in torch on the CPU: cholinv's schedule with a border, the
factor of the masked noisy K (rebuilt from the scaled coordinates where step
0 reads it) carrying y (solved by each step's diag launch) and, for
prediction, K* as tile columns to the right of it (solved row by row by
each step's border launch), with no W = U^{-1}; then the fixed-order
finish. The
CUDA kernels run only on the card; this replay reads and writes the same
tiles of the same buffers in the same launch order (scratch starts as NaN,
so a tile read before its producer ran shows). Held against the port's plain
versions in f64 and against the JAX package's _predict_kernel and
_value_kernel (Pallas, interpret mode) in f32, at the tolerances of
tests/test_pallas_gpr.py."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gpsat_tpu.ops import pallas_gpr
from gpsat_tpu_torch.ops import cuda_gpr
from test_torch_cholinv_schedule import replay_tiles
from test_torch_vg_schedule import (KERNELS, T, border_tiles, kernel_tiles,
                                    nlml_warp, scale)
from test_torch_vg_schedule import replay as replay_vg

torch.set_num_threads(1)


def _pad64(n):
    return -(-n // T) * T


def factor(xt, yt, p, xsp, kernel, D):
    """(xs, ld, Z, z) of gp_cholinv_kernel_launch as gp_predict_launch (xsp
    [B, 8, Pp]) or gp_value_launch (xsp None) runs it: the scale passes,
    then the bordered schedule without W."""
    B, _, Nx = xt.shape
    M = _pad64(Nx)
    xs = scale(xt, yt, p, D, M)
    xp = None if xsp is None else scale(xsp, None, p, D,
                                        _pad64(xsp.shape[2]))
    W, ld, Z, z = replay_tiles(
        kernel_tiles(xs, p, kernel, D), B, M, xt.dtype,
        border0=None if xp is None else border_tiles(xs, xp, p, kernel, D),
        nb=0 if xp is None else xp.shape[2] // T, y=xs[:, 6], want_W=False)
    assert W is None
    return xs, ld, Z, z


def replay_value(xt, yt, p, kernel, D):
    """[B] NLML values of packed inputs by gp_value_launch's sequence."""
    xs, ld, _, z = factor(xt, yt, p, None, kernel, D)
    return nlml_warp(z, xs[:, 7], ld)


def kahan(terms):
    """gq_kahan's compensated running sum over a list of tensors."""
    s = torch.zeros_like(terms[0])
    c = torch.zeros_like(s)
    for v in terms:
        y_ = v - c
        t = s + y_
        c = (t - s) - y_
        s = t
    return s


def replay_predict(xt, yt, p, xsp, kernel, D):
    """(mean, var) [B, Pp] of packed inputs by gp_predict_launch's sequence:
    the finish sums rows part, part + 4, ... of each column in order,
    compensated, then the four parts in order."""
    Pp = xsp.shape[2]
    _, _, Z, z = factor(xt, yt, p, xsp, kernel, D)
    M = Z.shape[1]
    sm = [kahan([Z[:, r] * z[:, r, None] for r in range(part, M, 4)])
          for part in range(4)]
    sv = [kahan([Z[:, r] * Z[:, r] for r in range(part, M, 4)])
          for part in range(4)]
    mean = sm[0] + sm[1] + sm[2] + sm[3]
    var = p[:, 5, None] - (sv[0] + sv[1] + sv[2] + sv[3])
    return mean[:, :Pp], var[:, :Pp]


def case(B, N, P, D=3, seed=0, noise=(0.01, 0.2)):
    """Raw inputs of tests/test_pallas_gpr.py's recipe (one partly padded
    and one nearly empty expert), f64."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-4, 4, (B, N, D))
    y = rng.standard_normal((B, N))
    mask = np.ones((B, N))
    mask[0, N * 3 // 4:] = 0.0
    mask[-1, min(N, 10):] = 0.0
    Xs = rng.uniform(-4, 4, (B, P, D))
    params = {"lengthscales": rng.uniform(0.5, 3, (B, D)),
              "kernel_variance": rng.uniform(0.5, 2, B),
              "likelihood_variance": rng.uniform(*noise, B)}
    return params, X, y, mask, Xs


def packed(params, X, y, mask, Xs, dtype):
    """cuda_gpr's packing (N and P padded to 32) in dtype."""
    prm = {k: torch.tensor(v) for k, v in params.items()}
    xt, yt, p, _, _ = cuda_gpr._pack(prm, torch.tensor(X), torch.tensor(y),
                                     torch.tensor(mask), 1e-6)
    xsp = cuda_gpr._pack_xs(torch.tensor(Xs))
    return xt.to(dtype), yt.to(dtype), p.to(dtype), xsp.to(dtype)


@pytest.mark.parametrize("kernel,N,P", [(k, 50, 40) for k in KERNELS]
                         + [("Matern32", 96, 33), ("Matern32", 400, 400),
                            ("RBF", 416, 130)])
def test_schedule_matches_plain_in_f64(kernel, N, P):
    """f64 replays against _predict_plain and _value_plain in f64
    (torch.linalg): rtol 1e-10, atol 1e-10 of the largest output. N=400
    packs to 416 and pads to 448; P=400 to 416 and 448 (seven K* tile
    columns); N=96 and N=416 pad to two and seven tiles."""
    D = 3
    xt, yt, p, xsp = packed(*case(4, N, P, D, seed=N + P), torch.float64)
    mean, var = replay_predict(xt, yt, p, xsp, kernel, D)
    pm, pv = cuda_gpr._predict_plain(xt, yt, p, xsp, kernel, D)
    for got, want in ((mean, pm), (var, pv)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10,
                                   atol=1e-10 * float(want.abs().max()))
    val = replay_value(xt, yt, p, kernel, D)
    want = cuda_gpr._value_plain(xt, yt, p, kernel, D)
    np.testing.assert_allclose(val.numpy(), want.numpy(), rtol=1e-10,
                               atol=1e-10 * float(want.abs().max()))


@pytest.mark.parametrize("kernel,N,P", [("Matern32", 96, 50),
                                        ("RBF", 200, 180),
                                        ("Matern32", 400, 400)])
def test_schedule_in_f32_matches_jax_interpret(kernel, N, P):
    """f32 replays against pallas_gpr's posterior_predict_batched and
    nlml_value_batched in interpret mode on the same raw inputs: the
    prediction dict rtol 1e-3 atol 1e-4, the value rtol 2e-5 atol 1e-3
    (tests/test_pallas_gpr.py). The replay's outputs go through the torch
    wrapper's own unpacking (f*_var clamped at 0, y_var)."""
    D = 3
    params, X, y, mask, Xs = case(4, N, P, D, seed=N)
    xt, yt, p, xsp = packed(params, X, y, mask, Xs, torch.float32)
    mean, var = replay_predict(xt, yt, p, xsp, kernel, D)
    got = cuda_gpr._predict_unpack(
        mean, var, {k: torch.tensor(v, dtype=torch.float32)
                    for k, v in params.items()}, P)
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    f32 = np.float32
    want = pallas_gpr.posterior_predict_batched(
        jp, X.astype(f32), y.astype(f32), mask.astype(f32), Xs.astype(f32),
        kernel, 1e-6, interpret=True)
    for k in ("f*", "f*_var", "y_var"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-3, atol=1e-4, err_msg=k)
    val = replay_value(xt, yt, p, kernel, D)
    wantv = pallas_gpr.nlml_value_batched(
        jp, X.astype(f32), y.astype(f32), mask.astype(f32), kernel, 1e-6,
        interpret=True)
    np.testing.assert_allclose(val.numpy(), np.asarray(wantv), rtol=2e-5,
                               atol=1e-3)


@pytest.mark.parametrize("N", [96, 400])
def test_value_replay_equals_the_vg_replay_lane_0(N):
    """In f32, the value replay and the vg replay's lane 0 are equal bit for
    bit: one factor (the vg replay also forms W, which U, ld and z do not
    depend on), the same y solve and the same finish (gp_nlml_warp)."""
    xt, yt, p, _ = packed(*case(3, N, 8, seed=N + 7), torch.float32)
    val = replay_value(xt, yt, p, "Matern32", 3)
    assert torch.isfinite(val).all()
    assert torch.equal(val, replay_vg(xt, yt, p, "Matern32", 3)[:, 0])


def test_non_pd_expert_gives_nan_in_its_own_outputs_only():
    """A negative noise makes expert 1's matrix indefinite: its value, mean
    and var are NaN, every other expert's are those of the replay without
    it, bit for bit."""
    xt, yt, p, xsp = packed(*case(4, 150, 70, seed=7), torch.float64)
    p[1, 6] = -5.0
    keep = [0, 2, 3]
    val = replay_value(xt, yt, p, "Matern32", 3)
    mean, var = replay_predict(xt, yt, p, xsp, "Matern32", 3)
    assert torch.isnan(val[1]) and torch.isnan(mean[1]).all() \
        and torch.isnan(var[1]).all()
    assert torch.equal(val[keep], replay_value(xt[keep], yt[keep], p[keep],
                                               "Matern32", 3))
    m2, v2 = replay_predict(xt[keep], yt[keep], p[keep], xsp[keep],
                            "Matern32", 3)
    assert torch.equal(mean[keep], m2) and torch.equal(var[keep], v2)
    assert torch.isfinite(mean[keep]).all() and torch.isfinite(
        var[keep]).all()
