"""Entry points of the port: a single-device forward step and a multi-device
dry run (the counterparts of the repository's __graft_entry__.py)."""

import numpy as np
import torch

from gpsat_tpu_torch import resolve_device

__all__ = ["entry", "dryrun_multichip"]


def entry(device=None):
    """(fn, args): the forward step of the flagship model, the batched
    masked exact-GPR negative log marginal likelihood and the posterior
    mean and variance for a bucket of B=8 experts (N=64 observations, the
    last 8 masked, P=32 prediction points, D=3), on `device` (the card
    unless the caller passes another), in float32 from default_rng(0)'s
    draws. fn(*args) -> (nlml [B], f* [B, P], f*_var [B, P])."""
    from gpsat_tpu_torch.ops import gpr as gpr_math

    dev = resolve_device(device)
    B, N, P, D = 8, 64, 32, 3
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)
    params = {"lengthscales": t(rng.uniform(0.5, 2.0, (B, D))),
              "kernel_variance": t(rng.uniform(0.5, 1.5, B)),
              "likelihood_variance": t(np.full(B, 0.1))}
    X = t(rng.uniform(-2, 2, (B, N, D)))
    y = t(rng.standard_normal((B, N)))
    mask = torch.as_tensor(np.broadcast_to(np.arange(N) < N - 8, (B, N)).copy(),
                           device=dev)
    Xs = t(rng.uniform(-2, 2, (B, P, D)))

    def forward(params, X, y, mask, Xs):
        nlml = gpr_math.nlml(params, X, y, mask)
        preds = gpr_math.predict(params, X, y, mask, Xs)
        return nlml, preds["f*"], preds["f*_var"]

    return forward, (params, X, y, mask, Xs)


def _check(cond, msg):
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def dryrun_multichip(n_devices, devices=None):
    """Run one full batched step with the experts split over an
    `n_devices`-shard mesh (parallel/mesh): a fit_predict chunk, the GPR
    pool (2 slots a shard, so slots refill), the SGPR pool (M=24), SVGP
    with natural gradients (the chunked path), the sharded dense smoother
    and the tiled smoother; each result checked finite and of its shape.
    The mesh is the first `n_devices` cards, or of `devices` (which may
    name one device more than once). Prints one summary line."""
    from gpsat_tpu_torch.models.batched import (BatchedGPR, BatchedSGPR,
                                                BatchedSVGP)
    from gpsat_tpu_torch.parallel.mesh import get_mesh
    from gpsat_tpu_torch.postprocessing import (gaussian_2d_smooth_sharded,
                                                gaussian_2d_smooth_tiled)

    if devices is None:
        mesh = get_mesh(n_devices=n_devices)
    else:
        mesh = get_mesh(devices=list(devices)[:n_devices])
    _check(mesh.size == n_devices,
           f"need {n_devices} devices, have {mesh.size}")
    dev = mesh.devices[0]

    B = 2 * n_devices
    N, Pn, D = 16, 8, 3
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (B, N, D))
    y = rng.standard_normal((B, N))
    mask = np.ones((B, N), dtype=bool)
    Xs = rng.uniform(-2, 2, (B, Pn, D))
    bounds = {"lengthscales": {"low": [0.01] * D, "high": [50.0] * D}}

    # one chunk of 2 experts a shard, one fit_predict per shard
    engine = BatchedGPR(coords_dim=D, kernel="Matern32", constraints=bounds,
                        optim_kwargs={"max_iter": 10}, device=dev)
    out = engine.fit_predict_many(X, y, mask, Xs=Xs, slots=2, mesh=mesh)
    _check(np.isfinite(out["objective"]).all(), "fit_predict objective")
    _check(out["preds"]["f*"].shape == (B, Pn), "fit_predict shape")

    # the pool under the mesh at a realistic padded shape, slots below the
    # experts a shard so that the refill path runs
    B2, N2 = 4 * n_devices, 128
    X2 = rng.uniform(-2, 2, (B2, N2, D)).astype(np.float32)
    y2 = (np.sin(X2[..., 0])
          + 0.1 * rng.standard_normal((B2, N2))).astype(np.float32)
    y2 = y2 - y2.mean(axis=1, keepdims=True)
    m2 = np.ones((B2, N2), dtype=bool)
    Xs2 = rng.uniform(-2, 2, (B2, Pn, D)).astype(np.float32)
    pooled = engine.fit_predict_many(X2, y2, m2, Xs=Xs2, slots=2, mesh=mesh)
    _check(np.isfinite(pooled["objective"]).all(), "gpr pool objective")
    _check(pooled["preds"]["f*"].shape == (B2, Pn), "gpr pool shape")

    # the production model (SGPR) through its pool under the same mesh
    sgpr = BatchedSGPR(coords_dim=D, kernel="Matern32",
                       num_inducing_points=24, constraints=bounds,
                       optim_kwargs={"max_iter": 8}, device=dev)
    sg = sgpr.fit_predict_many(X2, y2, m2, Xs=Xs2, slots=2, mesh=mesh)
    _check(np.isfinite(sg["objective"]).all(), "sgpr pool objective")
    _check(sg["preds"]["f*"].shape == (B2, Pn), "sgpr pool shape")

    # a non-L-BFGS engine: SVGP (Adam + natural gradients) on the chunked
    # path, its chunk split over the shards
    svgp = BatchedSVGP(coords_dim=D, kernel="Matern32", num_inducing_points=8,
                       optim_kwargs={"max_iter": 20, "natural_gradients": True,
                                     "gamma": 0.5}, device=dev)
    sv = svgp.fit_predict_many(X2, y2, m2, Xs=Xs2, mesh=mesh)
    _check(np.isfinite(sv["objective"]).all(), "svgp objective")
    _check(sv["preds"]["f*"].shape == (B2, Pn), "svgp shape")

    # smoothing: output rows split over the shards against every source
    ex = rng.uniform(-5, 5, B)
    ey = rng.uniform(-5, 5, B)
    smoothed = gaussian_2d_smooth_sharded(
        ex, ey, ex, ey, 2.0, 2.0, out["params"]["kernel_variance"], mesh=mesh)
    _check(np.isfinite(smoothed).all(), "sharded smoothing")

    # the tiled smoother, at a size past its tiny-E dense fallback
    Es = max(96 * n_devices, 256)
    sx = rng.uniform(-100, 100, Es)
    sy = rng.uniform(-100, 100, Es)
    sv_vals = np.sin(sx / 30) + 0.1 * rng.standard_normal(Es)
    tiled = gaussian_2d_smooth_tiled(sx, sy, sx, sy, 5.0, 5.0, sv_vals,
                                     mesh=mesh)
    _check(np.isfinite(tiled).all(), "tiled smoothing")
    print(f"dryrun_multichip: OK on {n_devices} devices "
          f"(B={B}, N={N}, P={Pn}; gpr pool + sgpr pool + svgp + "
          f"smoothing + tiled smoothing)")
