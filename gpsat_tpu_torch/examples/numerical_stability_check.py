"""Numerical-stability smoke test: near-duplicate points + jitter sweep (the
port's counterpart of examples/numerical_stability_check.py).

The reference's standalone `test_numerical_stability.py` (root of
akpetty/GPSat) builds a 400-point gridded GPR with near-duplicate
coordinates, raises the default jitter to 1e-4 and checks the
Cholesky/optimisation survives. Here the same stress runs through the
port's batched GPR engine across a jitter sweep and both float dtypes:

  - 20x20 grid with 1e-6-scale coordinate perturbations (near-duplicates —
    the reference's trick to provoke an ill-conditioned kernel matrix);
  - jitter in {0, 1e-8, 1e-6, 1e-4}; as in the JAX engine the jitter is
    accepted and never reaches the objective or the prediction;
  - f64 and f32 (the card's working dtype: its value+gradient and
    prediction kernels run the f32 cases there).

A configuration PASSES when the optimised NLML is finite and the posterior
at the training points is finite with non-negative variance. Needs neither
pandas nor h5py.

Run: python -m gpsat_tpu_torch.examples.numerical_stability_check [--device D]
"""

import argparse

import numpy as np

from gpsat_tpu_torch import resolve_device

JITTERS = (0.0, 1e-8, 1e-6, 1e-4)
DTYPES = (np.float64, np.float32)


def make_test_data(n_side=20, seed=42):
    """Smooth field on a near-duplicate grid (reference's construction:
    sin*cos thickness field + noise + 1e-6 coordinate perturbations)."""
    rng = np.random.default_rng(seed)
    g = np.linspace(-1.0, 1.0, n_side)
    gx, gy = np.meshgrid(g, g)
    z = 0.5 + 0.3 * np.sin(gx * 2.0) * np.cos(gy * 2.0)
    z = z + 0.1 * rng.standard_normal(z.shape)
    x = gx.ravel() + 1e-6 * rng.standard_normal(gx.size)
    y = gy.ravel() + 1e-6 * rng.standard_normal(gy.size)
    return np.stack([x, y], axis=1), z.ravel()


def run_case(coords, obs, jitter, dtype, device=None):
    """Run one (jitter, dtype) cell through the batched engine on `device`
    (the card unless the caller passes another), which honours `dtype` end
    to end. Returns (finite, nlml, converged)."""
    return fit_case(coords, obs, jitter, dtype, device)[:3]


def fit_case(coords, obs, jitter, dtype, device=None):
    """run_case's fit; returns (finite, nlml, converged, {f*, f*_var} at the
    training points)."""
    import torch
    from gpsat_tpu_torch.models.batched import BatchedGPR
    engine = BatchedGPR(coords_dim=coords.shape[1], kernel="Matern32",
                        jitter=jitter,
                        dtype=torch.float32 if dtype == np.float32
                        else torch.float64,
                        optim_kwargs={"max_iter": 100}, device=device)
    X = coords[None].astype(dtype)
    y = (obs - obs.mean())[None].astype(dtype)
    mask = np.ones((1, len(obs)), dtype=bool)
    out = engine.fit_predict(X, y, mask, Xs=X, optimise=True, predict=True)
    nlml = float(out["objective"][0])
    f = np.asarray(out["preds"]["f*"][0])
    v = np.asarray(out["preds"]["f*_var"][0])
    assert f.dtype == dtype, f"engine ran {f.dtype}, wanted {np.dtype(dtype)}"
    finite = (np.isfinite(nlml) and np.isfinite(f).all()
              and np.isfinite(v).all() and (v >= -1e-6).all())
    return (bool(finite), nlml, bool(out["converged"][0]),
            {"f*": f, "f*_var": v})


def main(argv=None, device=None):
    """The sweep on `device` (--device; the card unless the caller passes
    another). Returns one dict a case: jitter, dtype, finite, nlml,
    converged and the predictions at the training points."""
    ap = argparse.ArgumentParser(
        prog="python -m gpsat_tpu_torch.examples.numerical_stability_check")
    ap.add_argument("--device", default=device,
                    help="torch device of the engine (default: cuda)")
    # called from code with device= and no argv: the defaults, not sys.argv
    args = ap.parse_args([] if argv is None and device is not None else argv)
    device = resolve_device(args.device)
    coords, obs = make_test_data()
    print(f"{len(obs)} near-duplicate points; field range "
          f"[{obs.min():.3f}, {obs.max():.3f}]")
    n_pass = 0
    cases = [(j, dt) for dt in DTYPES for j in JITTERS]
    results = []
    for jitter, dtype in cases:
        finite, nlml, ok_opt, preds = fit_case(coords, obs, jitter, dtype,
                                               device)
        status = "PASS" if finite else "FAIL"
        n_pass += finite
        print(f"  jitter={jitter:>7.0e} dtype={np.dtype(dtype).name:<7} "
              f"{status}  nlml={nlml:12.5f} opt_success={ok_opt}")
        results.append({"jitter": jitter, "dtype": np.dtype(dtype).name,
                        "finite": finite, "nlml": nlml,
                        "converged": ok_opt, "preds": preds})
    # jitter=0 f32 is ALLOWED to fail (that is the point of jitter); every
    # jittered configuration must pass
    jittered = len(cases) - 2
    assert n_pass >= jittered, \
        f"only {n_pass}/{len(cases)} stable; expected at least {jittered}"
    print(f"numerical_stability_check: OK ({n_pass}/{len(cases)} stable)")
    return results


if __name__ == "__main__":
    main()
