"""Weight-function playground: compare the smoothing/merge weight kernels
(the port's counterpart of examples/weight_function_compare.py).

The reference's playground timed its numba `gaussian_2d_weight` gufunc
against an astropy Gaussian2DKernel convolution on a NaN-holed grid. Here
the contenders are:

  1. `postprocessing.gaussian_2d_smooth` — the torch smoother used by
     `smooth_hyperparameters` (f64 on the card unless --device names
     another, NaN-aware);
  2. `utils.get_weighted_values` — the pandas groupby Gaussian merge used to
     glue overlapping per-expert predictions;
  3. a direct NumPy oracle (explicit exp(-d^2/2) weighted sum).

All three implement w = exp(-d2/2), d2 = ((x-x0)/l_x)^2 + ((y-y0)/l_y)^2
with NaN sources dropped, so their outputs must agree to float tolerance —
this script asserts that, then reports timings.

Run: python -m gpsat_tpu_torch.examples.weight_function_compare [--n 64]
        [--plot out.png] [--device D]
"""

import argparse
import time

import numpy as np

from gpsat_tpu_torch import resolve_device


def numpy_oracle(x0, y0, x, y, l_x, l_y, vals):
    """Direct O(out*src) NumPy weighted sum; NaN vals dropped."""
    out = np.empty(len(x0))
    ok = ~np.isnan(vals)
    for i in range(len(x0)):
        d2 = ((x - x0[i]) / l_x) ** 2 + ((y - y0[i]) / l_y) ** 2
        w = np.exp(-0.5 * d2) * ok
        s = w.sum()
        out[i] = np.nan if s == 0 else (w * np.where(ok, vals, 0.0)).sum() / s
    return out


def make_field(n=64, nan_frac=0.15, seed=0):
    """The n x n NaN-holed field (x, y, vals) and the rng after drawing it
    (it then draws the merge subsample)."""
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.arange(n, dtype=float), np.arange(n, dtype=float))
    x, y = gx.ravel(), gy.ravel()
    vals = (np.sin(x / 7.0) * np.cos(y / 9.0)
            + 0.25 * rng.standard_normal(x.shape))
    vals[rng.random(vals.shape) < nan_frac] = np.nan  # holes to in-fill
    return x, y, vals, rng


def merge_pairs(x, y, vals, sub, ls):
    """The (output, source) pair table of every output in `sub` and every
    source within 4*ls, NaN sources dropped — the glue path's sparse
    formulation of the same weighted sum."""
    import pandas as pd
    pairs = []
    for i in sub:
        d2 = (x - x[i]) ** 2 + (y - y[i]) ** 2
        near = np.where(d2 <= (4 * ls) ** 2)[0]
        pairs.append(pd.DataFrame({
            "px": np.full(len(near), x[i]), "py": np.full(len(near), y[i]),
            "sx": x[near], "sy": y[near], "val": vals[near]}))
    return pd.concat(pairs, ignore_index=True).dropna(subset=["val"])


def main(argv=None, device=None):
    """The comparison on `device` (--device; the card unless the caller
    passes another). Returns {"smoothed", "merged", "oracle", "sub"}."""
    p = argparse.ArgumentParser(
        prog="python -m gpsat_tpu_torch.examples.weight_function_compare")
    p.add_argument("--n", type=int, default=64, help="grid side length")
    p.add_argument("--lengthscale", type=float, default=2.0)
    p.add_argument("--nan-frac", type=float, default=0.15)
    p.add_argument("--plot", default=None, help="optional PNG output path")
    p.add_argument("--device", default=device,
                   help="torch device of the smoother (default: cuda)")
    # called from code with device= and no argv: the defaults, not sys.argv
    args = p.parse_args([] if argv is None and device is not None else argv)
    dev = resolve_device(args.device)

    from gpsat_tpu_torch.postprocessing import gaussian_2d_smooth
    from gpsat_tpu_torch.utils import get_weighted_values

    n = args.n
    x, y, vals, rng = make_field(n, args.nan_frac)
    ls = args.lengthscale

    # 1. device smoother (warm once so the timing excludes first-call costs)
    gaussian_2d_smooth(x, y, x, y, ls, ls, vals, device=dev)
    t0 = time.perf_counter()
    smoothed = gaussian_2d_smooth(x, y, x, y, ls, ls, vals, device=dev)
    t_dev = time.perf_counter() - t0

    # 2. pandas Gaussian merge on a subsample, so the pair table stays small
    sub = rng.choice(len(x), size=min(256, len(x)), replace=False)
    df = merge_pairs(x, y, vals, sub, ls)
    t0 = time.perf_counter()
    merged = get_weighted_values(df, ref_col=["px", "py"],
                                 dist_to_col=["sx", "sy"], val_cols="val",
                                 lengthscale=ls)
    t_merge = time.perf_counter() - t0
    merged = merged.set_index(["px", "py"])["val"]

    # 3. NumPy oracle on the subsample
    t0 = time.perf_counter()
    oracle = numpy_oracle(x[sub], y[sub], x, y, ls, ls, vals)
    t_np = time.perf_counter() - t0

    # agreement: device smoother vs oracle everywhere the oracle is defined
    err_dev = np.nanmax(np.abs(smoothed[sub] - oracle))
    # the merge only saw sources within 4*ls; a truncated-support oracle
    merged_sub = np.array([merged.loc[(x[i], y[i])] for i in sub])
    # truncation at 4*ls changes weights by < exp(-8); loose tol covers it
    err_merge = np.nanmax(np.abs(merged_sub - oracle))

    print(f"grid {n}x{n}, lengthscale {ls}, {np.isnan(vals).sum()} NaN holes")
    print(f"device smoother : {t_dev * 1e3:8.2f} ms   "
          f"max |err| vs oracle = {err_dev:.2e} ({dev})")
    print(f"pandas merge    : {t_merge * 1e3:8.2f} ms   "
          f"max |err| vs oracle = {err_merge:.2e} (4-sigma truncated)")
    print(f"numpy oracle    : {t_np * 1e3:8.2f} ms   ({len(sub)} outputs)")
    assert err_dev < 1e-8, "device smoother diverged from the oracle"
    assert err_merge < 1e-3, "pandas merge diverged beyond truncation error"

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(1, 2, figsize=(9, 4))
        for ax, (z, title) in zip(axes, [
                (vals, "input (with NaN holes)"),
                (smoothed, "gaussian_2d_smooth")]):
            im = ax.imshow(z.reshape(n, n), origin="lower")
            ax.set_title(title)
            fig.colorbar(im, ax=ax, shrink=0.8)
        fig.tight_layout()
        fig.savefig(args.plot, dpi=120)
        plt.close(fig)
        print(f"wrote {args.plot}")
    print("weight_function_compare: OK")
    return {"smoothed": smoothed, "merged": merged_sub, "oracle": oracle,
            "sub": sub}


if __name__ == "__main__":
    main()
