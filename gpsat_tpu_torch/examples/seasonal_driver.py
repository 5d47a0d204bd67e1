"""Seasonal sweep driver: one OI run per month into a single results store.

The port's counterpart of examples/seasonal_driver.py, the equivalent of the
reference's `train_gpsat_seasonal.py` (root of akpetty/GPSat): loop over a season of monthly satellite data, run the
local-expert OI for each month, and assemble a month-indexed field of
predictions. The reference script loops years x months over monthly netCDF
files; here each month is a `global_select` date window over one obs table
and a `table_suffix` namespace in one HDF5 store, so:

  - a single store holds the whole season (per-month tables
    `preds_<month>`, `run_details_<month>`, ...);
  - re-running the script resumes: completed months are skipped by the
    store's anti-join resume semantics (run_details dedup — the same
    restart-safety the reference gets from SLURM-array job resubmission);
  - the seasonal series is read back with `get_results_from_h5file` per
    suffix and stacked on a month axis.

Synthetic data: the example generator's smooth polar field plus a seasonal
amplitude cycle, three months by default.

Run: python -m gpsat_tpu_torch.examples.seasonal_driver [--months 3]
        [--out results/seasonal.h5] [--device D]
(on the card unless D is given)
"""

import argparse
import os

import numpy as np

from gpsat_tpu_torch import get_parent_path, resolve_device
from gpsat_tpu_torch.utils import cprint

KM = 1000.0


def make_month_obs(month_idx, n_tracks=24, seed0=100, domain=600 * KM):
    """Along-track obs for one month: base field modulated by a seasonal
    amplitude (month-dependent), so optimised hyperparameters drift over
    the season like real freeboard fields do."""
    import pandas as pd
    rng = np.random.default_rng(seed0 + month_idx)
    amp = 1.0 + 0.4 * np.sin(2 * np.pi * month_idx / 12.0)
    rows = []
    t0 = np.datetime64("2020-01-01") + np.timedelta64(31 * month_idx, "D")
    for _ in range(n_tracks):
        theta = rng.uniform(0, 2 * np.pi)
        offset = rng.uniform(-domain * 0.7, domain * 0.7)
        s = np.linspace(-domain, domain, 200)
        x = s * np.cos(theta) - offset * np.sin(theta)
        y = s * np.sin(theta) + offset * np.cos(theta)
        keep = (np.abs(x) < domain) & (np.abs(y) < domain)
        x, y = x[keep], y[keep]
        z = amp * (0.2 * np.sin(x / (200 * KM)) + 0.15 * np.cos(y / (250 * KM))
                   ) + 0.05 * rng.standard_normal(len(x))
        rows.append(pd.DataFrame({
            "x": x, "y": y, "z": z,
            "date": np.full(len(x), t0 + np.timedelta64(14, "D"))}))
    return pd.concat(rows, ignore_index=True)


def main(argv=None, device=None):
    """The season on `device` (--device; the card unless the caller passes
    another). Returns the per-month summary table."""
    p = argparse.ArgumentParser(
        prog="python -m gpsat_tpu_torch.examples.seasonal_driver")
    p.add_argument("--months", type=int, default=3)
    p.add_argument("--out", default=None, help="results store path")
    p.add_argument("--device", default=device,
                   help="torch device of the engine (default: cuda)")
    # called from code with device= and no argv: the defaults, not sys.argv
    args = p.parse_args([] if argv is None and device is not None else argv)
    device = resolve_device(args.device)

    import pandas as pd
    from gpsat_tpu_torch.local_experts import (LocalExpertOI,
                                               get_results_from_h5file)

    store = args.out or os.path.join(
        get_parent_path("results"), "seasonal_example.h5")
    os.makedirs(os.path.dirname(store) or ".", exist_ok=True)

    # one obs table for the whole season; months selected by date window
    obs = pd.concat([make_month_obs(m) for m in range(args.months)],
                    ignore_index=True)

    # expert grid shared by every month (reference: coarsened obs grid)
    g = np.arange(-400 * KM, 401 * KM, 200 * KM)
    gx, gy = np.meshgrid(g, g)
    xprt = pd.DataFrame({"x": gx.ravel(), "y": gy.ravel()})

    month_labels = []
    for m in range(args.months):
        t0 = (np.datetime64("2020-01-01") + np.timedelta64(31 * m, "D"))
        t1 = t0 + np.timedelta64(31, "D")
        label = str(t0)[:7].replace("-", "_")
        month_labels.append(label)
        cprint(f"== month {label}: window [{t0}, {t1}) ==", "HEADER")
        oi = LocalExpertOI(
            data={
                "data_source": obs,
                "obs_col": "z", "coords_col": ["x", "y"],
                "global_select": [
                    {"col": "date", "comp": ">=", "val": str(t0)},
                    {"col": "date", "comp": "<", "val": str(t1)}],
                "local_select": [{"col": ["x", "y"], "comp": "<",
                                  "val": 300 * KM}],
            },
            model={
                "oi_model": "GPRModel",
                "init_params": {"coords_scale": [50 * KM, 50 * KM]},
                # with coords_scale set, lengthscale bounds are PHYSICAL
                # units and are divided by coords_scale before the sigmoid
                # (same contract as the reference, local_experts.py:1110-
                # 1115) — i.e. this box is [0.1, 12] in scaled units
                "constraints": {"lengthscales": {"low": [5 * KM, 5 * KM],
                                                 "high": [600 * KM,
                                                          600 * KM]}},
            },
            locations={"df": xprt},
            # pred_loc omitted -> predict at the expert locations
            device=device,
        )
        oi.run(store_path=store, table_suffix=f"_{label}",
               store_every=100, verbose=False)

    # -- seasonal read-back: stack per-month hyperparameter fields ---------
    series = []
    for label in month_labels:
        dfs, _ = get_results_from_h5file(store, table_suffix=f"_{label}",
                                         verbose=False)
        rd = dfs[f"run_details_{label}"]
        ls = dfs[f"lengthscales_{label}"]
        kv = dfs[f"kernel_variance_{label}"]
        series.append({
            "month": label,
            "experts_run": int(rd["optimise_success"].notna().sum()),
            "success_rate": float(rd["optimise_success"].mean()),
            "median_lengthscale": float(ls["lengthscales"].median()),
            "median_kernel_variance": float(kv["kernel_variance"].median()),
        })
    out = pd.DataFrame(series)
    print(out.to_string(index=False))
    assert (out["success_rate"] > 0.8).all(), "a month's sweep failed"
    # the synthetic seasonal cycle is a MULTIPLICATIVE amplitude: it moves
    # the kernel variance month to month (spatial correlation — the
    # lengthscales — stays put by construction)
    assert out["median_kernel_variance"].nunique() > 1, \
        "hyperparameters identical across months — seasonal signal lost"
    # and the learnt lengthscales must be non-degenerate: inside the
    # configured physical box, not pinned at a bound
    assert (out["median_lengthscale"] > 0.1).all(), \
        "lengthscales collapsed to the lower constraint bound"
    cprint(f"seasonal_driver: OK ({args.months} months -> {store})", "OKGREEN")
    return out


if __name__ == "__main__":
    main()
