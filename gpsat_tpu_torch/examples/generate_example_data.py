"""Generate synthetic ABC-style raw satellite files + ground truth (the
port's counterpart of examples/generate_example_data.py; the same numbers
from the same seed).

Per-satellite along-track lon/lat/datetime/z CSVs sampled from a known
smooth polar field + noise, a ground-truth grid, and the expert and
prediction location files of the config-driven CLI recipes, so every
downstream example runs offline.

Usage: python -m gpsat_tpu_torch.examples.generate_example_data [out_dir]
"""

import os
import sys

import numpy as np

from gpsat_tpu_torch import get_data_path
from gpsat_tpu_torch.utils import EASE2toWGS84, grid_2d_flatten

KM = 1000.0


def truth_field(x, y):
    """Known smooth field (units ~ sea-surface height anomalies, m)."""
    return (0.15 * np.sin(x / (300 * KM)) + 0.1 * np.cos(y / (400 * KM))
            + 0.08 * np.sin((x + 0.5 * y) / (500 * KM)) + 0.15)


def track_arrays(n_tracks=60, pts_per_track=400, seed=0, noise=0.05,
                 domain=1500 * KM):
    """Along-track sampling, straight chords across the polar domain, as
    numpy arrays: x, y, z, datetime (datetime64[s]) and track of every
    point."""
    rng = np.random.default_rng(seed)
    cols = {k: [] for k in ("x", "y", "z", "datetime", "track")}
    for ti in range(n_tracks):
        theta = rng.uniform(0, 2 * np.pi)
        offset = rng.uniform(-domain * 0.7, domain * 0.7)
        s = np.linspace(-domain, domain, pts_per_track)
        x = s * np.cos(theta) - offset * np.sin(theta)
        y = s * np.sin(theta) + offset * np.cos(theta)
        keep = (np.abs(x) < domain) & (np.abs(y) < domain)
        x, y = x[keep], y[keep]
        z = truth_field(x, y) + noise * rng.standard_normal(len(x))
        t = rng.integers(0, 9)  # day index 0..8
        cols["x"].append(x)
        cols["y"].append(y)
        cols["z"].append(z)
        cols["datetime"].append(np.datetime64("2020-03-01")
                                + np.timedelta64(int(t), "D")
                                + (np.arange(len(x)) * np.timedelta64(1, "s")))
        cols["track"].append(np.full(len(x), ti))
    return {k: np.concatenate(v) for k, v in cols.items()}


def make_tracks(n_tracks=60, pts_per_track=400, seed=0, noise=0.05,
                domain=1500 * KM):
    """track_arrays as a DataFrame (x, y, z, datetime, track)."""
    import pandas as pd
    return pd.DataFrame(track_arrays(n_tracks, pts_per_track, seed, noise,
                                     domain))


def main(out_dir=None, seed=0, n_tracks=40):
    """Write A/B/C_RAW.csv, ground_truth.csv, expert_locations.csv and
    prediction_locations.csv to `out_dir` (default <repo>/data/example).
    `n_tracks` tracks a satellite (40 as the JAX package's generator)."""
    import pandas as pd
    out_dir = out_dir or get_data_path("example")
    os.makedirs(out_dir, exist_ok=True)
    sources = {"A": 0, "B": 1, "C": 2}
    for name, sub_seed in sources.items():
        df = make_tracks(n_tracks=n_tracks, seed=seed + sub_seed)
        df["lon"], df["lat"] = EASE2toWGS84(df["x"].values, df["y"].values)
        out = df[["lon", "lat", "datetime", "z"]]
        path = os.path.join(out_dir, f"{name}_RAW.csv")
        out.to_csv(path, index=False)
        print(f"wrote {len(out)} rows to {path}")
    # ground truth on a grid, for accuracy evaluation
    gx, gy = np.meshgrid(np.linspace(-1500 * KM, 1500 * KM, 121),
                         np.linspace(-1500 * KM, 1500 * KM, 121))
    truth = pd.DataFrame({"x": gx.ravel(), "y": gy.ravel(),
                          "z_true": truth_field(gx.ravel(), gy.ravel())})
    truth.to_csv(os.path.join(out_dir, "ground_truth.csv"), index=False)
    print(f"wrote ground truth grid to {out_dir}/ground_truth.csv")

    # expert + prediction location files for the config-driven CLI recipes
    eloc = pd.DataFrame(grid_2d_flatten([-1000 * KM, 1000 * KM],
                                        [-1000 * KM, 1000 * KM],
                                        step_size=400 * KM),
                        columns=["x", "y"])
    # centre day of the 0..8 day window, in the same datetime64[D]-as-float
    # units the binning pipeline produces for 't'
    t0 = float(np.datetime64("2020-03-01").astype("datetime64[D]").astype(float))
    eloc["t"] = t0 + 4.0
    eloc.to_csv(os.path.join(out_dir, "expert_locations.csv"), index=False)
    ploc = pd.DataFrame(grid_2d_flatten([-1000 * KM, 1000 * KM],
                                        [-1000 * KM, 1000 * KM],
                                        step_size=50 * KM),
                        columns=["x", "y"])
    ploc.to_csv(os.path.join(out_dir, "prediction_locations.csv"), index=False)
    print(f"wrote expert/prediction location files to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
