"""Production-style sea-ice driver: SGPR experts + ice-edge anchoring +
optional secondary-instrument fusion (the port's counterpart of
examples/sea_ice_freeboard_driver.py).

A compact equivalent of the akpetty fork's production flows
(reference: IS2_GPSat_train.py — read along-track + sea-ice-concentration
data, build an expert grid, anchor the field at the ice edge by injecting
zero-value pseudo-observations where SIC < sic_cutoff
(reference: extra_funcs.py:149-195, concat at IS2_GPSat_train.py:782-786),
run SGPR OI, smooth hyperparameters, re-predict, merge, export) and
(reference: IS2_SMAP_GPSat_train.py — fuse a second instrument's gridded
thin-ice thickness into the training set: value-range filter, coarsen,
region exclusion, concat with a source label; load_smap_data_for_date at
142-350, concat at 1441-1515).

Each data function is a numpy core on arrays (``*_arrays``, ``bin_arrays``,
``secondary_rows``, ``local_inputs``, ``merge_weighted``, ``truth``), which
needs neither pandas nor h5py, and a thin DataFrame wrapper with the JAX
driver's name. ``main`` runs the whole flow through LocalExpertOI and the
results store; a machine without pandas runs the device half on the cores
and ``gpsat_tpu_torch.local_experts.execute_buckets``.

Runs on synthetic data so it is self-contained:
  python -m gpsat_tpu_torch.examples.sea_ice_freeboard_driver
      [--num-experts N] [--sic] [--plus-secondary] [--secondary-csv FILE]
      [--device D]
"""

import argparse
import os

import numpy as np

from gpsat_tpu_torch import get_parent_path, resolve_device
from gpsat_tpu_torch.utils import cprint, grid_2d_flatten

KM = 1000.0
DOMAIN = 1200 * KM
ICE_EDGE = 900 * KM
GRID_RES = 50 * KM          # the binning and prediction grid
EXPERT_HALF = 1000 * KM     # experts and predictions over +-1000 km
TRAIN_RADIUS = 600 * KM     # local data of an expert
PRED_RADIUS = 400 * KM      # its prediction points
MERGE_LENGTHSCALE = 200 * KM

# SGPR configuration mirroring the production driver's choices
# (reference: IS2_GPSat_train.py:341-364,793-868)
MODEL_CONFIG = {
    "oi_model": "SGPRModel",
    "init_params": {"coords_scale": [50 * KM, 50 * KM, 1],
                    "num_inducing_points": 300},
    "constraints": {
        "lengthscales": {"low": [10 * KM, 10 * KM, 0.5],
                         "high": [1000 * KM, 1000 * KM, 50]},
        "likelihood_variance": {"low": 1e-4, "high": 0.5}},
}
# the smoothing of the first stage's hyperparameters before the re-predict
SMOOTH_CONFIG = {
    "lengthscales": {"l_x": 400 * KM, "l_y": 400 * KM},
    "kernel_variance": {"l_x": 400 * KM, "l_y": 400 * KM, "max": 4.0},
    "likelihood_variance": {"l_x": 400 * KM, "l_y": 400 * KM, "max": 0.5}}


# ---------------------------------------------------------------------------
# numpy cores
# ---------------------------------------------------------------------------

def sic_of(r):
    """Synthetic sea-ice concentration at radius r: 1 at the pole, 0
    outside the ice edge."""
    return np.clip(1.4 - r / ICE_EDGE, 0, 1)


def truth(x, y):
    """The noise-free thickness field: tapers to zero at the ice edge."""
    r = np.hypot(x, y)
    return np.maximum(2.0 * (1 - (r / ICE_EDGE) ** 2), 0.0) \
        + 0.3 * np.sin(x / (250 * KM)) * (sic_of(r) > 0.15)


def synth_sea_ice_arrays(n=6000, seed=0, domain=DOMAIN):
    """{x, y, t, z, sic} of n synthetic observations: the thickness field
    plus noise 0.1, and the radially-varying concentration."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-domain, domain, n)
    y = rng.uniform(-domain, domain, n)
    sic = sic_of(np.hypot(x, y))
    obs = truth(x, y) + 0.1 * rng.standard_normal(n)
    return {"x": x, "y": y, "t": np.zeros(n), "z": obs, "sic": sic}


def bin_arrays(x, y, z, grid_res=GRID_RES, x_range=(-DOMAIN, DOMAIN),
               y_range=(-DOMAIN, DOMAIN)):
    """{x, y, z} of the non-empty cells of the binned mean, in the rows of
    DataPrep.bin_data_by(...).to_dataframe().dropna().reset_index() for one
    group (y-major): scipy.stats.binned_statistic_2d over the same edges."""
    import scipy.stats as scst
    x_min, x_max = x_range
    y_min, y_max = y_range
    x_edge = np.linspace(x_min, x_max, int((x_max - x_min) / grid_res) + 1)
    y_edge = np.linspace(y_min, y_max, int((y_max - y_min) / grid_res) + 1)
    binned = scst.binned_statistic_2d(
        x, y, z, statistic="mean", bins=[x_edge, y_edge],
        range=[[x_min, x_max], [y_min, y_max]])[0].T
    xc = x_edge[:-1] + np.diff(x_edge) / 2
    yc = y_edge[:-1] + np.diff(y_edge) / 2
    Y, X = np.meshgrid(yc, xc, indexing="ij")
    keep = ~np.isnan(binned.reshape(-1))
    return {"x": X.reshape(-1)[keep], "y": Y.reshape(-1)[keep],
            "z": binned.reshape(-1)[keep]}


def sic_pseudo_obs_arrays(sic_cutoff=0.15, spacing=100 * KM, domain=DOMAIN):
    """(x, y) of the zero-thickness pseudo-observations: the cells of a
    `spacing` grid where SIC < cutoff (reference: extra_funcs.py:149-195)."""
    grid = grid_2d_flatten([-domain, domain], [-domain, domain],
                           step_size=spacing)
    open_water = sic_of(np.hypot(grid[:, 0], grid[:, 1])) < sic_cutoff
    return grid[open_water, 0], grid[open_water, 1]


def synth_secondary_arrays(n_side=40, seed=1, domain=DOMAIN, noise=0.12):
    """{x, y, t, z} of the synthetic coarse passive-microwave product on an
    n_side^2 grid."""
    rng = np.random.default_rng(seed)
    ax = np.linspace(-domain, domain, n_side)
    gx, gy = np.meshgrid(ax, ax)
    x, y = gx.ravel(), gy.ravel()
    obs = truth(x, y) + noise * rng.standard_normal(len(x))
    return {"x": x, "y": y, "t": np.zeros(len(x)), "z": obs}


def secondary_rows(z, t=None, value_range=(0.0, 0.5), coarsen_factor=1,
                   day_only=None, exclude=None):
    """Rows of a secondary instrument kept for fusion, in order: values in
    value_range, every coarsen_factor-th of those, t == day_only, not
    exclude(rows) (a callable on the kept row numbers returning a bool per
    row), and finite z (reference: IS2_SMAP_GPSat_train.py:232-251,312-319,
    405-413)."""
    z = np.asarray(z, dtype=float)
    lo, hi = value_range
    rows = np.flatnonzero((z >= lo) & (z <= hi))
    if coarsen_factor and coarsen_factor > 1:
        rows = rows[::coarsen_factor]
    if day_only is not None:
        rows = rows[np.asarray(t)[rows] == day_only]
    if exclude is not None:
        rows = rows[~np.asarray(exclude(rows), dtype=bool)]
    return rows[~np.isnan(z[rows])]


def driver_arrays(n=6000, seed=0, sic=True, plus_secondary=False,
                  secondary=None, value_range=(0.0, 0.5), coarsen_factor=1,
                  day_only=None):
    """The training set of `main` without pandas: the synthetic observations
    binned to 50 km, the SIC pseudo-observations (sic) and the secondary
    instrument (plus_secondary; the synthetic one unless `secondary`, a
    dict of x, y, t, z, is given) fused. Returns {x, y, t, z} in the rows
    of main's DataFrame."""
    raw = synth_sea_ice_arrays(n, seed)
    b = bin_arrays(raw["x"], raw["y"], raw["z"])
    cols = {"x": [b["x"]], "y": [b["y"]], "t": [np.zeros(len(b["z"]))],
            "z": [b["z"]]}
    if sic:
        px, py = sic_pseudo_obs_arrays()
        for k, v in (("x", px), ("y", py), ("t", np.zeros(len(px))),
                     ("z", np.zeros(len(px)))):
            cols[k].append(v)
    if plus_secondary:
        sec = synth_secondary_arrays() if secondary is None else secondary
        rows = secondary_rows(sec["z"], sec["t"], value_range, coarsen_factor,
                              day_only)
        for k in cols:
            cols[k].append(np.asarray(sec[k], dtype=float)[rows])
    return {k: np.concatenate(v).astype(float) for k, v in cols.items()}


def expert_grid(spacing=400 * KM, num_experts=None):
    """[E, 3] expert locations (x, y, t=0) on the driver's grid."""
    xy = grid_2d_flatten([-EXPERT_HALF, EXPERT_HALF],
                         [-EXPERT_HALF, EXPERT_HALF], step_size=spacing)
    if num_experts:
        xy = xy[:num_experts]
    return np.concatenate([xy, np.zeros((len(xy), 1))], axis=1)


def prediction_grid():
    """[P, 2] prediction locations (x, y) on the 50 km grid."""
    return grid_2d_flatten([-EXPERT_HALF, EXPERT_HALF],
                           [-EXPERT_HALF, EXPERT_HALF], step_size=GRID_RES)


def local_inputs(data, experts, radius=TRAIN_RADIUS, max_dist=PRED_RADIUS,
                 day_window=4):
    """execute_buckets' per-expert inputs as LocalExpertOI.run gathers them
    for main's configuration: each expert's rows of `data` ({x, y, t, z})
    within +-day_window days and a KD radius in (x, y)
    (DataLoader.local_data_select: scipy KDTree.query_ball_point, rows in
    the data's order), and its prediction points on prediction_grid()
    within max_dist (prediction_locations.max_dist_bool's strict <), t the
    expert's. Returns X_list, obs_list, pred_list."""
    from scipy.spatial import KDTree
    X = np.stack([data["x"], data["y"], data["t"]], axis=1)
    z = np.asarray(data["z"], dtype=float)
    tree = KDTree(X[:, :2])
    ploc = prediction_grid()
    md2 = float(max_dist) ** 2
    X_list, obs_list, pred_list = [], [], []
    for e in experts:
        sel = (X[:, 2] <= e[2] + day_window) & (X[:, 2] >= e[2] - day_window)
        near = np.zeros(len(X), dtype=bool)
        near[tree.query_ball_point(x=[e[0], e[1]], r=radius)] = True
        rows = np.flatnonzero(sel & near)
        X_list.append(X[rows])
        obs_list.append(z[rows])
        keep = np.sum((ploc - e[:2]) ** 2, axis=1) < md2
        pred_list.append(np.concatenate(
            [ploc[keep], np.full((int(keep.sum()), 1), e[2])], axis=1))
    return X_list, obs_list, pred_list


def smooth_params(experts, params, device=None):
    """The first stage's hyperparameters smoothed over the expert locations
    as smooth_hyperparameters does it with SMOOTH_CONFIG (one field per
    lengthscale component; postprocessing.smooth_field on `device`).
    `params` {name: [E, ...]}; returns the smoothed ones."""
    from gpsat_tpu_torch.postprocessing import smooth_field
    out = {}
    for name, cfg in SMOOTH_CONFIG.items():
        v = np.asarray(params[name], dtype=float)
        cols = v.reshape(len(experts), -1)
        sm = np.column_stack([
            smooth_field(experts[:, 0], experts[:, 1], cols[:, j], cfg["l_x"],
                         cfg["l_y"], min=cfg.get("min"), max=cfg.get("max"),
                         device=device)
            for j in range(cols.shape[1])])
        out[name] = sm.reshape(v.shape)
    return out


def merge_weighted(pred_xy, expert_xy, vals, lengthscale=MERGE_LENGTHSCALE):
    """utils.get_weighted_values without pandas: each prediction location's
    values over every expert that predicts it, weighted by
    exp(-d^2 / (2 l^2)) with d the distance to the expert. Returns the
    unique locations (sorted as groupby sorts them) and [U, ...] values."""
    pred_xy = np.asarray(pred_xy, dtype=float)
    w = np.exp(-np.sum((pred_xy - expert_xy) ** 2, axis=1)
               / lengthscale ** 2 / 2)
    locs, inv = np.unique(pred_xy, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    wsum = np.bincount(inv, weights=w, minlength=len(locs))
    vals = np.asarray(vals, dtype=float).reshape(len(pred_xy), -1)
    merged = np.column_stack([
        np.bincount(inv, weights=w * vals[:, j], minlength=len(locs)) / wsum
        for j in range(vals.shape[1])])
    return locs, merged


def merged_rmse(pred_xy, expert_xy, f, f_bar=0.0):
    """main's accuracy against the truth: RMSE of the merged f* + f_bar
    against the noise-free thickness at the merged locations."""
    locs, merged = merge_weighted(pred_xy, expert_xy, f)
    return float(np.sqrt(np.mean((merged[:, 0] + f_bar
                                  - truth(locs[:, 0], locs[:, 1])) ** 2)))


# ---------------------------------------------------------------------------
# DataFrame wrappers (the JAX driver's functions)
# ---------------------------------------------------------------------------

def synth_sea_ice(n=6000, seed=0, domain=DOMAIN):
    """Synthetic 'thickness' field that tapers to zero at the ice edge, plus a
    radially-varying 'sea-ice concentration' (DataFrame x, y, t, z, sic)."""
    import pandas as pd
    return pd.DataFrame(synth_sea_ice_arrays(n, seed, domain))


def add_sic_pseudo_obs(bin_df, sic_cutoff=0.15, spacing=100 * KM,
                       domain=DOMAIN):
    """Zero-thickness pseudo-observations where SIC < cutoff — anchors the GP
    at the ice edge (reference: extra_funcs.py:149-195)."""
    import pandas as pd
    px, py = sic_pseudo_obs_arrays(sic_cutoff, spacing, domain)
    pseudo = pd.DataFrame({"x": px, "y": py, "t": 0.0, "z": 0.0})
    cprint(f"adding {len(pseudo)} zero-thickness pseudo-observations "
           f"(SIC < {sic_cutoff})", "OKCYAN")
    return pd.concat([bin_df, pseudo], axis=0).reset_index(drop=True)


def synth_secondary_instrument(n_side=40, seed=1, domain=DOMAIN, noise=0.12):
    """Synthetic coarse passive-microwave product: gridded thin-ice thickness,
    only valid where the field is thin (the stand-in for SMAP/SMOS thickness,
    which saturates above ~0.5 m — reference: IS2_SMAP_GPSat_train.py:232)."""
    import pandas as pd
    return pd.DataFrame(synth_secondary_arrays(n_side, seed, domain, noise))


def fuse_secondary_obs(primary_df, secondary_df, value_range=(0.0, 0.5),
                       coarsen_factor=1, day_only=None, exclude_fn=None):
    """Merge a secondary instrument's observations into the training set
    (reference mechanics: IS2_SMAP_GPSat_train.py — thickness-range filter at
    232-242, coarsening at 245-251, region exclusion at 312-319, prediction-
    day-only filter at 405-413, concat with the along-track data at
    1441-1515). Returns the combined DataFrame with a 'source' label.
    exclude_fn takes the rows kept so far (a DataFrame) and returns a bool
    per row."""
    import pandas as pd
    sec = secondary_df.copy()
    exclude = None if exclude_fn is None else \
        (lambda rows: np.asarray(exclude_fn(sec.iloc[rows])))
    rows = secondary_rows(sec["z"].values,
                          sec["t"].values if "t" in sec else None,
                          value_range, coarsen_factor, day_only, exclude)
    sec = sec.iloc[rows].reset_index(drop=True)
    lo, hi = value_range
    cprint(f"fusing {len(sec)} secondary-instrument obs "
           f"(value range [{lo}, {hi}], coarsen {coarsen_factor})", "OKCYAN")
    return pd.concat([primary_df.assign(source="primary"),
                      sec.assign(source="secondary")],
                     axis=0, ignore_index=True)


def bin_sea_ice(df):
    """main's binning of the synthetic observations: bin_arrays (50 km over
    +-1200 km) for each value of t, in the columns and rows of
    DataPrep.bin_data_by(df, by_cols=["t"], ...).to_dataframe().dropna()
    .reset_index()."""
    import pandas as pd
    parts = []
    for t, g in df.groupby("t", sort=True):
        b = bin_arrays(g["x"].values, g["y"].values, g["z"].values)
        parts.append(pd.DataFrame({"y": b["y"], "x": b["x"], "t": t,
                                   "z": b["z"]}))
    return pd.concat(parts, ignore_index=True)


def main(argv=None, device=None):
    """The whole flow on `device` (--device; the card unless the caller
    passes another). Returns the results store's path."""
    ap = argparse.ArgumentParser(
        prog="python -m gpsat_tpu_torch.examples.sea_ice_freeboard_driver")
    ap.add_argument("--num-experts", type=int, default=None,
                    help="cap the expert count (smoke runs)")
    ap.add_argument("--sic", action="store_true", default=True,
                    help="inject SIC ice-edge pseudo observations")
    ap.add_argument("--no-sic", dest="sic", action="store_false")
    ap.add_argument("--plus-secondary", action="store_true",
                    help="fuse a secondary instrument (SMAP-style thin-ice "
                         "thickness) into the training set")
    ap.add_argument("--secondary-csv", default=None,
                    help="CSV with x,y,t,z columns for the secondary "
                         "instrument (synthetic if omitted)")
    ap.add_argument("--secondary-smap-dir", default=None,
                    help="SMAP cache dir: load the real Bremen mix product "
                         "for --secondary-smap-date via satdata."
                         "load_smap_data_for_date as the secondary source")
    ap.add_argument("--secondary-smap-date", default=None,
                    help="YYYY-MM-DD day to load from --secondary-smap-dir")
    ap.add_argument("--secondary-range", type=float, nargs=2,
                    default=(0.0, 0.5),
                    help="valid value range for secondary obs")
    ap.add_argument("--secondary-coarsen", type=int, default=1)
    ap.add_argument("--secondary-day-only", action="store_true",
                    help="only fuse secondary obs at the target day (t==0)")
    ap.add_argument("--expert-spacing", type=float, default=400 * KM)
    ap.add_argument("--store", default=None)
    ap.add_argument("--device", default=device,
                    help="torch device of the engine (default: cuda)")
    # called from code with device= and no argv: the defaults, not sys.argv
    args = ap.parse_args([] if argv is None and device is not None else argv)
    device = resolve_device(args.device)

    import pandas as pd
    from gpsat_tpu_torch.local_experts import (LocalExpertOI,
                                               get_results_from_h5file)
    from gpsat_tpu_torch.postprocessing import smooth_hyperparameters

    df = synth_sea_ice()
    bin_df = bin_sea_ice(df)
    if args.sic:
        bin_df = add_sic_pseudo_obs(bin_df)
    if args.plus_secondary:
        if args.secondary_smap_dir:
            from gpsat_tpu_torch.satdata import load_smap_data_for_date
            assert args.secondary_smap_date, \
                "--secondary-smap-dir needs --secondary-smap-date"
            lo, hi = args.secondary_range
            smap = load_smap_data_for_date(
                args.secondary_smap_date, args.secondary_smap_dir,
                thickness_min=lo, thickness_max=hi,
                coarsen_factor=max(1, args.secondary_coarsen))
            # SMAP rows are day-resolved; the synthetic domain's t axis is
            # days relative to the target day
            sec = pd.DataFrame({"x": smap["x"], "y": smap["y"], "t": 0.0,
                                "z": smap["ice_thickness"]})
            # the loader already applied grid-aware 2-d coarsening — the
            # row-stride coarsening in fuse_secondary_obs must not re-apply
            fuse_coarsen = 1
        elif args.secondary_csv:
            sec = pd.read_csv(args.secondary_csv)
            fuse_coarsen = args.secondary_coarsen
        else:
            sec = synth_secondary_instrument()
            fuse_coarsen = args.secondary_coarsen
        bin_df = fuse_secondary_obs(
            bin_df, sec, value_range=tuple(args.secondary_range),
            coarsen_factor=fuse_coarsen,
            day_only=0.0 if args.secondary_day_only else None)

    eloc = pd.DataFrame(expert_grid(args.expert_spacing, args.num_experts),
                        columns=["x", "y", "t"])
    ploc = pd.DataFrame(prediction_grid(), columns=["x", "y"])

    model_config = {k: dict(v) if isinstance(v, dict) else v
                    for k, v in MODEL_CONFIG.items()}
    store_path = args.store or get_parent_path("results", "sea_ice_driver.h5")
    os.makedirs(os.path.dirname(os.path.abspath(store_path)), exist_ok=True)
    if os.path.exists(store_path):
        os.remove(store_path)

    locexp = LocalExpertOI(
        expert_loc_config={"source": eloc},
        data_config={"data_source": bin_df, "obs_col": "z",
                     "coords_col": ["x", "y", "t"],
                     "local_select": [
                         {"col": "t", "comp": "<=", "val": 4},
                         {"col": "t", "comp": ">=", "val": -4},
                         {"col": ["x", "y"], "comp": "<",
                          "val": TRAIN_RADIUS}]},
        model_config=model_config,
        pred_loc_config={"method": "from_dataframe", "df": ploc,
                         "max_dist": PRED_RADIUS},
        device=device)
    locexp.run(store_path=store_path, optimise=True,
               check_config_compatible=False)

    smooth_hyperparameters(
        result_file=store_path, output_file=store_path,
        params_to_smooth=list(SMOOTH_CONFIG),
        smooth_config_dict={k: dict(v) for k, v in SMOOTH_CONFIG.items()},
        table_suffix="_SMOOTHED", save_config_file=False, device=device)

    model_config_load = dict(model_config)
    model_config_load["load_params"] = {"file": store_path,
                                        "table_suffix": "_SMOOTHED"}
    locexp2 = LocalExpertOI(
        expert_loc_config={"source": eloc},
        data_config=locexp.config["data"] | {"data_source": bin_df},
        model_config=model_config_load,
        pred_loc_config={"method": "from_dataframe", "df": ploc,
                         "max_dist": PRED_RADIUS},
        device=device)
    locexp2.run(store_path=store_path, optimise=False, predict=True,
                table_suffix="_SMOOTHED", check_config_compatible=False)

    dfs, _ = get_results_from_h5file(store_path)
    preds = dfs["preds_SMOOTHED"]
    pred_xy = preds[["pred_loc_x", "pred_loc_y"]].values
    expert_xy = preds[["x", "y"]].values
    locs, merged = merge_weighted(pred_xy, expert_xy,
                                  preds[["f*", "f*_var"]].values)
    # export the merged field (the reference exports NetCDF; CSV here)
    out_csv = store_path.replace(".h5", "_merged.csv")
    pd.DataFrame({"pred_loc_x": locs[:, 0], "pred_loc_y": locs[:, 1],
                  "f*": merged[:, 0], "f*_var": merged[:, 1]}) \
        .to_csv(out_csv, index=False)
    cprint(f"merged field ({len(locs)} points) -> {out_csv}", "OKGREEN")

    # accuracy vs truth (thickness without noise)
    rmse = merged_rmse(pred_xy, expert_xy, preds["f*"].values,
                       preds["f_bar"].mean())
    cprint(f"merged thickness RMSE vs truth: {rmse:.4f} m "
           f"(obs noise 0.10 m)", "OKGREEN")
    return store_path


if __name__ == "__main__":
    main()
