"""Worked example: optimal interpolation end to end (the port's counterpart
of examples/worked_example.py, a py-percent walkthrough of
docs/worked_example.md; here its cells are the steps of `main`).

Output: `results/worked_example.h5` (preds / smoothed preds / params /
run details) and `results/worked_example_field.png` (merged field vs ground
truth, error and predictive std), plus a truth-recovery RMSE printout.

Run: python -m gpsat_tpu_torch.examples.worked_example [--device D]
(on the card unless D is given)
"""

import argparse
import os

import numpy as np

from gpsat_tpu_torch import get_data_path, get_parent_path, resolve_device
from gpsat_tpu_torch.utils import (WGS84toEASE2, cprint, get_weighted_values,
                                   grid_2d_flatten)

KM = 1000.0


def main(argv=None, device=None):
    """The walkthrough on `device` (--device; the card unless the caller
    passes another). Returns the truth-recovery RMSE."""
    ap = argparse.ArgumentParser(
        prog="python -m gpsat_tpu_torch.examples.worked_example")
    ap.add_argument("--device", default=device,
                    help="torch device of the engine (default: cuda)")
    # called from code with device= and no argv: the defaults, not sys.argv
    args = ap.parse_args([] if argv is None and device is not None else argv)
    device = resolve_device(args.device)

    import pandas as pd
    from gpsat_tpu_torch.dataloader import DataLoader
    from gpsat_tpu_torch.dataprepper import DataPrep
    from gpsat_tpu_torch.examples.generate_example_data import truth_field
    from gpsat_tpu_torch.local_experts import (LocalExpertOI,
                                               get_results_from_h5file)
    from gpsat_tpu_torch.postprocessing import smooth_hyperparameters

    # 1. Raw data -> projected table: flat files of (lon, lat, datetime,
    # value), tagged with their source, projected to EASE2 and a day axis.
    data_dir = get_data_path("example")
    if not os.path.exists(os.path.join(data_dir, "A_RAW.csv")):
        from gpsat_tpu_torch.examples.generate_example_data import \
            main as gen_data
        gen_data()

    df = DataLoader.read_flat_files(
        file_dirs=data_dir, file_regex=r"_RAW\.csv$",
        col_funcs={"source": {
            "func": lambda fp: os.path.basename(fp).split("_")[0],
            "filename_as_arg": True}})
    df["x"], df["y"] = WGS84toEASE2(df["lon"].values, df["lat"].values,
                                    lat_0=90, lon_0=0)
    # np.asarray, not .values: pandas may back str columns with Arrow
    # arrays whose .astype rejects datetime64[D]
    df["t"] = np.asarray(df["datetime"]).astype("datetime64[D]").astype(float)
    cprint(f"raw rows: {len(df)}, sources: {sorted(df['source'].unique())}",
           "OKGREEN")

    # 2. Bin to a working resolution: a 2-d binned mean per (day, source).
    bin_df = DataPrep.bin_data_by(
        df=df.loc[df["z"].abs() < 1], by_cols=["t", "source"], val_col="z",
        grid_res=100 * KM, x_range=[-1500 * KM, 1500 * KM],
        y_range=[-1500 * KM, 1500 * KM]).to_dataframe().dropna().reset_index()
    cprint(f"binned rows: {len(bin_df)}", "OKGREEN")

    # 3. Expert and prediction grids: experts on a coarse grid, predictions
    # on a fine one within max_dist of each expert.
    eloc = pd.DataFrame(grid_2d_flatten([-1000 * KM, 1000 * KM],
                                        [-1000 * KM, 1000 * KM],
                                        step_size=400 * KM),
                        columns=["x", "y"])
    eloc["t"] = np.floor(df["t"].mean())
    ploc = pd.DataFrame(grid_2d_flatten([-1000 * KM, 1000 * KM],
                                        [-1000 * KM, 1000 * KM],
                                        step_size=50 * KM),
                        columns=["x", "y"])

    # 4. Configure + run the sweep. With coords_scale set, lengthscale bounds
    # are in physical units.
    store = get_parent_path("results", "worked_example.h5")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)

    data = {"data_source": bin_df, "obs_col": "z",
            "coords_col": ["x", "y", "t"],
            "local_select": [{"col": "t", "comp": "<=", "val": 2},
                             {"col": "t", "comp": ">=", "val": -2},
                             {"col": ["x", "y"], "comp": "<",
                              "val": 500 * KM}]}
    model = {"oi_model": "GPRModel",
             "init_params": {"coords_scale": [100 * KM, 100 * KM, 1]},
             "constraints": {"lengthscales": {"low": [1e-8] * 3,
                                              "high": [600 * KM, 600 * KM, 9]},
                             "likelihood_variance": {"low": 0.00125,
                                                     "high": 0.25}}}
    pred_loc = {"method": "from_dataframe", "df": ploc, "max_dist": 400 * KM}

    oi = LocalExpertOI(expert_loc_config={"source": eloc}, data_config=data,
                       model_config=model, pred_loc_config=pred_loc,
                       device=device)
    oi.run(store_path=store, optimise=True)

    # 5. Read back, smooth, re-predict without re-optimising.
    smooth_hyperparameters(
        result_file=store,
        params_to_smooth=["lengthscales", "kernel_variance",
                          "likelihood_variance"],
        smooth_config_dict={"lengthscales": {"l_x": 400 * KM,
                                             "l_y": 400 * KM},
                            "kernel_variance": {"l_x": 400 * KM,
                                                "l_y": 400 * KM, "max": 0.5},
                            "likelihood_variance": {"l_x": 400 * KM,
                                                    "l_y": 400 * KM,
                                                    "max": 0.3}},
        table_suffix="_SMOOTHED", save_config_file=True, device=device)

    model_load = {**model, "load_params": {"file": store,
                                           "table_suffix": "_SMOOTHED"}}
    oi2 = LocalExpertOI(expert_loc_config={"source": eloc}, data_config=data,
                        model_config=model_load, pred_loc_config=pred_loc,
                        device=device)
    oi2.run(store_path=store, optimise=False, predict=True,
            table_suffix="_SMOOTHED")

    # 6. Merge overlapping predictions with Gaussian distance weights and
    # score against the known truth (noise sigma = 0.05).
    dfs, _ = get_results_from_h5file(store)
    merged = get_weighted_values(
        df=dfs["preds_SMOOTHED"],
        ref_col=["pred_loc_x", "pred_loc_y", "pred_loc_t"],
        dist_to_col=["x", "y", "t"], val_cols=["f*", "f*_var"],
        weight_function="gaussian", lengthscale=200 * KM)
    truth = truth_field(merged["pred_loc_x"].values,
                        merged["pred_loc_y"].values)
    rmse = float(np.sqrt(np.mean((merged["f*"].values - truth) ** 2)))
    cprint(f"truth-recovery RMSE: {rmse:.4f} (raw obs noise 0.05)", "OKGREEN")

    # 7. Plots: merged field, truth, error and predictive std.
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axs = plt.subplots(2, 2, figsize=(11, 9))
    panels = [("merged f*", merged["f*"].values),
              ("truth", truth),
              ("error (f* - truth)", merged["f*"].values - truth),
              ("predictive std", np.sqrt(np.maximum(merged["f*_var"].values,
                                                    0.0)))]
    for ax, (title, vals) in zip(axs.ravel(), panels):
        sc = ax.scatter(merged["pred_loc_x"] / KM, merged["pred_loc_y"] / KM,
                        c=vals, s=8, cmap="RdBu_r" if "error" in title
                        else "viridis")
        ax.set_title(title)
        ax.set_aspect("equal")
        ax.set_xlabel("x (km)")
        ax.set_ylabel("y (km)")
        fig.colorbar(sc, ax=ax, shrink=0.85)
    fig.suptitle(f"worked example — merged OI field (RMSE {rmse:.4f})")
    out_png = get_parent_path("results", "worked_example_field.png")
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    cprint(f"saved plot to {out_png}", "OKGREEN")
    return rmse


if __name__ == "__main__":
    main()
