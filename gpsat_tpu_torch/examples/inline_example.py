"""Inline example: local-expert optimal interpolation end-to-end, the
canonical exact-GPR recipe (the port's counterpart of
examples/inline_example.py).

Flow: read raw satellite CSVs -> project to EASE2 xy -> bin to a 100 km grid
-> expert grid -> batched OI (exact GPR) -> smooth hyperparameters ->
re-predict with smoothed parameters -> Gaussian-weighted merge -> plots.

Run: python -m gpsat_tpu_torch.examples.inline_example [--device D]
(generates synthetic data if absent; runs on the card unless D is given)
"""

import argparse
import os
import re

import numpy as np

from gpsat_tpu_torch import get_data_path, get_parent_path, resolve_device
from gpsat_tpu_torch.utils import (EASE2toWGS84, WGS84toEASE2, cprint,
                                   get_weighted_values, grid_2d_flatten,
                                   stats_on_vals)

KM = 1000.0

# parameters (mirroring the reference example's choices)
lat_0, lon_0 = 90, 0
expert_spacing = 400 * KM
expert_x_range = [-1000 * KM, 1000 * KM]
expert_y_range = [-1000 * KM, 1000 * KM]
pred_spacing = 50 * KM
training_radius = 500 * KM
inference_radius = 400 * KM


def main(make_plots=True, device=None):
    """The recipe on `device` (the card unless the caller passes another);
    returns the results store's path. A plot that fails makes the run
    fail."""
    import pandas as pd
    from gpsat_tpu_torch.dataloader import DataLoader
    from gpsat_tpu_torch.dataprepper import DataPrep
    from gpsat_tpu_torch.local_experts import (LocalExpertOI,
                                               get_results_from_h5file)
    from gpsat_tpu_torch.postprocessing import smooth_hyperparameters

    device = resolve_device(device)
    # -- raw data ---------------------------------------------------------
    data_dir = get_data_path("example")
    if not os.path.exists(os.path.join(data_dir, "A_RAW.csv")):
        from gpsat_tpu_torch.examples.generate_example_data import main as gen
        gen(data_dir)

    df = DataLoader.read_flat_files(
        file_dirs=data_dir, file_regex=r"_RAW\.csv$",
        col_funcs={"source": {
            "func": lambda fp: re.sub("_RAW.*$", "", os.path.basename(fp)),
            "filename_as_arg": True}})

    df["x"], df["y"] = WGS84toEASE2(df["lon"].values, df["lat"].values,
                                    lat_0=lat_0, lon_0=lon_0)
    # np.asarray, not .values: pandas may back str columns with Arrow
    # arrays whose .astype rejects datetime64[D]
    df["t"] = np.asarray(df["datetime"]).astype("datetime64[D]").astype(float)

    cprint("stats on raw z", "OKBLUE")
    print(stats_on_vals(df["z"].values, name="z"))

    # -- bin --------------------------------------------------------------
    bin_ds = DataPrep.bin_data_by(
        df=df.loc[(df["z"] > -1) & (df["z"] < 1)],
        by_cols=["t", "source"], val_col="z", x_col="x", y_col="y",
        grid_res=100 * KM, x_range=[-1500 * KM, 1500 * KM],
        y_range=[-1500 * KM, 1500 * KM])
    bin_df = bin_ds.to_dataframe().dropna().reset_index()

    # -- expert + prediction locations ------------------------------------
    eloc = pd.DataFrame(grid_2d_flatten(expert_x_range, expert_y_range,
                                        step_size=expert_spacing),
                        columns=["x", "y"])
    eloc["t"] = np.floor(df["t"].mean())

    ploc = pd.DataFrame(grid_2d_flatten(expert_x_range, expert_y_range,
                                        step_size=pred_spacing),
                        columns=["x", "y"])

    # -- configs ----------------------------------------------------------
    data = {"data_source": bin_df, "obs_col": "z",
            "coords_col": ["x", "y", "t"],
            "local_select": [
                {"col": "t", "comp": "<=", "val": 2},
                {"col": "t", "comp": ">=", "val": -2},
                {"col": ["x", "y"], "comp": "<", "val": training_radius}]}
    local_expert = {"source": eloc}
    model = {"oi_model": "GPRModel",
             "init_params": {"coords_scale": [100 * KM, 100 * KM, 1]},
             "constraints": {
                 "lengthscales": {"low": [1e-08, 1e-08, 1e-08],
                                  "high": [600 * KM, 600 * KM, 9]},
                 "likelihood_variance": {"low": 0.00125, "high": 0.25}}}
    pred_loc = {"method": "from_dataframe", "df": ploc,
                "max_dist": inference_radius}

    # -- run OI -----------------------------------------------------------
    store_path = get_parent_path("results", "inline_example.h5")
    os.makedirs(os.path.dirname(store_path), exist_ok=True)
    if os.path.exists(store_path):
        cprint(f"removing: {store_path}", "FAIL")
        os.remove(store_path)

    locexp = LocalExpertOI(expert_loc_config=local_expert, data_config=data,
                           model_config=model, pred_loc_config=pred_loc,
                           device=device)
    locexp.run(store_path=store_path, optimise=True,
               check_config_compatible=False)

    dfs, oi_config = get_results_from_h5file(store_path)
    cprint(f"tables in results file: {list(dfs.keys())}", "OKGREEN")

    # -- smooth hyperparameters + re-predict ------------------------------
    smooth_hyperparameters(
        result_file=store_path, output_file=store_path,
        params_to_smooth=["lengthscales", "kernel_variance",
                          "likelihood_variance"],
        smooth_config_dict={
            "lengthscales": {"l_x": 400 * KM, "l_y": 400 * KM},
            "likelihood_variance": {"l_x": 400 * KM, "l_y": 400 * KM,
                                    "max": 0.3},
            "kernel_variance": {"l_x": 400 * KM, "l_y": 400 * KM, "max": 0.5}},
        table_suffix="_SMOOTHED", save_config_file=True, device=device)

    model_load = dict(model)
    model_load["load_params"] = {"file": store_path,
                                 "table_suffix": "_SMOOTHED"}
    locexp_smooth = LocalExpertOI(expert_loc_config=local_expert,
                                  data_config=data, model_config=model_load,
                                  pred_loc_config=pred_loc, device=device)
    locexp_smooth.run(store_path=store_path, optimise=False, predict=True,
                      table_suffix="_SMOOTHED", check_config_compatible=False)

    # -- weighted merge ---------------------------------------------------
    dfs, _ = get_results_from_h5file(store_path)
    plt_data = get_weighted_values(
        df=dfs["preds_SMOOTHED"],
        ref_col=["pred_loc_x", "pred_loc_y", "pred_loc_t"],
        dist_to_col=["x", "y", "t"], val_cols=["f*", "f*_var"],
        weight_function="gaussian", lengthscale=inference_radius / 2)

    # accuracy vs known truth
    truth_path = os.path.join(data_dir, "ground_truth.csv")
    if os.path.exists(truth_path):
        from gpsat_tpu_torch.examples.generate_example_data import truth_field
        zt = truth_field(plt_data["pred_loc_x"].values,
                         plt_data["pred_loc_y"].values)
        fb = dfs["preds_SMOOTHED"]["f_bar"].mean()
        rmse = float(np.sqrt(np.mean((plt_data["f*"].values + fb - zt) ** 2)))
        cprint(f"merged prediction RMSE vs ground truth: {rmse:.4f}", "OKGREEN")

    # -- plots ------------------------------------------------------------
    if make_plots:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from gpsat_tpu_torch.plot_utils import (plot_hyper_parameters,
                                                plot_pcolormesh)
        fig = plot_hyper_parameters(
            dfs, coords_col=["x", "y", "t"],
            table_names=["lengthscales", "kernel_variance",
                         "likelihood_variance"],
            table_suffix="_SMOOTHED", suptitle="smoothed hyper params")
        out_png = get_parent_path("results", "inline_example_hypers.png")
        fig.savefig(out_png, dpi=100)
        lon, lat = EASE2toWGS84(plt_data["pred_loc_x"].values,
                                plt_data["pred_loc_y"].values)
        fig2, ax = plt.subplots(figsize=(8, 8))
        plot_pcolormesh(ax, lon, lat, plt_data["f*"].values, fig=fig2,
                        scatter=True, s=6, title="merged predictions")
        fig2.savefig(get_parent_path("results", "inline_example_preds.png"),
                     dpi=100)
        plt.close(fig)
        plt.close(fig2)
        cprint(f"plots saved under {get_parent_path('results')}", "OKGREEN")

    return store_path


if __name__ == "__main__":
    ap = argparse.ArgumentParser(
        prog="python -m gpsat_tpu_torch.examples.inline_example")
    ap.add_argument("--device", default=None,
                    help="torch device of the engine (default: cuda)")
    ap.add_argument("--no-plots", dest="make_plots", action="store_false")
    args = ap.parse_args()
    main(make_plots=args.make_plots, device=args.device)
