"""Reviewing raw observations before interpolation (the port's counterpart
of examples/data_review.py, a py-percent walkthrough; here its cells are the
steps of `main`).

Sweep raw satellite track files into one table, summarise the value column,
inspect its distribution, project to the working plane, and check what
binning does to coverage and noise — the sanity pass you run before
committing to an OI sweep. No step computes on the device.

Run: python -m gpsat_tpu_torch.examples.data_review
"""

import os

import numpy as np

from gpsat_tpu_torch import get_data_path, get_parent_path
from gpsat_tpu_torch.utils import WGS84toEASE2, cprint, stats_on_vals

KM = 1000.0


def main():
    """Run the review; returns the per-source binned summary."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from gpsat_tpu_torch.dataloader import DataLoader
    from gpsat_tpu_torch.dataprepper import DataPrep
    from gpsat_tpu_torch.plot_utils import plot_hist, plot_wrapper

    # 1. Sweep the raw track files: `read_flat_files` concatenates every
    # matching file, with a `source` tag from the filename.
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
    df["t"] = np.asarray(df["datetime"]).astype("datetime64[D]").astype(float)

    # 2. Summary statistics on the value column: the first check for unit
    # mistakes and outliers.
    print(stats_on_vals(df["z"].values, name="z",
                        qs=[0.01, 0.05, 0.5, 0.95, 0.99]))

    # 3. Distribution + outlier cut (|z| < 1 before binning).
    fig, axs = plt.subplots(1, 2, figsize=(10, 3.6))
    plot_hist(axs[0], df["z"].values, title="raw z", xlabel="z")
    plot_hist(axs[1], df.loc[df["z"].abs() < 1, "z"].values,
              title="after |z| < 1 cut", xlabel="z")
    fig.tight_layout()
    plt.close(fig)

    # 4. Where are the observations? Project lon/lat to the EASE2 working
    # plane and draw the polar-projected scatter.
    df["x"], df["y"] = WGS84toEASE2(df["lon"].values, df["lat"].values,
                                    lat_0=90, lon_0=0)
    fig, obs_stats = plot_wrapper(df, val_col="z", max_obs=100_000)
    out_png = get_parent_path("results", "data_review_observations.png")
    os.makedirs(os.path.dirname(out_png), exist_ok=True)
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
    cprint(f"saved plot to {out_png}", "OKGREEN")

    # 5. Bin (100 km) and compare raw scatter with the binned field, and the
    # cells each source contributes.
    bin_ds = DataPrep.bin_data_by(
        df=df.loc[df["z"].abs() < 1], by_cols=["t", "source"], val_col="z",
        grid_res=100 * KM, x_range=[-1500 * KM, 1500 * KM],
        y_range=[-1500 * KM, 1500 * KM])
    bin_df = bin_ds.to_dataframe().dropna().reset_index()
    per_source = bin_df.groupby("source")["z"].agg(["count", "mean", "std"])
    print(per_source)

    fig, axs = plt.subplots(1, 2, figsize=(11, 4.6))
    sub_all = df.loc[df["z"].abs() < 1]
    sub = sub_all.sample(min(len(sub_all), 20_000), random_state=0)
    axs[0].scatter(sub["x"] / KM, sub["y"] / KM, c=sub["z"], s=2,
                   cmap="RdBu_r", vmin=-0.6, vmax=0.6)
    axs[0].set_title(f"raw tracks (sample of {len(sub)})")
    sc2 = axs[1].scatter(bin_df["x"] / KM, bin_df["y"] / KM, c=bin_df["z"],
                         s=14, marker="s", cmap="RdBu_r", vmin=-0.6, vmax=0.6)
    axs[1].set_title(f"binned 100 km ({len(bin_df)} cells)")
    for ax in axs:
        ax.set_aspect("equal")
        ax.set_xlabel("x (km)")
        ax.set_ylabel("y (km)")
    fig.colorbar(sc2, ax=axs, shrink=0.8, label="z")
    out_png = get_parent_path("results", "data_review_binned.png")
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
    cprint(f"saved plot to {out_png}", "OKGREEN")

    # 6. Noise estimate: the binned per-cell std should be of the order of
    # the generator's noise (sigma = 0.05) and sets a sensible
    # likelihood_variance range for the OI configs.
    cell_std = float(per_source["std"].mean())
    cprint(f"mean within-source binned std: {cell_std:.3f} "
           f"(generator noise 0.05)", "OKGREEN")
    return per_source


if __name__ == "__main__":
    main()
