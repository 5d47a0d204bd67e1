"""Plot predictions/hyperparameters from a results store (the port's
counterpart of examples/plot_from_results.py):

    python -m gpsat_tpu_torch.examples.plot_from_results <config.json>
"""

from gpsat_tpu_torch import get_parent_path
from gpsat_tpu_torch.utils import cprint, get_config_from_sysargv


def main():
    import matplotlib
    matplotlib.use("Agg")
    from gpsat_tpu_torch.local_experts import get_results_from_h5file
    from gpsat_tpu_torch.plot_utils import plot_hyper_parameters

    config = get_config_from_sysargv() or {}
    result_file = config.get("result_file",
                             get_parent_path("results", "inline_example.h5"))
    dfs, oi_config = get_results_from_h5file(result_file)
    coords_col = oi_config[0]["data"]["coords_col"] if oi_config else ["x", "y", "t"]
    fig = plot_hyper_parameters(
        dfs, coords_col=coords_col,
        table_names=config.get("table_names",
                               ["lengthscales", "kernel_variance",
                                "likelihood_variance"]),
        table_suffix=config.get("table_suffix", ""),
        suptitle=config.get("suptitle", "hyper parameters"))
    out = config.get("output", get_parent_path("results", "results_plot.png"))
    if fig is not None:
        fig.savefig(out, dpi=100)
        cprint(f"saved plot to {out}", "OKGREEN")


if __name__ == "__main__":
    main()
