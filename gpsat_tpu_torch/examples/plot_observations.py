"""Plot raw/binned observations from a store (the port's counterpart of
examples/plot_observations.py):

    python -m gpsat_tpu_torch.examples.plot_observations <config.json>
"""

from gpsat_tpu_torch import get_parent_path
from gpsat_tpu_torch.utils import cprint, get_config_from_sysargv


def main():
    import matplotlib
    matplotlib.use("Agg")
    from gpsat_tpu_torch.dataloader import DataLoader
    from gpsat_tpu_torch.plot_utils import plot_wrapper

    config = get_config_from_sysargv() or {}
    load_kwargs = config.get("input", config)
    df = DataLoader.load(**load_kwargs)
    val_col = config.get("val_col", "z")
    fig, stats = plot_wrapper(df, val_col=val_col,
                              max_obs=config.get("max_obs", 500_000))
    out = config.get("output", get_parent_path("results", "observations.png"))
    fig.savefig(out, dpi=100)
    cprint(f"saved plot to {out}", "OKGREEN")
    print(stats)


if __name__ == "__main__":
    main()
