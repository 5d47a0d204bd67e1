"""Cross-validation performance analysis: score + visualise held-out folds
(the port's counterpart of examples/evaluate_xval_performance.py).

Runnable counterpart of the reference's archive xval analysis workflow
(reference: examples/Archive/evaluate_xval_performance.py — per-fold/track
RMSE + NLL from xval prediction tables; and
examples/Archive/xval_on_single_track_analysis.py — per-point weighted-merge
diagnostics: diff, norm_diff, nll, map + histogram panels).

Three layers, each usable on its own:

- ``xval_point_frame``   — per held-out point: weighted-merged prediction,
  truth, ``diff``, ``norm_diff`` (diff / predictive sigma), per-point ``nll``.
- ``xval_fold_summary``  — per fold: n, rmse, mean nll, mean/std norm_diff.
- ``main``               — CLI: optionally *runs* the folds produced by
  ``gpsat_tpu_torch.examples.create_xval_config`` (when their tables are missing from the
  store), scores them, prints the per-fold table + aggregate, and renders
  the reference's two-panel figure (spatial scatter of ``norm_diff``/``nll``
  + histogram with summary stats).

Usage::

  python -m gpsat_tpu_torch.examples.create_xval_config configs/example_xval_reference_config.json
  python -m gpsat_tpu_torch.examples.evaluate_xval_performance configs/example_evaluate_xval.json [--device D]

with config keys: ``fold_configs`` (JSON list written by create_xval_config),
``store`` (results h5; per-fold tables namespaced by table_suffix),
``run_missing`` (run folds whose tables are absent), ``inference_radius``,
``plot`` (output PNG), ``plot_col`` (norm_diff | nll | diff), ``to_lonlat``.
The folds run on the card unless --device names another.
"""

import argparse
import json
import os

import numpy as np

from gpsat_tpu_torch import resolve_device
from gpsat_tpu_torch.utils import cprint, get_weighted_values, nll, rmse

__all__ = ["xval_point_frame", "xval_fold_summary", "run_missing_folds"]


def xval_point_frame(store_path, suffixes, obs_df, coords_col=("x", "y"),
                     obs_col="z", inference_radius=None, round_decimals=6):
    """Per held-out point diagnostics for each xval fold.

    Predictions from all experts covering a held-out location are merged
    with Gaussian weights (reference: xval_on_single_track_analysis.py
    get_weighted_values usage), then joined to the true observations on the
    rounded prediction coordinates (reference rounds pred_loc to make
    coordinates consistent, evaluate_xval_performance.py:54-56).

    Returns a DataFrame with one row per (fold, held-out point):
    coords, `obs`, `f*` (de-meaned), `f_bar`, `mu` (= f* + f_bar), `y_var`,
    `diff` (obs - mu), `norm_diff` (diff / sqrt(y_var)), `nll`, `fold`.
    """
    import pandas as pd
    from gpsat_tpu_torch.local_experts import get_results_from_h5file
    coords_col = list(coords_col)
    frames = []
    for suffix in suffixes:
        dfs, _ = get_results_from_h5file(store_path, table_suffix=suffix,
                                         merge_on_expert_locations=False)
        pred_tab = f"preds{suffix}"
        if pred_tab not in dfs:
            continue
        preds = dfs[pred_tab]
        ref_cols = [f"pred_loc_{c}" for c in coords_col]
        ls = inference_radius / 2 if inference_radius else \
            np.median(np.abs(preds[ref_cols[0]] - preds[coords_col[0]])) + 1e-9
        merged = get_weighted_values(preds, ref_col=ref_cols,
                                     dist_to_col=coords_col,
                                     val_cols=["f*", "y_var", "f_bar"],
                                     lengthscale=ls)
        merged = merged.rename(columns={rc: c for rc, c in
                                        zip(ref_cols, coords_col)})
        for c in coords_col:
            merged[c] = merged[c].round(round_decimals)
        truth = obs_df.copy()
        for c in coords_col:
            truth[c] = truth[c].round(round_decimals)
        joined = merged.merge(truth[coords_col + [obs_col]], on=coords_col,
                              how="inner")
        if len(joined) == 0:
            continue
        joined["mu"] = joined["f*"] + joined["f_bar"]
        joined["diff"] = joined[obs_col] - joined["mu"]
        sig = np.sqrt(joined["y_var"].values)
        joined["norm_diff"] = joined["diff"] / sig
        joined["nll"] = nll(joined[obs_col].values, joined["mu"].values,
                            sig, return_tot=False)
        joined["fold"] = suffix
        frames.append(joined)
    if not frames:
        return pd.DataFrame()
    return pd.concat(frames, ignore_index=True)


def xval_fold_summary(points, obs_col="z"):
    """Per-fold score table from an `xval_point_frame` result."""
    import pandas as pd
    rows = []
    for suffix, g in points.groupby("fold", sort=False):
        rows.append({
            "fold": suffix, "n": len(g),
            "rmse": rmse(g[obs_col].values, g["mu"].values),
            "nll": float(g["nll"].mean()),
            "norm_diff_mean": float(g["norm_diff"].mean()),
            "norm_diff_std": float(g["norm_diff"].std()),
        })
    return pd.DataFrame(rows)


def run_missing_folds(fold_configs, store_path, verbose=False, device=None):
    """Run each fold config whose prediction table is absent from the store,
    on `device` (the card unless the caller passes another).

    `fold_configs` is the JSON list written by create_xval_config (each
    entry carries data/model/pred_loc plus run_kwargs.table_suffix).
    """
    from gpsat_tpu_torch.local_experts import LocalExpertOI

    have = set()
    if os.path.exists(store_path):
        import h5py
        with h5py.File(store_path, "r") as f:
            have = set(f.keys())
    for cfg in fold_configs:
        suffix = cfg.get("run_kwargs", {}).get("table_suffix", "")
        if f"preds{suffix}" in have:
            continue
        cprint(f"running fold {suffix!r}", "OKBLUE")
        locexp = LocalExpertOI(
            expert_loc_config=cfg.get("locations") or cfg.get("expert_locs"),
            data_config=cfg["data"], model_config=cfg["model"],
            pred_loc_config=cfg.get("pred_loc"), device=device)
        run_kwargs = dict(cfg.get("run_kwargs", {}))
        # keys this driver sets itself win over whatever the reference
        # config carried (fold tables share one store; config-id checks are
        # per-fold meaningless since each fold's config differs)
        for k in ("store_path", "check_config_compatible", "optimise",
                  "verbose"):
            run_kwargs.pop(k, None)
        locexp.run(store_path=store_path, optimise=True, verbose=verbose,
                   check_config_compatible=False, **run_kwargs)


def _two_panel_figure(points, plot_col, out_path, coords_col, to_lonlat=False):
    """Reference figure: spatial scatter of `plot_col` + histogram with
    summary stats (xval_on_single_track_analysis.py:160-186)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from gpsat_tpu_torch.plot_utils import plot_hist

    fig, axs = plt.subplots(1, 2, figsize=(13, 5.5))
    x, y = points[coords_col[0]], points[coords_col[1]]
    xlabel, ylabel = coords_col[0], coords_col[1]
    if to_lonlat:
        from gpsat_tpu_torch.utils import EASE2toWGS84
        x, y = EASE2toWGS84(x.values, y.values)
        xlabel, ylabel = "lon", "lat"
    vals = points[plot_col].values
    if plot_col == "norm_diff":
        vmax = float(np.nanquantile(np.abs(vals), 0.99))
        kw = dict(cmap="bwr", vmin=-vmax, vmax=vmax)
    else:
        kw = dict(cmap="YlGnBu_r",
                  vmin=float(np.nanquantile(vals, 0.05)),
                  vmax=float(np.nanquantile(vals, 0.95)))
    sc = axs[0].scatter(x, y, c=vals, s=8, **kw)
    axs[0].set_xlabel(xlabel); axs[0].set_ylabel(ylabel)
    axs[0].set_title(f"held-out {plot_col} ({len(points)} points)")
    fig.colorbar(sc, ax=axs[0], shrink=0.85, label=plot_col)
    plot_hist(axs[1], data=vals,
              stats_values=["mean", "std", "skew", "kurtosis", "min", "max",
                            "num obs"])
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    cprint(f"saved xval analysis figure to {out_path}", "OKGREEN")


def main(argv=None, device=None):
    """Score (and with run_missing, first run on `device`: --device, the card
    unless the caller passes another) the folds of a config. Returns the
    per-fold summary."""
    ap = argparse.ArgumentParser(
        prog="python -m gpsat_tpu_torch.examples.evaluate_xval_performance")
    ap.add_argument("config", nargs="?", default=None,
                    help="JSON config (fold_configs, store, ...)")
    ap.add_argument("--device", default=device,
                    help="torch device of the engine (default: cuda)")
    # called from code with device= and no argv: the defaults, not sys.argv
    args = ap.parse_args([] if argv is None and device is not None else argv)
    device = resolve_device(args.device)
    if args.config is None:
        print("usage: python -m gpsat_tpu_torch.examples."
              "evaluate_xval_performance <config.json> [--device D]")
        return
    import pandas as pd
    from gpsat_tpu_torch.dataloader import DataLoader
    from gpsat_tpu_torch.utils import nested_dict_literal_eval
    with open(args.config) as f:
        config = nested_dict_literal_eval(json.load(f))

    fold_cfg_path = config["fold_configs"]
    with open(fold_cfg_path) as f:
        fold_configs = json.load(f)
    store_path = config["store"]
    if config.get("run_missing"):
        run_missing_folds(fold_configs, store_path,
                          verbose=config.get("verbose", False),
                          device=device)

    # the truth for each fold is its held-out subset: pred_loc load_kwargs
    # reproduce exactly the rows that were held out of training
    first = fold_configs[0]
    obs_col = first["data"].get("obs_col", "z")
    coords_col = config.get("coords_col")
    if coords_col is None:
        coords_col = [c for c in first["data"].get("coords_col", ["x", "y"])
                      if c not in ("t",)][:2]
    suffixes, truths = [], []
    for cfg in fold_configs:
        suffix = cfg.get("run_kwargs", {}).get("table_suffix", "")
        suffixes.append(suffix)
        lk = cfg.get("pred_loc", {}).get("load_kwargs")
        if lk:
            t = DataLoader.load(**lk)
            t["__fold"] = suffix
            truths.append(t)
    obs_df = pd.concat(truths, ignore_index=True)

    points = xval_point_frame(
        store_path, suffixes, obs_df, coords_col=coords_col, obs_col=obs_col,
        inference_radius=config.get("inference_radius"))
    if len(points) == 0:
        cprint("no held-out predictions found — run the folds first "
               "(run_missing: true)", "FAIL")
        return

    summary = xval_fold_summary(points, obs_col=obs_col)
    cprint("per-fold held-out scores:", "HEADER")
    print(summary.to_string(index=False))
    cprint(f"aggregate: rmse {summary['rmse'].mean():.4f} "
           f"(+- {summary['rmse'].std():.4f}), "
           f"nll {summary['nll'].mean():.4f} "
           f"(+- {summary['nll'].std():.4f})", "OKGREEN")

    if config.get("plot"):
        _two_panel_figure(points, config.get("plot_col", "norm_diff"),
                          config["plot"], coords_col,
                          to_lonlat=config.get("to_lonlat", False))
    return summary


if __name__ == "__main__":
    main()
