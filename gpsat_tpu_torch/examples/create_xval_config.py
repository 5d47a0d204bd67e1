"""Cross-validation config generation + evaluation (the port's counterpart
of examples/create_xval_config.py).

Hold-out validation the reference way (reference: examples/create_xval_config.py:
157-299): each fold's held-out rows are removed from training via a *negated*
row_select and simultaneously become the prediction locations via
pred_loc method='from_source' with the un-negated row_select; fold results are
namespaced with a per-fold table_suffix. Scoring uses rmse / nll
(reference: examples/Archive/evaluate_xval_performance.py).

Usage:
  python -m gpsat_tpu_torch.examples.create_xval_config <xval_config.json>
with {"reference_config": <path or dict>, "xval": {"col": ..., "vals": [...]}}
"""

import copy
import json

import numpy as np

from gpsat_tpu_torch.utils import (cprint, get_config_from_sysargv,
                                   json_serializable, nll, rmse)

__all__ = ["create_xval_configs", "evaluate_xval"]


def create_xval_configs(reference_config, xval_col=None, xval_vals=None,
                        folds=None, table_suffix_fmt="_xval{i}"):
    """Build per-fold experiment configs from a reference config.

    Parameters
    ----------
    reference_config : dict with data/model/locations/pred_loc/run_kwargs.
    xval_col : column defining folds (e.g. 'track' or 't'); each unique value
        (or each entry of xval_vals) is one hold-out fold.
    xval_vals : explicit fold values; required unless `folds` given.
    folds : alternatively, a list of row_select dicts (one per fold).

    Returns
    -------
    list of fold configs (deep copies of the reference config).
    """
    if folds is None:
        assert xval_col is not None and xval_vals is not None, \
            "provide either folds or (xval_col, xval_vals)"
        folds = [{"col": xval_col, "comp": "==", "val": v} for v in xval_vals]

    data_src_cfg = reference_config.get("data", {})
    out = []
    for i, fold_rs in enumerate(folds):
        cfg = copy.deepcopy(reference_config)
        data = cfg.setdefault("data", {})
        rs = data.get("row_select") or []
        # hold the fold OUT of training (negated row select,
        # reference: create_xval_config.py:265-268; negate mechanism
        # dataloader.py:1933)
        data["row_select"] = list(rs) + [{**fold_rs, "negate": True}]
        # and predict AT the held-out rows (reference: 270-284)
        load_kwargs = {
            "source": data_src_cfg.get("data_source"),
            "table": data_src_cfg.get("table"),
            "row_select": list(rs) + [fold_rs],
        }
        load_kwargs = {k: v for k, v in load_kwargs.items() if v is not None}
        cfg["pred_loc"] = {"method": "from_source",
                           "load_kwargs": load_kwargs}
        run_kwargs = cfg.setdefault("run_kwargs", {})
        run_kwargs["table_suffix"] = table_suffix_fmt.format(i=i)
        cfg["xval_fold"] = json_serializable(fold_rs)
        out.append(cfg)
    return out


def evaluate_xval(store_path, obs_df, folds_suffixes, coords_col=("x", "y"),
                  obs_col="z", merge_tol=1e-6, inference_radius=None):
    """Score held-out predictions against the true observations.

    Predictions from all experts covering each held-out point are merged with
    Gaussian weights, then rmse/nll computed per fold and overall.
    """
    import pandas as pd
    from gpsat_tpu_torch.local_experts import get_results_from_h5file
    from gpsat_tpu_torch.utils import get_weighted_values

    coords_col = list(coords_col)
    rows = []
    for suffix in folds_suffixes:
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
        # round BOTH sides of the coordinate join (float equality across the
        # store round-trip is not guaranteed; reference rounds pred_loc too,
        # evaluate_xval_performance.py:54-56)
        merged = merged.round({c: 6 for c in coords_col})
        joined = merged.merge(obs_df.round({c: 6 for c in coords_col}),
                              on=coords_col, how="inner")
        if len(joined) == 0:
            continue
        mu = joined["f*"].values + joined["f_bar"].values
        sig = np.sqrt(joined["y_var"].values)
        y = joined[obs_col].values
        rows.append({"fold": suffix, "n": len(joined),
                     "rmse": rmse(y, mu),
                     "nll": nll(y, mu, sig) / max(len(joined), 1)})
    return pd.DataFrame(rows)


def main():
    config = get_config_from_sysargv()
    if config is None:
        print("usage: python -m gpsat_tpu_torch.examples.create_xval_config "
              "<config.json>")
        return
    ref_cfg = config["reference_config"]
    if isinstance(ref_cfg, str):
        with open(ref_cfg) as f:
            ref_cfg = json.load(f)
    xv = config.get("xval", {})
    cfgs = create_xval_configs(ref_cfg, xval_col=xv.get("col"),
                               xval_vals=xv.get("vals"),
                               folds=xv.get("folds"))
    out_path = config.get("output", "xval_configs.json")
    with open(out_path, "w") as f:
        json.dump(json_serializable(cfgs), f, indent=2)
    cprint(f"wrote {len(cfgs)} fold configs to {out_path}", "OKGREEN")


if __name__ == "__main__":
    main()
