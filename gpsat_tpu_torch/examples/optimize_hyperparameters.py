"""Grid search over OI configuration knobs (the port's counterpart of
examples/optimize_hyperparameters.py; reference: optimize_hyperparameters.py:43-51 — re-runs the training flow per
combination of expert_spacing / training_radius / constraint knobs and scores
each against held-out data or ground truth).

Usage: python -m gpsat_tpu_torch.examples.optimize_hyperparameters <config.json> [--device D]
with {"reference_config": <path|dict>, "param_grid": {<dotted.key>: [vals]},
      "score": {"truth_csv": ..., "merge_lengthscale": ...}}
Each run is on the card unless --device names another.
"""

import argparse
import copy
import json
import os
import tempfile

from gpsat_tpu_torch import resolve_device
from gpsat_tpu_torch.utils import (cprint, expand_dict_by_vals,
                                   get_weighted_values, rmse)


def set_dotted(cfg, dotted_key, value):
    parts = dotted_key.split(".")
    d = cfg
    for p in parts[:-1]:
        d = d.setdefault(p, {})
    d[parts[-1]] = value


def run_grid(reference_config, param_grid, score=None, out_dir=None,
             device=None):
    """Run one OI experiment per grid combination on `device` (the card
    unless the caller passes another); returns a score table."""
    import pandas as pd
    from gpsat_tpu_torch.config_dataclasses import ExperimentConfig
    from gpsat_tpu_torch.local_experts import get_results_from_h5file
    device = resolve_device(device)
    combos = expand_dict_by_vals(param_grid)
    out_dir = out_dir or tempfile.mkdtemp(prefix="gpsat_grid_")
    rows = []
    for i, combo in enumerate(combos):
        cfg = copy.deepcopy(reference_config)
        for k, v in combo.items():
            set_dotted(cfg, k, v)
        store = os.path.join(out_dir, f"grid_{i}.h5")
        cfg.setdefault("run_kwargs", {})["store_path"] = store
        cfg["run_kwargs"]["check_config_compatible"] = False
        cprint(f"[{i + 1}/{len(combos)}] {combo}", "OKCYAN")
        ExperimentConfig.from_dict(cfg).run(device=device)

        row = dict(combo)
        row["store"] = store
        if score and score.get("truth_csv"):
            dfs, _ = get_results_from_h5file(store)
            merged = get_weighted_values(
                dfs["preds"], ref_col=["pred_loc_x", "pred_loc_y"],
                dist_to_col=["x", "y"], val_cols=["f*"],
                lengthscale=score.get("merge_lengthscale", 1.0))
            truth = pd.read_csv(score["truth_csv"])
            joined = merged.rename(columns={"pred_loc_x": "x",
                                            "pred_loc_y": "y"}) \
                .merge(truth.round(6), on=["x", "y"], how="inner")
            if len(joined):
                fb = dfs["preds"]["f_bar"].mean()
                row["rmse"] = rmse(joined[score.get("truth_col", "z_true")],
                                   joined["f*"] + fb)
                row["n_scored"] = len(joined)
        rows.append(row)
    table = pd.DataFrame(rows)
    out_csv = os.path.join(out_dir, "grid_results.csv")
    table.to_csv(out_csv, index=False)
    cprint(f"grid results -> {out_csv}", "OKGREEN")
    if "rmse" in table:
        best = table.loc[table["rmse"].idxmin()]
        cprint(f"best: {dict(best)}", "OKGREEN")
    return table


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(
        prog="python -m gpsat_tpu_torch.examples.optimize_hyperparameters")
    ap.add_argument("config", nargs="?", default=None)
    ap.add_argument("--device", default=device,
                    help="torch device of the engine (default: cuda)")
    # called from code with device= and no argv: the defaults, not sys.argv
    args = ap.parse_args([] if argv is None and device is not None else argv)
    device = resolve_device(args.device)
    if args.config is None:
        print("usage: python -m gpsat_tpu_torch.examples."
              "optimize_hyperparameters <config.json> [--device D]")
        return
    from gpsat_tpu_torch.utils import nested_dict_literal_eval
    with open(args.config) as f:
        config = nested_dict_literal_eval(json.load(f))
    ref = config["reference_config"]
    if isinstance(ref, str):
        with open(ref) as f:
            ref = json.load(f)
    run_grid(ref, config["param_grid"], score=config.get("score"),
             out_dir=config.get("out_dir"), device=device)


if __name__ == "__main__":
    main()
