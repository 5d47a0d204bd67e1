"""The production sea-ice driver (gpsat_tpu_torch.examples.
sea_ice_freeboard_driver) against the JAX package's
(examples/sea_ice_freeboard_driver.py) on the CPU in f64: both drivers run
once with --num-experts 2 in a module fixture; the first-stage stores agree
at the SGPR parity tolerances, the port's re-predict on the JAX store's
smoothed tables equals the JAX re-predict, and the numpy cores that the
card's machine runs (no pandas there) equal the DataFrame flow."""

import shutil

import numpy as np
import pandas as pd
import pytest
import torch

import examples.sea_ice_freeboard_driver as jdrv
import gpsat_tpu.local_experts as jax_local_experts
from gpsat_tpu_torch.examples import sea_ice_freeboard_driver as tdrv
from gpsat_tpu_torch.local_experts import LocalExpertOI
from test_torch_local_experts import (SKIP_COLS, TABLES, assert_tables_close,
                                      read, sorted_table)

torch.set_num_threads(1)

ARGS = ["--num-experts", "2"]
STORE = "sea_ice_driver.h5"
# the SGPR parity tolerances (tests/test_torch_local_experts.py::
# test_sgpr_slice_matches_jax): ELBO rtol 1e-4, parameters atol 1e-2,
# predictions atol 1e-3
SGPR_TOL = {"preds": 1e-3, "lengthscales": 1e-2, "kernel_variance": 1e-2,
            "likelihood_variance": 1e-2, "run_details": 0.0}


@pytest.fixture(scope="module")
def sea_ice(tmp_path_factory):
    """Each package's driver with two experts, each in its own directory with
    the store at the same relative path (so that the stored oi_configs
    compare whole). The JAX run takes one device (its pipeline tests'
    use_mesh=False), as the port's CPU run does."""
    paths = {}
    for pkg in ("jax", "torch"):
        d = tmp_path_factory.mktemp(f"sea_ice_{pkg}")
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(d)
            if pkg == "jax":
                mp.setattr(jax_local_experts, "get_mesh",
                           lambda *a, **k: None)
                jdrv.main(ARGS + ["--store", STORE])
            else:
                tdrv.main(ARGS + ["--store", STORE, "--device", "cpu"])
        paths[pkg] = str(d / STORE)
    return paths


def training_frame():
    """The driver's training set through the port's DataFrame wrappers."""
    return tdrv.add_sic_pseudo_obs(tdrv.bin_sea_ice(tdrv.synth_sea_ice()))


def test_first_stage_matches_jax(sea_ice):
    """The first stage (SGPR, M=300, optimised) at the SGPR parity
    tolerances; the inducing points and expert locations equal."""
    got, got_cfg = read("torch", sea_ice["torch"])
    want, want_cfg = read("jax", sea_ice["jax"])
    assert got_cfg == want_cfg
    assert want["run_details"]["optimise_success"].all()
    assert got["run_details"]["optimise_success"].all()
    assert_tables_close(got, want, 0.0, tables=("inducing_points",
                                                 "expert_locs"))
    assert_tables_close(got, want, SGPR_TOL, tables=TABLES[:-1],
                        skip=SKIP_COLS | {"optimise_iterations",
                                          "objective_value"})
    a, b = (sorted_table(d["run_details"])["objective_value"].values
            for d in (got, want))
    np.testing.assert_allclose(a, b, rtol=1e-4)


def test_repredict_on_jax_smoothed_tables(sea_ice, tmp_path):
    """The port's second stage (load_params, optimise=False) on the JAX
    store's _SMOOTHED tables equals the JAX driver's preds_SMOOTHED at atol
    1e-8 (the precedent: test_torch_local_experts.py::
    test_load_params_repredict_matches_jax)."""
    src = str(tmp_path / "jax_copy.h5")
    shutil.copy(sea_ice["jax"], src)
    out = str(tmp_path / "repredict.h5")
    model = dict(tdrv.MODEL_CONFIG)
    model["load_params"] = {"file": src, "table_suffix": "_SMOOTHED"}
    oi = LocalExpertOI(
        expert_loc_config={"source": pd.DataFrame(
            tdrv.expert_grid(num_experts=2), columns=["x", "y", "t"])},
        data_config={"data_source": training_frame(), "obs_col": "z",
                     "coords_col": ["x", "y", "t"],
                     "local_select": [
                         {"col": "t", "comp": "<=", "val": 4},
                         {"col": "t", "comp": ">=", "val": -4},
                         {"col": ["x", "y"], "comp": "<",
                          "val": tdrv.TRAIN_RADIUS}]},
        model_config=model,
        pred_loc_config={"method": "from_dataframe",
                         "df": pd.DataFrame(tdrv.prediction_grid(),
                                            columns=["x", "y"]),
                         "max_dist": tdrv.PRED_RADIUS},
        device="cpu")
    oi.run(store_path=out, optimise=False, predict=True,
           table_suffix="_SMOOTHED", check_config_compatible=False,
           verbose=False)
    got, _ = read("torch", out, table_suffix="_SMOOTHED")
    want, _ = read("jax", sea_ice["jax"], table_suffix="_SMOOTHED")
    a, b = (sorted_table(d["preds_SMOOTHED"]) for d in (got, want))
    assert len(a) == len(b) > 0
    for k in ("pred_loc_x", "pred_loc_y", "f_bar"):
        np.testing.assert_array_equal(a[k].values, b[k].values, err_msg=k)
    for k in ("f*", "f*_var", "y_var"):
        np.testing.assert_allclose(a[k].values, b[k].values, rtol=0,
                                   atol=1e-8, err_msg=k)


def test_numpy_cores_equal_the_store_flow(sea_ice):
    """What the card's machine runs without pandas: local_inputs gives
    execute_buckets' inputs as LocalExpertOI gathers them (the port store's
    preds rows and num_obs), smooth_params the port store's _SMOOTHED
    tables, merge_weighted main's merged export and merged_rmse the
    driver's RMSE, each as get_weighted_values gives them."""
    from gpsat_tpu_torch.utils import get_weighted_values
    dfs, _ = read("torch", sea_ice["torch"])
    experts = tdrv.expert_grid(num_experts=2)
    data = tdrv.driver_arrays()
    X_list, obs_list, pred_list = tdrv.local_inputs(data, experts)
    frame = training_frame()
    rd = sorted_table(dfs["run_details"])
    preds = dfs["preds"]
    for e, (X, z, P) in enumerate(zip(X_list, obs_list, pred_list)):
        at = (rd["x"] == experts[e, 0]) & (rd["y"] == experts[e, 1])
        assert int(rd.loc[at, "num_obs"].iloc[0]) == len(z)
        inside = np.hypot(frame["x"] - experts[e, 0],
                          frame["y"] - experts[e, 1]) <= tdrv.TRAIN_RADIUS
        np.testing.assert_array_equal(X, frame.loc[inside, ["x", "y", "t"]])
        np.testing.assert_array_equal(z, frame.loc[inside, "z"])
        mine = preds[(preds["x"] == experts[e, 0])
                     & (preds["y"] == experts[e, 1])].sort_values("_dim_0")
        np.testing.assert_array_equal(
            P, mine[["pred_loc_x", "pred_loc_y", "pred_loc_t"]].values)

    fitted = {}
    for name in tdrv.SMOOTH_CONFIG:
        t = sorted_table(dfs[name])
        fitted[name] = t[name].values.reshape(2, -1).squeeze()
    smoothed = tdrv.smooth_params(experts, fitted, device="cpu")
    for name in tdrv.SMOOTH_CONFIG:
        t = sorted_table(dfs[f"{name}_SMOOTHED"])
        np.testing.assert_allclose(
            smoothed[name].reshape(-1), t[name].values, rtol=1e-12,
            err_msg=name)

    sm = dfs["preds_SMOOTHED"]
    merged = get_weighted_values(sm, ref_col=["pred_loc_x", "pred_loc_y"],
                                 dist_to_col=["x", "y"], val_cols=["f*"],
                                 lengthscale=tdrv.MERGE_LENGTHSCALE)
    # main's export, merged through merge_weighted
    exported = pd.read_csv(sea_ice["torch"].replace(".h5", "_merged.csv"))
    want = get_weighted_values(sm, ref_col=["pred_loc_x", "pred_loc_y"],
                               dist_to_col=["x", "y"],
                               val_cols=["f*", "f*_var"],
                               lengthscale=tdrv.MERGE_LENGTHSCALE)
    assert list(exported.columns) == list(want.columns)
    np.testing.assert_allclose(exported.values, want.values, rtol=1e-12)
    locs, vals = tdrv.merge_weighted(sm[["pred_loc_x", "pred_loc_y"]].values,
                                     sm[["x", "y"]].values, sm["f*"].values)
    np.testing.assert_array_equal(locs, merged[["pred_loc_x",
                                                "pred_loc_y"]].values)
    np.testing.assert_allclose(vals[:, 0], merged["f*"].values, rtol=1e-12)
    zt = tdrv.truth(merged["pred_loc_x"].values, merged["pred_loc_y"].values)
    want = float(np.sqrt(np.mean((merged["f*"].values
                                  + sm["f_bar"].mean() - zt) ** 2)))
    got = tdrv.merged_rmse(sm[["pred_loc_x", "pred_loc_y"]].values,
                           sm[["x", "y"]].values, sm["f*"].values,
                           sm["f_bar"].mean())
    assert got == pytest.approx(want, rel=1e-12)
    assert got < 0.1                   # below the observation noise
