"""The port's post-processing (gpsat_tpu_torch.postprocessing) against the
JAX package's on the CPU in f64: the Gaussian smoother and its blocks, the
smoothing of a results store the JAX package's LocalExpertOI wrote (tables
and follow-up config), the smoothed re-predict through each package's
LocalExpertOI, and the prediction glue."""

import json
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from gpsat_tpu import postprocessing as jax_pp
from gpsat_tpu import utils as jax_utils
from gpsat_tpu.dataprepper import DataPrep as JaxDataPrep
from gpsat_tpu.local_experts import LocalExpertOI as JaxLocalExpertOI
from gpsat_tpu.local_experts import get_results_from_h5file as jax_results
from gpsat_tpu_torch import postprocessing as pp
from gpsat_tpu_torch import utils
from gpsat_tpu_torch.local_experts import LocalExpertOI
from gpsat_tpu_torch.local_experts import get_results_from_h5file

torch.set_num_threads(1)

KM = 1000.0
SMOOTH_TOL = 1e-12      # the smoother and the *_SMOOTHED tables, relative
REPREDICT_TOL = 1e-8    # the smoothed re-predict's f*, f*_var, y_var


# ---------------------------------------------------------------------------
# the smoother
# ---------------------------------------------------------------------------

def smoother_case(case):
    rng = np.random.default_rng(0)
    n = 120
    x = rng.uniform(-500, 500, n)
    y = rng.uniform(-500, 500, n)
    vals = np.sin(x / 150) + 0.1 * rng.standard_normal(n)
    x0, y0 = x, y
    if case == "nan_sources":
        vals[::7] = np.nan
    elif case == "all_nan":
        vals[:] = np.nan
    elif case == "distinct_outputs":
        x0 = rng.uniform(-600, 600, 45)
        y0 = rng.uniform(-600, 600, 45)
        vals[::11] = np.nan
    return x0, y0, x, y, vals


@pytest.mark.parametrize("case", ["plain", "nan_sources", "all_nan",
                                  "distinct_outputs"])
def test_gaussian_2d_smooth_matches_jax(case):
    x0, y0, x, y, vals = smoother_case(case)
    got = pp.gaussian_2d_smooth(x0, y0, x, y, 80.0, 120.0, vals,
                                device="cpu")
    want = jax_pp.gaussian_2d_smooth(x0, y0, x, y, 80.0, 120.0, vals)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if case == "all_nan":
        assert np.isnan(got).all()
    np.testing.assert_allclose(got, want, rtol=SMOOTH_TOL, equal_nan=True)


def _rows_per_block(monkeypatch, rows, n_sources):
    """Make the smoother's blocks `rows` output rows deep."""
    monkeypatch.setattr(pp, "BLOCK_BYTES", 8 * n_sources * rows)


@pytest.mark.parametrize("block_rows", [1, 7, 64])
def test_blocked_smooth_equals_one_block(block_rows, monkeypatch):
    x0, y0, x, y, vals = smoother_case("distinct_outputs")
    _rows_per_block(monkeypatch, len(x0), len(x))
    one = pp.gaussian_2d_smooth(x0, y0, x, y, 80.0, 120.0, vals,
                                device="cpu")
    _rows_per_block(monkeypatch, block_rows, len(x))
    got = pp.gaussian_2d_smooth(x0, y0, x, y, 80.0, 120.0, vals,
                                device="cpu")
    np.testing.assert_array_equal(got, one)


def test_masked_smooth_matches_jax(monkeypatch):
    """Padded outputs give NaN, padded sources are skipped (the JAX
    package's tile-local smoother)."""
    import jax.numpy as jnp
    x0, y0, x, y, vals = smoother_case("distinct_outputs")
    rng = np.random.default_rng(1)
    m0 = rng.uniform(size=len(x0)) < 0.8
    sm = rng.uniform(size=len(x)) < 0.7
    _rows_per_block(monkeypatch, 10, len(x))
    got = pp.gaussian_2d_smooth_masked(x0, y0, m0, x, y, sm, 80.0, 120.0,
                                       vals, device="cpu")
    want = np.asarray(jax_pp._gaussian_2d_smooth_masked_jit(
        *(jnp.asarray(a) for a in (x0, y0, m0, x, y, sm)),
        jnp.asarray(80.0), jnp.asarray(120.0), jnp.asarray(vals)))
    assert np.isnan(got[~m0]).all()
    np.testing.assert_allclose(got, want, rtol=SMOOTH_TOL, equal_nan=True)


def test_smoothing_config_and_limits_match_jax():
    c, jc = pp.SmoothingConfig(l_x=2, l_y=3, max=5), \
        jax_pp.SmoothingConfig(l_x=2, l_y=3, max=5)
    for k in ("l_x", "l_y", "max", "min"):
        assert c[k] == jc[k] and c.get(k) == jc.get(k)
    with pytest.raises(AttributeError):
        c["nope"]
    for limit in (None, 0.5, [1.0, 2.0, 3.0], [4.0]):
        for comp in range(4):
            row = pd.Series({"_dim_0": comp})
            assert pp._resolve_component_limit(limit, row, ["_dim_0"]) == \
                jax_pp._resolve_component_limit(limit, row, ["_dim_0"])


@pytest.mark.parametrize("lo, hi", [(None, None), (-0.2, None), (None, 0.3),
                                    (-0.2, 0.3)])
def test_smooth_field_clamps_as_jax(lo, hi, monkeypatch):
    """smooth_field (the numpy core) against the JAX package's clamp,
    smooth, clamp on the same slice."""
    x0, y0, _, _, vals = smoother_case("nan_sources")
    _rows_per_block(monkeypatch, 16, len(x0))
    got = pp.smooth_field(x0, y0, vals, 80.0, 120.0, min=lo, max=hi,
                          device="cpu")
    v = vals.copy()
    if hi is not None:
        v[v > hi] = hi
    if lo is not None:
        v[v < lo] = lo
    want = jax_pp.gaussian_2d_smooth(x0, y0, x0, y0, 80.0, 120.0, v)
    if lo is not None:
        want = np.maximum(want, lo)
        assert (got >= lo).all()
    if hi is not None:
        want = np.minimum(want, hi)
        assert (got <= hi).all()
    np.testing.assert_allclose(got, want, rtol=SMOOTH_TOL)


# ---------------------------------------------------------------------------
# a store written by the JAX package's LocalExpertOI, smoothed by each
# package, and re-predicted by each from its smoothed tables
# ---------------------------------------------------------------------------

def truth_field(x, y):
    return (0.3 * np.sin(x / (150 * KM)) + 0.2 * np.cos(y / (200 * KM))
            + 0.1 * np.sin((x + y) / (300 * KM)))


def synthetic_config():
    """tests/test_local_experts.py's synthetic setup (3000 points binned at
    25 km, experts 400 km apart, a 50 km prediction grid), with nine experts
    instead of four so the smoother has a field to smooth."""
    rng = np.random.default_rng(7)
    n = 3000
    x = rng.uniform(-500 * KM, 500 * KM, n)
    y = rng.uniform(-500 * KM, 500 * KM, n)
    z = truth_field(x, y) + 0.05 * rng.standard_normal(n)
    df = pd.DataFrame({"x": x, "y": y, "z": z, "t": 0.0})
    bin_df = JaxDataPrep.bin_data_by(
        df=df, by_cols=["t"], val_col="z", x_range=[-500 * KM, 500 * KM],
        y_range=[-500 * KM, 500 * KM],
        grid_res=25 * KM).to_dataframe().dropna().reset_index()
    eloc = pd.DataFrame(jax_utils.grid_2d_flatten(
        [-600 * KM, 600 * KM], [-600 * KM, 600 * KM], step_size=400 * KM),
        columns=["x", "y"])
    eloc["t"] = 0.0
    ploc = pd.DataFrame(jax_utils.grid_2d_flatten(
        [-400 * KM, 400 * KM], [-400 * KM, 400 * KM], step_size=50 * KM),
        columns=["x", "y"])
    return dict(
        expert_loc_config={"source": eloc},
        data_config={"data_source": bin_df, "obs_col": "z",
                     "coords_col": ["x", "y", "t"],
                     "local_select": [
                         {"col": "t", "comp": "<=", "val": 4},
                         {"col": "t", "comp": ">=", "val": -4},
                         {"col": ["x", "y"], "comp": "<", "val": 220 * KM}]},
        model_config={
            "oi_model": "GPRModel",
            "init_params": {"coords_scale": [50 * KM, 50 * KM, 1]},
            "constraints": {
                "lengthscales": {"low": [1e-08] * 3,
                                 "high": [600 * KM, 600 * KM, 9]},
                "likelihood_variance": {"low": 1e-4, "high": 0.05}}},
        pred_loc_config={"method": "from_dataframe", "df": ploc,
                         "max_dist": 200 * KM})


# configs/example_postprocessing.json's form at this grid's scale; the
# kernel_variance max binds on this field, before and after smoothing
SMOOTHING = {
    "params_to_smooth": ["lengthscales", "kernel_variance",
                         "likelihood_variance"],
    "smooth_config_dict": {
        "lengthscales": {"l_x": 200 * KM, "l_y": 200 * KM},
        "kernel_variance": {"l_x": 200 * KM, "l_y": 200 * KM, "max": 0.05},
        "likelihood_variance": {"l_x": 200 * KM, "l_y": 200 * KM,
                                "max": 0.002}},
    "table_suffix": "_SMOOTHED", "save_config_file": True}
SMOOTHED = ["lengthscales_SMOOTHED", "kernel_variance_SMOOTHED",
            "likelihood_variance_SMOOTHED"]


@pytest.fixture(scope="module")
def smoothed(tmp_path_factory):
    """One store from the JAX package's LocalExpertOI, copied twice; the
    JAX package smooths one copy, the port's CLI (on the CPU) the other, and
    each package re-predicts its copy from its smoothed tables."""
    config = synthetic_config()
    src = str(tmp_path_factory.mktemp("jax_run") / "oi.h5")
    JaxLocalExpertOI(**config).run(store_path=src, optimise=True,
                                   check_config_compatible=False,
                                   verbose=False, use_mesh=False)
    out = {}
    for pkg in ("jax", "torch"):
        store = str(tmp_path_factory.mktemp(f"smooth_{pkg}") / "oi.h5")
        shutil.copy(src, store)
        kw = dict(SMOOTHING, result_file=store, output_file=store)
        if pkg == "jax":
            follow = jax_pp.smooth_hyperparameters(**kw)
        else:
            cfg = os.path.join(os.path.dirname(store), "smooth.json")
            with open(cfg, "w") as f:
                json.dump(kw, f)
            follow = pp.main([cfg, "--device", "cpu"])
        with open(follow) as f:
            follow_cfg = json.load(f)
        re_cfg = dict(config)
        re_cfg["model_config"] = dict(
            config["model_config"],
            load_params={"file": store, "table_suffix": "_SMOOTHED"})
        run_kw = dict(store_path=store, optimise=False, predict=True,
                      table_suffix="_SMOOTHED",
                      check_config_compatible=False, verbose=False)
        if pkg == "jax":
            JaxLocalExpertOI(**re_cfg).run(use_mesh=False, **run_kw)
        else:
            LocalExpertOI(device="cpu", **re_cfg).run(**run_kw)
        out[pkg] = dict(store=store, follow=follow, follow_cfg=follow_cfg)
    return out


def read_tables(pkg, store):
    reader = jax_results if pkg == "jax" else get_results_from_h5file
    return reader(store, merge_on_expert_locations=False)[0]


def by_keys(df):
    keys = [c for c in ("x", "y", "t", "_dim_0", "pred_loc_x",
                        "pred_loc_y") if c in df.columns]
    return df.sort_values(keys).reset_index(drop=True)


@pytest.mark.parametrize("table", SMOOTHED)
def test_smoothed_tables_match_jax(smoothed, table):
    """Every *_SMOOTHED parameter table the port writes equals the JAX
    package's (same rows, values to 1e-12), clamps held."""
    got = by_keys(read_tables("torch", smoothed["torch"]["store"])[table])
    want = by_keys(read_tables("jax", smoothed["jax"]["store"])[table])
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) > 0
    for col in want.columns:
        np.testing.assert_allclose(got[col].values, want[col].values,
                                   rtol=SMOOTH_TOL, err_msg=col)
    hp = table.replace("_SMOOTHED", "")
    hi = SMOOTHING["smooth_config_dict"][hp].get("max")
    if hi is not None:
        assert (got[hp] <= hi).all()


def test_follow_up_config_matches_jax_but_for_paths(smoothed):
    got = smoothed["torch"]["follow_cfg"]
    want = smoothed["jax"]["follow_cfg"]
    assert smoothed["torch"]["follow"].endswith("oi_SMOOTHED.json")
    assert os.path.basename(smoothed["jax"]["follow"]) == \
        os.path.basename(smoothed["torch"]["follow"])

    def strip(cfgs, store):
        text = json.dumps(cfgs, sort_keys=True)
        return json.loads(text.replace(store, "<store>"))
    assert strip(got, smoothed["torch"]["store"]) == \
        strip(want, smoothed["jax"]["store"])
    rk = got[-1]["run_kwargs"]
    assert rk["optimise"] is False and rk["table_suffix"] == "_SMOOTHED"
    assert got[-1]["model"]["load_params"] == {
        "file": smoothed["torch"]["store"], "table_suffix": "_SMOOTHED"}


@pytest.mark.parametrize("key", ["f*", "f*_var", "y_var"])
def test_smoothed_repredict_matches_jax(smoothed, key):
    """LocalExpertOI with optimise=False and load_params on the _SMOOTHED
    tables: the port (CPU, f64) against the JAX package on the same store."""
    got_t = read_tables("torch", smoothed["torch"]["store"])
    want_t = read_tables("jax", smoothed["jax"]["store"])
    got, want = by_keys(got_t["preds_SMOOTHED"]), \
        by_keys(want_t["preds_SMOOTHED"])
    assert len(got) == len(want) > 0
    err = np.abs(got[key].values - want[key].values)
    print(f"{key}: max abs err {err.max():.3e}")
    np.testing.assert_allclose(got[key].values, want[key].values, rtol=0,
                               atol=REPREDICT_TOL)
    rd = got_t["run_details_SMOOTHED"]
    assert len(rd) == len(got_t["run_details"]) == 9
    assert not rd["parameters_optimised"].any()
    assert (rd["optimise_iterations"] == 0).all()


def test_smoothed_repredict_tracks_truth(smoothed):
    dfs = read_tables("torch", smoothed["torch"]["store"])
    merged = utils.get_weighted_values(
        df=dfs["preds_SMOOTHED"], ref_col=["pred_loc_x", "pred_loc_y"],
        dist_to_col=["x", "y"], val_cols=["f*"], lengthscale=100 * KM)
    truth = truth_field(merged["pred_loc_x"].values,
                        merged["pred_loc_y"].values)
    assert np.sqrt(np.mean((merged["f*"].values - truth) ** 2)) < 0.08


# ---------------------------------------------------------------------------
# prediction glue
# ---------------------------------------------------------------------------

def glue_inputs():
    rng = np.random.default_rng(3)
    ex, ey = np.meshgrid([0.0, 10.0, 20.0], [0.0, 10.0, 20.0])
    expert_locs = pd.DataFrame({"x": ex.ravel(), "y": ey.ravel()})
    pls = rng.uniform(0, 20, (6, 2))
    rows = [{"x": e.x, "y": e.y, "pred_loc_x": p[0], "pred_loc_y": p[1],
             "f*": rng.standard_normal(), "f*_var": rng.uniform(0.1, 1.0)}
            for _, e in expert_locs.iterrows() for p in pls]
    return pd.DataFrame(rows), expert_locs


@pytest.mark.parametrize("glue", ["glue_local_predictions_1d",
                                  "glue_local_predictions_2d"])
def test_glue_matches_jax(glue):
    preds, expert_locs = glue_inputs()
    got = getattr(pp, glue)(preds, expert_locs, R=3)
    want = getattr(jax_pp, glue)(preds, expert_locs, R=3)
    pd.testing.assert_frame_equal(got, want, rtol=1e-12)


def test_get_weighted_values_matches_jax():
    preds, _ = glue_inputs()
    kw = dict(ref_col=["pred_loc_x", "pred_loc_y"], dist_to_col=["x", "y"],
              val_cols=["f*", "f*_var"], lengthscale=10.0 / 3)
    pd.testing.assert_frame_equal(utils.get_weighted_values(preds, **kw),
                                  jax_utils.get_weighted_values(preds, **kw),
                                  rtol=1e-12)
