"""The application drivers of the port (gpsat_tpu_torch.examples) against
the JAX package's (examples/) on the same seeded inputs, on the CPU in f64:
the data preparation exactly, the OI drivers (seasonal, inline, the
near-duplicate stress check) at the pipeline's parity tolerances, the seven
steps of run_examples end to end, the imports without jax (and the numpy
cores without pandas, h5py and matplotlib), and the card-by-default rule.
The production sea-ice driver's runs are in tests/test_torch_drivers_oi.py."""

import filecmp
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pandas as pd
import pytest
import torch

import gpsat_tpu.local_experts as jax_local_experts
from gpsat_tpu_torch.ncio import NcDataset, NcVariable, write_netcdf
from test_torch_local_experts import (CONVERGED_TOL, TABLES,
                                      assert_tables_close, read)

torch.set_num_threads(1)

KM = 1000.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = ("generate_example_data", "read_and_store_raw_data", "bin_data",
           "local_expert_oi", "plot_observations", "plot_from_results",
           "inline_example", "sea_ice_freeboard_driver", "seasonal_driver",
           "create_xval_config", "evaluate_xval_performance",
           "optimize_hyperparameters", "numerical_stability_check",
           "weight_function_compare", "combine_monthly_netcdf",
           "generate_track_id", "create_expert_locations_over_ocean",
           "smap_availability", "data_review", "worked_example",
           "run_examples")


def jax_driver(name):
    import importlib
    return importlib.import_module(f"examples.{name}")


def port_driver(name):
    import importlib
    return importlib.import_module(f"gpsat_tpu_torch.examples.{name}")


@pytest.fixture
def one_device(monkeypatch):
    """The JAX pipeline on one device, as the pipeline's parity tests run it
    (use_mesh=False) and as the port's CPU runs are."""
    monkeypatch.setattr(jax_local_experts, "get_mesh", lambda *a, **k: None)


def assert_frames_equal(got, want):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in want.columns:
        g, w = got[c].values, want[c].values
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0, err_msg=c)
        else:
            assert (g == w).all(), c


# ---------------------------------------------------------------------------
# data preparation, exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_make_tracks_and_truth_field_match_jax(seed):
    j, t = jax_driver("generate_example_data"), \
        port_driver("generate_example_data")
    assert_frames_equal(t.make_tracks(n_tracks=7, seed=seed),
                        j.make_tracks(n_tracks=7, seed=seed))
    x, y = np.random.default_rng(seed).uniform(-2e6, 2e6, (2, 500))
    np.testing.assert_array_equal(t.truth_field(x, y), j.truth_field(x, y))


def test_generate_example_data_writes_the_jax_files(tmp_path):
    j, t = jax_driver("generate_example_data"), \
        port_driver("generate_example_data")
    j.main(str(tmp_path / "jax"), seed=2)
    t.main(str(tmp_path / "torch"), seed=2)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch")) and len(names) == 6
    for n in names:
        assert filecmp.cmp(tmp_path / "jax" / n, tmp_path / "torch" / n,
                           shallow=False), n


def test_sea_ice_data_preparation_matches_jax():
    """synth_sea_ice, the 50 km binning (of one day and of two),
    add_sic_pseudo_obs, synth_secondary_instrument and fuse_secondary_obs
    (with coarsening, the day filter and a region exclusion) equal the JAX
    driver's; the numpy
    core driver_arrays equals the DataFrame flow."""
    from gpsat_tpu.dataprepper import DataPrep as JaxDataPrep
    j, t = jax_driver("sea_ice_freeboard_driver"), \
        port_driver("sea_ice_freeboard_driver")
    raw = t.synth_sea_ice()
    assert_frames_equal(raw, j.synth_sea_ice())
    bins = t.bin_sea_ice(raw)
    want_bins = JaxDataPrep.bin_data_by(
        df=j.synth_sea_ice(), by_cols=["t"], val_col="z", grid_res=50 * KM,
        x_range=[-1200 * KM, 1200 * KM],
        y_range=[-1200 * KM, 1200 * KM]).to_dataframe().dropna().reset_index()
    assert_frames_equal(bins, want_bins)
    # two days, one group of t after the other
    days = raw.assign(t=np.arange(len(raw)) % 2 * 1.0)
    assert_frames_equal(t.bin_sea_ice(days), JaxDataPrep.bin_data_by(
        df=days, by_cols=["t"], val_col="z", grid_res=50 * KM,
        x_range=[-1200 * KM, 1200 * KM],
        y_range=[-1200 * KM, 1200 * KM]).to_dataframe().dropna().reset_index())
    with_sic = t.add_sic_pseudo_obs(bins)
    assert_frames_equal(with_sic, j.add_sic_pseudo_obs(want_bins))
    sec = t.synth_secondary_instrument()
    assert_frames_equal(sec, j.synth_secondary_instrument())
    sec.loc[::5, "t"] = 1.0

    def exclude(df):
        return df["x"] > 600 * KM
    for kw in ({}, {"coarsen_factor": 3}, {"day_only": 0.0},
               {"exclude_fn": exclude, "value_range": (0.1, 0.4)}):
        assert_frames_equal(t.fuse_secondary_obs(with_sic, sec, **kw),
                            j.fuse_secondary_obs(with_sic, sec, **kw))

    fused = t.fuse_secondary_obs(with_sic, t.synth_secondary_instrument())
    arrays = t.driver_arrays(plus_secondary=True)
    for c in ("x", "y", "t", "z"):
        np.testing.assert_array_equal(arrays[c], fused[c].values, err_msg=c)
    plain = t.driver_arrays(sic=False)
    np.testing.assert_array_equal(plain["z"], bins["z"].values)


def test_create_xval_configs_match_jax():
    j, t = jax_driver("create_xval_config"), port_driver("create_xval_config")
    ref = {"data": {"data_source": "data.h5", "table": "data",
                    "obs_col": "z", "coords_col": ["x", "y", "t"],
                    "row_select": [{"col": "z", "comp": "<", "val": 1}]},
           "model": {"oi_model": "GPRModel"}, "run_kwargs": {"a": 1}}
    for kw in ({"xval_col": "source", "xval_vals": ["A", "B", "C"]},
               {"folds": [{"col": "t", "comp": ">=", "val": 3}]}):
        assert t.create_xval_configs(ref, **kw) == \
            j.create_xval_configs(ref, **kw)


@pytest.fixture(scope="module")
def xval_store(tmp_path_factory):
    """Two folds of tests/test_xval.py's tracked data run by the port's
    run_missing_folds on the CPU."""
    rng = np.random.default_rng(11)
    frames = []
    for src in "ABC":
        x, y = rng.uniform(-300 * KM, 300 * KM, (2, 48))
        z = (0.3 * np.sin(x / (150 * KM)) + 0.2 * np.cos(y / (200 * KM))
             + 0.05 * rng.standard_normal(48))
        frames.append(pd.DataFrame({"x": x, "y": y, "z": z, "t": 0.0,
                                    "source": src}))
    df = pd.concat(frames, ignore_index=True)
    ref = {"data": {"data_source": df, "obs_col": "z",
                    "coords_col": ["x", "y", "t"],
                    "local_select": [{"col": ["x", "y"], "comp": "<",
                                      "val": 260 * KM}]},
           "locations": {"source": pd.DataFrame(
               {"x": [-150 * KM, 150 * KM], "y": [0.0, 0.0], "t": 0.0})},
           "model": {"oi_model": "GPRModel",
                     "init_params": {"coords_scale": [50 * KM, 50 * KM, 1]},
                     "optim_kwargs": {"max_iter": 60}},
           "run_kwargs": {}}
    cfgs = port_driver("create_xval_config").create_xval_configs(
        ref, xval_col="source", xval_vals=["A", "B"])
    store = str(tmp_path_factory.mktemp("xval") / "xval.h5")
    port_driver("evaluate_xval_performance").run_missing_folds(
        cfgs, store, device="cpu")
    return dict(store=store, df=df,
                suffixes=[c["run_kwargs"]["table_suffix"] for c in cfgs])


def test_xval_scores_match_jax(xval_store):
    """xval_point_frame, xval_fold_summary and evaluate_xval of the port
    equal the JAX drivers' on the same fold store."""
    jx, tx = jax_driver("create_xval_config"), \
        port_driver("create_xval_config")
    je, te = jax_driver("evaluate_xval_performance"), \
        port_driver("evaluate_xval_performance")
    s, df, suffixes = (xval_store[k] for k in ("store", "df", "suffixes"))
    kw = dict(coords_col=("x", "y"), obs_col="z", inference_radius=200 * KM)
    points = te.xval_point_frame(s, suffixes, df, **kw)
    assert len(points) > 0 and set(points["fold"]) == set(suffixes)
    assert_frames_equal(points, je.xval_point_frame(s, suffixes, df, **kw))
    assert_frames_equal(te.xval_fold_summary(points),
                        je.xval_fold_summary(points))
    assert_frames_equal(tx.evaluate_xval(s, df, suffixes, **kw),
                        jx.evaluate_xval(s, df, suffixes, **kw))


def test_combine_monthly_netcdf_matches_jax(tmp_path):
    """The combined product (time stack, cell area, region mask with the
    Canadian Archipelago masked, middle-day SIC) equals the JAX
    combiner's."""
    j, t = jax_driver("combine_monthly_netcdf"), \
        port_driver("combine_monthly_netcdf")
    rng = np.random.default_rng(0)
    x = np.arange(-100e3, 100e3 + 1, 25e3)
    y = np.arange(-75e3, 75e3 + 1, 25e3)
    ny, nx = len(y), len(x)
    for yr, mo in [(2018, 11), (2018, 12), (2019, 1)]:
        sub = tmp_path / f"run_30days_smap_{yr:04d}{mo:02d}15_v01"
        sub.mkdir()
        write_netcdf(NcDataset(coords={"x": x, "y": y}, data_vars={
            "ice_thickness": NcVariable(("y", "x"),
                                        rng.uniform(0.5, 3.0, (ny, nx))),
            "ice_thickness_unc": NcVariable(("y", "x"),
                                            rng.uniform(0, 0.5, (ny, nx)))}),
            str(sub / f"IS2_interp_{yr:04d}-{mo:02d}-15.nc"))
    write_netcdf(NcDataset(coords={"x": x, "y": y}, data_vars={
        "cell_area": NcVariable(("y", "x"), np.full((ny, nx), 625e6))}),
        str(tmp_path / "cell_area.nc"))
    rmask = np.ones((ny, nx))
    rmask[-1, :] = 12.0
    write_netcdf(NcDataset(coords={"x": x, "y": y}, data_vars={
        "sea_ice_region_surface_mask": NcVariable(("y", "x"), rmask)}),
        str(tmp_path / "region_mask.nc"))
    (tmp_path / "sic" / "2018").mkdir(parents=True)
    write_netcdf(NcDataset(coords={"x": x, "y": y}, data_vars={
        "cdr_seaice_conc": NcVariable(("y", "x"),
                                      rng.uniform(0, 1, (ny, nx)))}),
        str(tmp_path / "sic" / "2018" / "seaice_conc_daily_20181215_v04.nc"))
    kw = dict(cell_area_path=str(tmp_path / "cell_area.nc"),
              region_mask_path=str(tmp_path / "region_mask.nc"),
              sic_dir=str(tmp_path / "sic"))
    got = t.combine_monthly_netcdf(str(tmp_path), **kw)
    want = j.combine_monthly_netcdf(str(tmp_path), **kw)
    assert sorted(got.keys()) == sorted(want.keys())
    for k in want.keys():
        np.testing.assert_array_equal(got[k].values, want[k].values,
                                      err_msg=k)
    for k in ("time", "x", "y"):
        np.testing.assert_array_equal(got.coords[k], want.coords[k])
    assert got.attrs == want.attrs
    assert t.parse_date_from_filename("a_2019-01-15.nc") == \
        j.parse_date_from_filename("a_2019-01-15.nc")


def test_track_ids_and_ocean_locations_match_jax():
    """generate_track_id's guess_track_num ids (per source) and the
    ocean-mask expert file equal the JAX drivers'."""
    jt, tt = jax_driver("generate_track_id"), port_driver("generate_track_id")
    rng = np.random.default_rng(5)
    times = np.datetime64("2020-03-01") + np.cumsum(
        rng.choice([1, 1, 1, 200], 300)).astype("timedelta64[s]")
    df = pd.DataFrame({"datetime": times, "source": rng.choice(["A", "B"],
                                                                300)})
    for by in (None, ["source"]):
        assert_frames_equal(tt.add_track_ids(df, by=by),
                            jt.add_track_ids(df, by=by))
    jo, to = jax_driver("create_expert_locations_over_ocean"), \
        port_driver("create_expert_locations_over_ocean")
    kw = dict(x_range=[-3000 * KM, 3000 * KM], y_range=[-3000 * KM, 3000 * KM],
              spacing=250 * KM, t=2.0, min_lat=65.0)
    assert_frames_equal(to.make_expert_locations(**kw),
                        jo.make_expert_locations(**kw))


def test_weight_function_compare_matches_jax():
    """The three smoothers of weight_function_compare (the device smoother,
    the pandas merge and the numpy oracle) equal the JAX package's on the
    same field."""
    from gpsat_tpu.postprocessing import gaussian_2d_smooth
    from gpsat_tpu.utils import get_weighted_values
    j, t = jax_driver("weight_function_compare"), \
        port_driver("weight_function_compare")
    got = t.main(["--n", "24"], device="cpu")
    x, y, vals, _ = t.make_field(24)
    sub = got["sub"]
    np.testing.assert_allclose(got["smoothed"], np.asarray(
        gaussian_2d_smooth(x, y, x, y, 2.0, 2.0, vals)), rtol=1e-12)
    merged = get_weighted_values(t.merge_pairs(x, y, vals, sub, 2.0),
                                 ref_col=["px", "py"],
                                 dist_to_col=["sx", "sy"], val_cols="val",
                                 lengthscale=2.0).set_index(["px", "py"])
    np.testing.assert_allclose(
        got["merged"], [merged["val"].loc[(x[i], y[i])] for i in sub],
        rtol=1e-12)
    np.testing.assert_allclose(
        got["oracle"], j.numpy_oracle(x[sub], y[sub], x, y, 2.0, 2.0, vals),
        rtol=1e-12)


# ---------------------------------------------------------------------------
# the OI drivers
# ---------------------------------------------------------------------------

def test_numerical_stability_check_matches_jax():
    """main(device="cpu"): the JAX driver's PASS/FAIL pattern and optimised
    NLMLs (rtol 1e-6) in every (jitter, dtype) case."""
    j, t = jax_driver("numerical_stability_check"), \
        port_driver("numerical_stability_check")
    got = t.main(device="cpu")
    coords, obs = j.make_test_data()
    np.testing.assert_array_equal(coords, t.make_test_data()[0])
    assert len(got) == 8
    for case in got:
        dtype = np.dtype(case["dtype"]).type
        finite, nlml, _ = j.run_case(coords, obs, case["jitter"], dtype)
        assert case["finite"] == finite, case
        np.testing.assert_allclose(case["nlml"], nlml, rtol=1e-6,
                                   err_msg=f"{case['jitter']} {dtype}")
        assert case["preds"]["f*"].dtype == dtype


def capped(cls, max_iter):
    """LocalExpertOI with the model's L-BFGS stopped at max_iter."""
    def make(*args, **kw):
        key = "model" if "model" in kw else "model_config"
        kw[key] = dict(kw[key], optim_kwargs={"max_iter": max_iter})
        return cls(*args, **kw)
    return make


def test_seasonal_driver_matches_jax(tmp_path, monkeypatch, one_device):
    """Two months of the seasonal driver at a reduced size (4 tracks a
    month, 10 L-BFGS iterations an expert: at its own size the sweep runs
    for many minutes on a CPU in either package). Stopped short, no month
    converges, so both drivers end in their own check ("a month's sweep
    failed") after writing every table; each month's tables in each store
    agree at CONVERGED_TOL and the stored configs are equal."""
    import functools
    import gpsat_tpu_torch.local_experts as tle
    j, t = jax_driver("seasonal_driver"), port_driver("seasonal_driver")
    monkeypatch.setattr(j, "LocalExpertOI", capped(j.LocalExpertOI, 10))
    monkeypatch.setattr(tle, "LocalExpertOI", capped(tle.LocalExpertOI, 10))
    paths = {}
    for pkg, drv in (("jax", j), ("torch", t)):
        monkeypatch.setattr(drv, "make_month_obs", functools.partial(
            drv.make_month_obs, n_tracks=4))
        (tmp_path / pkg).mkdir()
        monkeypatch.chdir(tmp_path / pkg)
        args = ["--months", "2", "--out", "seasonal.h5"]
        with pytest.raises(AssertionError, match="a month's sweep failed"):
            drv.main(args + (["--device", "cpu"] if pkg == "torch" else []))
        paths[pkg] = str(tmp_path / pkg / "seasonal.h5")
    for label in ("_2020_01", "_2020_02"):
        got, got_cfg = read("torch", paths["torch"], table_suffix=label)
        want, want_cfg = read("jax", paths["jax"], table_suffix=label)
        assert got_cfg == want_cfg
        tables = [n + label for n in TABLES]
        tol = {n + label: v for n, v in CONVERGED_TOL.items()}
        assert_tables_close(got, want, tol, tables=tables)


def test_inline_example_matches_jax(tmp_path, monkeypatch, one_device):
    """The canonical recipe at a reduced size (8 tracks a satellite, 20
    L-BFGS iterations an expert, as test_torch_local_experts.py's
    golden_capped: run to convergence on this flat surface the two packages
    part by rounding and end iterations apart): the first stage and the
    smoothed re-predict of each package's store at CONVERGED_TOL."""
    import gpsat_tpu_torch.local_experts as tle
    j, t = jax_driver("inline_example"), port_driver("inline_example")
    monkeypatch.setattr(j, "LocalExpertOI", capped(j.LocalExpertOI, 20))
    monkeypatch.setattr(tle, "LocalExpertOI", capped(tle.LocalExpertOI, 20))
    data = tmp_path / "data"
    port_driver("generate_example_data").main(str(data), n_tracks=8)
    paths = {}
    for pkg, drv in (("jax", j), ("torch", t)):
        root = tmp_path / pkg
        monkeypatch.setattr(drv, "get_data_path", lambda *a: str(data))
        monkeypatch.setattr(drv, "get_parent_path",
                            lambda *a, root=root: str(root.joinpath(*a)))
        (root / "results").mkdir(parents=True)
        monkeypatch.chdir(root)
        if pkg == "jax":
            paths[pkg] = drv.main(make_plots=False)
        else:
            paths[pkg] = drv.main(make_plots=False, device="cpu")
    for suffix in ("", "_SMOOTHED"):
        got, _ = read("torch", paths["torch"], table_suffix=suffix)
        want, _ = read("jax", paths["jax"], table_suffix=suffix)
        tables = [n + suffix for n in TABLES[:-1]]
        tol = {n + suffix: v for n, v in CONVERGED_TOL.items()}
        assert_tables_close(got, want, tol, tables=tables)


def test_run_examples_end_to_end(tmp_path):
    """The seven steps of run_examples.sh through the port on the CPU, on a
    reduced data set (6 tracks a satellite): the stores, the follow-up
    config and both plots."""
    store = port_driver("run_examples").main(
        ["--device", "cpu", "--workdir", str(tmp_path), "--n-tracks", "6"])
    from gpsat_tpu_torch.local_experts import get_results_from_h5file
    dfs, _ = get_results_from_h5file(store, verbose=False)
    for k in ("preds", "preds_SMOOTHED", "lengthscales_SMOOTHED"):
        assert k in dfs and len(dfs[k]) > 0, k
    assert np.isfinite(dfs["preds_SMOOTHED"]["f*"].values).all()
    res = tmp_path / "results"
    for name in ("example_raw.h5", "example_binned.h5",
                 "example_oi_SMOOTHED.json", "example_observations.png",
                 "example_oi_hypers.png"):
        assert (res / name).exists(), name
    with open(res / "example_oi_SMOOTHED.json") as f:
        assert json.load(f)[0]["run_kwargs"]["optimise"] is False


# ---------------------------------------------------------------------------
# imports and devices
# ---------------------------------------------------------------------------

GUARD = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "gpsat_tpu", "examples"):
        sys.modules[name] = None          # any import of them now fails
    blocked = ("pandas", "h5py", "matplotlib")
    for name in blocked:
        sys.modules[name] = None
    import importlib
    import numpy as np
    import torch
    torch.set_num_threads(1)
    for m in MODULES:
        importlib.import_module("gpsat_tpu_torch.examples." + m)
    from gpsat_tpu_torch.examples import numerical_stability_check as nsc
    from gpsat_tpu_torch.examples import sea_ice_freeboard_driver as sid
    data = sid.driver_arrays(plus_secondary=True)
    experts = sid.expert_grid(num_experts=2)
    X, z, P = sid.local_inputs(data, experts)
    assert [len(o) for o in z] == [490, 499], [len(o) for o in z]
    sm = sid.smooth_params(experts, {
        "lengthscales": np.ones((2, 3)), "kernel_variance": np.ones(2),
        "likelihood_variance": np.full(2, 0.1)}, device="cpu")
    assert sm["kernel_variance"].shape == (2,)
    locs, merged = sid.merge_weighted(P[0][:, :2], np.repeat(
        experts[:1, :2], len(P[0]), 0), np.zeros(len(P[0])))
    assert len(locs) == len(P[0])
    coords, obs = nsc.make_test_data()
    finite, nlml, conv = nsc.run_case(coords, obs, 1e-6, np.float64,
                                      device="cpu")
    assert finite and np.isfinite(nlml), nlml
    loaded = sorted(m for m, v in sys.modules.items() if v is not None and (
        m.split(".")[0] in ("jax", "jaxlib", "gpsat_tpu", "examples")
        + blocked))
    assert not loaded, loaded
    print("imported", len(MODULES))
""")


def test_drivers_import_without_jax_and_cores_without_pandas():
    """A subprocess with jax, gpsat_tpu and examples blocked, and pandas,
    h5py and matplotlib too, imports every module of
    gpsat_tpu_torch.examples and runs the sea-ice driver's and the
    stability check's numpy cores (the card machine's setting)."""
    env = {**os.environ, "PYTHONPATH": REPO}
    code = f"MODULES = {MODULES!r}\n" + GUARD
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert f"imported {len(MODULES)}" in res.stdout
    assert sorted(MODULES) == sorted(
        f[:-3] for f in os.listdir(os.path.join(REPO, "gpsat_tpu_torch",
                                                "examples"))
        if f.endswith(".py") and f != "__init__.py")


DEVICE_DRIVERS = {
    "inline_example": lambda m: m.main(make_plots=False),
    "sea_ice_freeboard_driver": lambda m: m.main([]),
    "seasonal_driver": lambda m: m.main([]),
    "evaluate_xval_performance": lambda m: m.main([]),
    "optimize_hyperparameters": lambda m: m.main([]),
    "numerical_stability_check": lambda m: m.main([]),
    "weight_function_compare": lambda m: m.main([]),
    "worked_example": lambda m: m.main([]),
    "run_examples": lambda m: m.main([]),
    "local_expert_oi": lambda m: m.main([]),
}


@pytest.mark.parametrize("name", DEVICE_DRIVERS)
def test_device_drivers_raise_without_a_card(name, monkeypatch):
    """Every driver that computes on the device runs on cuda by default: on
    a host without a card it raises unless given cpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DEVICE_DRIVERS[name](port_driver(name))
