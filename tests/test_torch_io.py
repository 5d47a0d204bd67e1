"""The port's data preparation and I/O against the JAX package's, on the CPU:
run_examples.sh steps 2 and 4 (read_and_store, bin_data) through each
package's CLI on a reduced set of examples/generate_example_data output,
steps 5 and 6 (the OI, smoothing and the smoothed re-predict) through the
port's CLIs, netCDF I/O across the packages, the satellite readers,
datetime parsing, the projections and the other utilities, the DataLoader
methods of this slice, and the plots."""

import os
import shutil
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from examples.generate_example_data import make_tracks
from gpsat_tpu import bin_data as jax_bin_data
from gpsat_tpu import datetime_utils as jax_dtu
from gpsat_tpu import ncio as jax_ncio
from gpsat_tpu import read_and_store as jax_read_and_store
from gpsat_tpu import satdata as jax_satdata
from gpsat_tpu import utils as jax_utils
from gpsat_tpu.dataloader import DataLoader as JaxDataLoader
from gpsat_tpu_torch import bin_data, datetime_utils, ncio, read_and_store
from gpsat_tpu_torch import satdata, utils
from gpsat_tpu_torch.dataloader import DataLoader
from gpsat_tpu_torch.local_experts import get_results_from_h5file
from gpsat_tpu_torch.store import ResultsStore

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KM = 1000.0
TOL = 1e-12


def assert_frames_close(got, want, rtol=TOL, sort=None):
    """Same columns and rows; numbers to rtol, other columns equal."""
    if sort is not None:
        got = got.sort_values(sort).reset_index(drop=True)
        want = want.sort_values(sort).reset_index(drop=True)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in want.columns:
        g, w = got[c].values, want[c].values
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=rtol, equal_nan=True,
                                       err_msg=c)
        else:
            assert (g == w).all(), c


# ---------------------------------------------------------------------------
# run_examples.sh steps 2 and 4 through each package's CLI
# ---------------------------------------------------------------------------

def write_raw_files(root):
    """examples/generate_example_data's raw CSVs, reduced to two satellites
    of eight tracks each, and the example configs of steps 2 and 4."""
    data = os.path.join(root, "data", "example")
    os.makedirs(data)
    os.makedirs(os.path.join(root, "results"))
    for name, seed in (("A", 0), ("B", 1)):
        df = make_tracks(n_tracks=8, seed=seed)
        df["lon"], df["lat"] = jax_utils.EASE2toWGS84(df["x"].values,
                                                      df["y"].values)
        df[["lon", "lat", "datetime", "z"]].to_csv(
            os.path.join(data, f"{name}_RAW.csv"), index=False)
    for cfg in ("example_read_and_store_raw_data.json",
                "example_bin_raw_data.json"):
        shutil.copy(os.path.join(REPO, "configs", cfg), root)


def run_cli(main, *argv):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["prog", *argv])
        return main()


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """Steps 2 and 4 in each package's directory from the same raw files."""
    roots = {}
    src = str(tmp_path_factory.mktemp("raw"))
    write_raw_files(src)
    for pkg, ras, bd in (("jax", jax_read_and_store, jax_bin_data),
                         ("torch", read_and_store, bin_data)):
        root = str(tmp_path_factory.mktemp(pkg) / "run")
        shutil.copytree(src, root)
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(root)
            run_cli(ras.main, "example_read_and_store_raw_data.json")
            run_cli(bd.main, "example_bin_raw_data.json")
        roots[pkg] = root
    return roots


def store_table(path, table="data"):
    with ResultsStore(path, mode="r") as s:
        return s.select(table), s.get_attr(table, "config")


@pytest.mark.parametrize("store, sort", [
    ("example_raw.h5", ["source", "datetime", "lon"]),
    ("example_binned.h5", ["source", "t", "x", "y"])])
def test_cli_stores_match_jax(prepared, store, sort):
    """The port's read_and_store and bin_data stores equal the JAX
    package's: same rows, values to 1e-12, the same stored config."""
    got, got_cfg = store_table(os.path.join(prepared["torch"], "results",
                                            store))
    want, want_cfg = store_table(os.path.join(prepared["jax"], "results",
                                              store))
    assert len(want) > 100
    assert_frames_close(got.reset_index(drop=True),
                        want.reset_index(drop=True), sort=sort)
    assert got_cfg == want_cfg


def test_read_and_store_resolves_the_configs_functions_in_the_port(prepared):
    """The config names gpsat_tpu.utils.WGS84toEASE2 and
    datetime_to_day_float; the port derives x, y and t with its own."""
    raw, _ = store_table(os.path.join(prepared["torch"], "results",
                                      "example_raw.h5"))
    x, y = utils.WGS84toEASE2(raw["lon"].values, raw["lat"].values)
    np.testing.assert_array_equal(raw["x"].values, x)
    np.testing.assert_array_equal(raw["y"].values, y)
    np.testing.assert_array_equal(
        raw["t"].values, utils.datetime_to_day_float(raw["datetime"].values))
    assert set(raw["source"]) == {"A", "B"}


def test_oi_smoothing_and_smoothed_repredict_through_the_port_clis(
        prepared, monkeypatch):
    """run_examples.sh steps 5 and 6 on the port's binned store: the OI,
    the smoothing and the re-predict from the follow-up config, each through
    the port's CLI on the CPU."""
    from gpsat_tpu_torch import local_expert_oi, postprocessing
    root = prepared["torch"]
    monkeypatch.chdir(root)
    t0 = float(np.datetime64("2020-03-01").astype("datetime64[D]")
               .astype(float))
    pd.DataFrame({"x": [-300 * KM, 300 * KM, -300 * KM, 300 * KM],
                  "y": [-300 * KM, -300 * KM, 300 * KM, 300 * KM],
                  "t": t0 + 4.0}).to_csv(
        "data/example/expert_locations.csv", index=False)
    pd.DataFrame(utils.grid_2d_flatten([-700 * KM, 700 * KM],
                                       [-700 * KM, 700 * KM],
                                       step_size=200 * KM),
                 columns=["x", "y"]).to_csv(
        "data/example/prediction_locations.csv", index=False)
    for cfg in ("example_local_expert_oi.json",
                "example_postprocessing.json"):
        shutil.copy(os.path.join(REPO, "configs", cfg), cfg)
    local_expert_oi.main(["example_local_expert_oi.json", "--device", "cpu"])
    follow = postprocessing.main(["example_postprocessing.json",
                                  "--device", "cpu"])
    assert follow == "results/example_oi_SMOOTHED.json"
    local_expert_oi.main([follow, "--device", "cpu"])
    dfs, _ = get_results_from_h5file("results/example_oi.h5",
                                     merge_on_expert_locations=False)
    assert len(dfs["run_details"]) == 4
    rd = dfs["run_details_SMOOTHED"]
    assert len(rd) == 4 and not rd["parameters_optimised"].any()
    assert (dfs["kernel_variance_SMOOTHED"]["kernel_variance"] <= 0.5).all()
    assert (dfs["likelihood_variance_SMOOTHED"]["likelihood_variance"]
            <= 0.3).all()
    preds = dfs["preds_SMOOTHED"]
    assert len(preds) == len(dfs["preds"]) > 0
    assert np.isfinite(preds[["f*", "f*_var", "y_var"]].values).all()
    _, cfgs = get_results_from_h5file("results/example_oi.h5",
                                      table_suffix="_SMOOTHED")
    assert cfgs[-1]["run_kwargs"]["table_suffix"] == "_SMOOTHED"
    assert cfgs[-1]["model"]["load_params"]["table_suffix"] == "_SMOOTHED"


# ---------------------------------------------------------------------------
# netCDF
# ---------------------------------------------------------------------------

def grid_ds(mod):
    rng = np.random.default_rng(3)
    return mod.NcDataset(
        data_vars={"z": mod.NcVariable(("t", "y", "x"),
                                       rng.standard_normal((3, 5, 9)),
                                       {"units": "m"}),
                   "sic": mod.NcVariable(("y", "x"),
                                         rng.uniform(0, 1, (5, 9)))},
        coords={"x": np.linspace(-100.0, 100.0, 9),
                "y": np.linspace(-50.0, 50.0, 5),
                "t": np.array([0.0, 1.0, 2.0])},
        attrs={"title": "synthetic"})


@pytest.mark.parametrize("writer, reader", [(ncio, ncio), (ncio, jax_ncio),
                                            (jax_ncio, ncio)])
def test_netcdf4_round_trip_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "grid.nc")
    src = grid_ds(writer)
    writer.write_netcdf(src, path)
    back = reader.read_netcdf(path)
    assert set(back.data_vars) == {"z", "sic"}
    assert back.data_vars["z"].dims == ("t", "y", "x")
    assert back.attrs["title"] == "synthetic"
    assert back.data_vars["z"].attrs["units"] == "m"
    for k in src.coords:
        np.testing.assert_array_equal(back.coords[k], src.coords[k])
    for k in src.data_vars:
        np.testing.assert_array_equal(back.data_vars[k].values,
                                      src.data_vars[k].values)
    pd.testing.assert_frame_equal(back.to_dataframe(),
                                  jax_ncio.read_netcdf(path).to_dataframe())


def test_netcdf3_and_encoded_reads_match_jax(tmp_path):
    import h5py
    from scipy.io import netcdf_file
    nc3 = str(tmp_path / "classic.nc")
    with netcdf_file(nc3, "w") as f:
        f.createDimension("x", 4)
        f.createVariable("x", "d", ("x",))[:] = np.arange(4.0)
        f.createVariable("z", "d", ("x",))[:] = [1.0, 2.0, 3.0, 4.0]
    enc = str(tmp_path / "enc.nc")
    with h5py.File(enc, "w") as f:
        d = f.create_dataset("x", data=np.arange(3.0))
        d.make_scale("x")
        v = f.create_dataset("z", data=np.array([0, 10, 32767], np.int16))
        v.dims[0].attach_scale(d)
        v.attrs["_FillValue"] = np.int16(32767)
        v.attrs["scale_factor"] = 0.1
        v.attrs["add_offset"] = 5.0
    for path in (nc3, enc):
        got, want = ncio.read_netcdf(path), jax_ncio.read_netcdf(path)
        np.testing.assert_array_equal(got.coords["x"], want.coords["x"])
        np.testing.assert_array_equal(got.data_vars["z"].values,
                                      want.data_vars["z"].values)
    np.testing.assert_allclose(ncio.read_netcdf(enc).data_vars["z"].values,
                               [5.0, 6.0, np.nan], equal_nan=True)


def test_dataset_helpers_match_jax():
    df = pd.DataFrame({"x": np.tile([0.0, 1.0, 2.0], 2),
                       "y": np.repeat([0.0, 1.0], 3),
                       "f": np.arange(6.0)}).iloc[:5]
    got = ncio.dataset_from_dataframe(df, index_cols=["y", "x"])
    want = jax_ncio.dataset_from_dataframe(df, index_cols=["y", "x"])
    np.testing.assert_array_equal(got.data_vars["f"].values,
                                  want.data_vars["f"].values)
    where = [{"col": "x", "comp": ">=", "val": 0.0},
             {"col": "t", "comp": "==", "val": 1.0},
             {"col": "z", "comp": ">", "val": 0.0}]
    (sub, left), (jsub, jleft) = grid_ds(ncio).sel_where(where), \
        grid_ds(jax_ncio).sel_where(where)
    assert left == jleft == [where[2]]
    pd.testing.assert_frame_equal(sub.to_dataframe(), jsub.to_dataframe())
    assert ncio.have_xarray() == jax_ncio.have_xarray()


def test_dataloader_netcdf_through_the_ports_ncio(tmp_path):
    """The DataLoader's netCDF source and writer use the port's ncio: the
    load equals the JAX package's, and write_to_netcdf writes a file the JAX
    package reads."""
    path = str(tmp_path / "grid.nc")
    ncio.write_netcdf(grid_ds(ncio), path)
    where = [{"col": "t", "comp": "==", "val": 2.0},
             {"col": "z", "comp": ">", "val": 0.0}]
    got = DataLoader.load(path, where=where)
    assert len(got) > 0 and (got["t"] == 2.0).all()
    pd.testing.assert_frame_equal(got, JaxDataLoader.load(path, where=where))
    with pytest.raises(ImportError, match="zarr"):
        DataLoader.load(str(tmp_path / "missing.zarr"))
    out = str(tmp_path / "out.nc")
    ds = ncio.dataset_from_dataframe(
        pd.DataFrame({"x": [0.0, 1.0], "f": [3.0, 4.0]}), index_cols=["x"])
    DataLoader.write_to_netcdf(ds, out)
    np.testing.assert_array_equal(
        jax_ncio.read_netcdf(out).data_vars["f"].values, [3.0, 4.0])


# ---------------------------------------------------------------------------
# satellite readers (tests/test_satdata.py's synthetic files)
# ---------------------------------------------------------------------------

def write_satellite_files(root):
    """Along-track section, two monthly IS2SITMOGR4 grids, a daily SIC file
    and a SMAP day, written with the JAX package's ncio."""
    nc = jax_ncio
    rng = np.random.default_rng(0)
    n = 200
    x = np.linspace(-500 * KM, 500 * KM, n)
    y = np.linspace(-300 * KM, 400 * KM, n)
    lon, lat = jax_utils.EASE2toWGS84(x, y, lat_0=90, lon_0=-45)
    thick = 2.0 + 0.5 * np.sin(x / (200 * KM)) + 0.05 * rng.standard_normal(n)
    thick[5] = np.nan
    d = ("along_track_distance_section",)
    nc.write_netcdf(nc.NcDataset(
        coords={d[0]: np.arange(n, dtype=float)},
        data_vars={"latitude": nc.NcVariable(d, lat),
                   "longitude": nc.NcVariable(d, lon),
                   "gps_seconds": nc.NcVariable(d, 1.2e9 + np.arange(n, dtype=float)),
                   "ice_thickness": nc.NcVariable(d, thick)}),
        os.path.join(root, "track.nc"))
    gx = np.arange(-500 * KM, 500 * KM + 1, 25 * KM)
    gy = np.arange(-400 * KM, 400 * KM + 1, 25 * KM)
    os.makedirs(os.path.join(root, "monthly"))
    for month in ("201901", "201902"):
        th = 1.5 + 0.3 * rng.standard_normal((len(gy), len(gx)))
        th[:4, :] = np.nan
        nc.write_netcdf(nc.NcDataset(
            coords={"x": gx, "y": gy},
            data_vars={"ice_thickness": nc.NcVariable(("y", "x"), th)}),
            os.path.join(root, "monthly", f"IS2SITMOGR4_{month}.nc"))
    conc = np.ones((len(gy), len(gx)))
    conc[:, :8] = 0.05
    conc[3, 10] = np.nan
    os.makedirs(os.path.join(root, "sic", "2019"))
    nc.write_netcdf(nc.NcDataset(
        coords={"x": gx, "y": gy},
        data_vars={"cdr_seaice_conc": nc.NcVariable(("y", "x"), conc)}),
        os.path.join(root, "sic", "2019",
                     "seaice_conc_daily_nh_20190115_f17.nc"))
    sx = np.arange(-500 * KM, 500 * KM + 1, 12.5 * KM)
    sy = np.arange(-400 * KM, 400 * KM + 1, 12.5 * KM)
    cm = rng.uniform(0.0, 40.0, (len(sy), len(sx)))
    cm[0, :] = 120.0
    cm[1, :] = np.nan
    os.makedirs(os.path.join(root, "smap"))
    nc.write_netcdf(nc.NcDataset(
        coords={"x": sx, "y": sy},
        data_vars={"combined_thickness": nc.NcVariable(("y", "x"), cm)}),
        jax_satdata.smap_cache_path("2019-01-15",
                                    os.path.join(root, "smap")))


def no_net(url, dest):
    raise OSError("no network")


SAT_CASES = {
    "along_track": lambda m, r: m.along_track_preprocess(
        os.path.join(r, "track.nc"), "ice_thickness"),
    "is2sitmogr4": lambda m, r: m.read_is2sitmogr4(os.path.join(r,
                                                                "monthly")),
    "sic_pseudo_obs": lambda m, r: m.sic_pseudo_obs(
        m.read_netcdf(os.path.join(
            r, "sic", "2019", "seaice_conc_daily_nh_20190115_f17.nc")),
        coarsen_factor=2, val_col="ice_thickness",
        time=np.datetime64("2019-01-15")),
    "sic_for_date": lambda m, r: m.load_sic_pseudo_obs_for_date(
        "2019-01-15", os.path.join(r, "sic"), coarsen_factor=1),
    "sic_missing_date": lambda m, r: m.load_sic_pseudo_obs_for_date(
        "2019-02-01", os.path.join(r, "sic")),
    "bin_to_is2": lambda m, r: m.bin_to_is2(
        m.along_track_preprocess(os.path.join(r, "track.nc")),
        np.arange(-500 * KM, 500 * KM + 1, 25 * KM),
        np.arange(-400 * KM, 400 * KM + 1, 25 * KM)).to_dataframe()
    .reset_index(),
    "smap_day": lambda m, r: m.load_smap_data_for_date(
        "2019-01-15", os.path.join(r, "smap"), coarsen_factor=2,
        exclude_regions=[2], fetcher=no_net,
        region_grid=(np.array([-500 * KM, 500 * KM]),
                     np.array([-400 * KM, 400 * KM]),
                     np.array([[1.0, 2.0], [1.0, 2.0]]))),
    "smap_missing_day": lambda m, r: m.load_smap_data_for_date(
        "2019-02-01", os.path.join(r, "smap"), fetcher=no_net),
    "smap_availability": lambda m, r: m.cache_smap_date_range(
        "2019-01-14", "2019-01-16", os.path.join(r, "smap"), fetcher=no_net),
}


@pytest.fixture(scope="module")
def sat_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sat"))
    write_satellite_files(root)
    return root


@pytest.mark.parametrize("case", list(SAT_CASES))
def test_satdata_matches_jax(sat_root, case):
    got = SAT_CASES[case](satdata, sat_root)
    want = SAT_CASES[case](jax_satdata, sat_root)
    assert_frames_close(got, want)
    if not case.endswith("missing_date") and not case.endswith("missing_day"):
        assert len(want) > 0


def test_smap_urls_and_cache_paths_match_jax(tmp_path):
    for d in ("2019-01-15", "2020-12-31"):
        assert satdata.smap_url(d) == jax_satdata.smap_url(d)
        assert satdata.smap_cache_path(d, "c") == \
            jax_satdata.smap_cache_path(d, "c")

    def partial(url, dest):
        with open(dest, "wb") as f:
            f.write(b"junk")
        raise OSError("interrupted")
    r = satdata.check_and_cache_smap_date("2019-01-20", str(tmp_path),
                                          fetcher=partial)
    assert r == {"date": "2019-01-20", "success": False, "cached": False,
                 "missing": True}
    assert os.listdir(tmp_path) == []


# ---------------------------------------------------------------------------
# datetime parsing, projections and the other utilities
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn, args, kw", [
    ("from_file_start_end_datetime_GPOD",
     ("CS_OFFL_SIR_GOP_2_20190101T000000_20190101T010203_C001.nc",), {}),
    ("from_file_start_end_datetime_GPOD",
     ("a_20190101T000000_20190102T000000_b",), {"get": "both"}),
    ("from_file_datetime_SARAL", ("SRL_20200102_030405_20200102_040506",),
     {"get": "end"}),
    ("from_file_start_end_datetime", ("x_20200102T030405_y",), {}),
    ("datetime_from_float_column", (np.array([0.0, 1.5, 365.25]),), {}),
    ("datetime_from_float_column", (np.array([0.0, 86400.5]),),
     {"epoch": "2000-01-01", "unit": "s"}),
])
def test_datetime_utils_match_jax(fn, args, kw):
    got = getattr(datetime_utils, fn)(*args, **kw)
    want = getattr(jax_dtu, fn)(*args, **kw)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def lonlat():
    rng = np.random.default_rng(4)
    return rng.uniform(-180, 180, 500), rng.uniform(50, 89.9, 500)


@pytest.mark.parametrize("fn, kw", [
    ("WGS84toEASE2", {}), ("WGS84toEASE2", {"lat_0": -90, "lon_0": 30}),
    ("WGS84toEASE2", {"lat_0": 45, "lon_0": -45}), ("WGS84toEASE2_New", {}),
    ("WGS84toPolarStereo", {}),
    ("WGS84toPolarStereo", {"lon_0": -45, "lat_ts": 70}),
    ("WGS84toPolarStereo", {"lat_0": -90, "lat_ts": -71})])
def test_projections_match_jax(fn, kw):
    lon, lat = lonlat()
    if kw.get("lat_0", 90) < 0:
        lat = -lat
    got = getattr(utils, fn)(lon, lat, **kw)
    want = getattr(jax_utils, fn)(lon, lat, **kw)
    np.testing.assert_allclose(got, want, rtol=TOL)
    inverse = {"WGS84toEASE2": "EASE2toWGS84",
               "WGS84toEASE2_New": "EASE2toWGS84_New",
               "WGS84toPolarStereo": "PolarStereoToWGS84"}[fn]
    np.testing.assert_allclose(getattr(utils, inverse)(*got, **kw),
                               getattr(jax_utils, inverse)(*want, **kw),
                               rtol=TOL)
    scalar = utils.WGS84toEASE2(10.0, 80.0, return_vals="x")
    assert isinstance(scalar, float)
    np.testing.assert_allclose(
        scalar, jax_utils.WGS84toEASE2(10.0, 80.0, return_vals="x"), rtol=TOL)


def test_stats_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal(50) * 10
    v = rng.uniform(1e-20, 30, 50)
    for fn, args in (("rmse", (x, x[::-1])),
                     ("nll", (x, x[::-1], v)),
                     ("guess_track_num", (np.cumsum(v), 20.0))):
        np.testing.assert_allclose(getattr(utils, fn)(*args),
                                   getattr(jax_utils, fn)(*args), rtol=TOL,
                                   err_msg=fn)
    vals = x.copy()
    vals[3] = np.nan
    pd.testing.assert_frame_equal(utils.stats_on_vals(vals, name="v"),
                                  jax_utils.stats_on_vals(vals, name="v"))


def test_dataframe_helpers_match_jax():
    rng = np.random.default_rng(6)
    arrays = {"a": rng.standard_normal((3, 4)), "b": rng.standard_normal(3),
              "c": 2.5}
    for concat in (False, True):
        got = utils.dict_of_array_to_dict_of_dataframe(arrays, concat=concat,
                                                       reset_index=True)
        want = jax_utils.dict_of_array_to_dict_of_dataframe(
            arrays, concat=concat, reset_index=True)
        assert got.keys() == want.keys()
        for k in want:
            pd.testing.assert_frame_equal(got[k], want[k])
    df = pd.DataFrame({"x": [0.0, 1.0, 0.0], "y": [0.0, 0.0, 2.0],
                       "v": [1.0, 2.0, 3.0]})
    for g, w in zip(utils.dataframe_to_2d_array(df, "x", "y", "v"),
                    jax_utils.dataframe_to_2d_array(df, "x", "y", "v")):
        np.testing.assert_array_equal(g, w)
    df2 = df.assign(v=df["v"] + 1e-3)
    assert utils.compare_dataframes(df, df2, ["x", "y"]) == \
        jax_utils.compare_dataframes(df, df2, ["x", "y"])
    d = {"a": [1, 2], "b": "c", "d": [3, 4]}
    assert utils.expand_dict_by_vals(d) == jax_utils.expand_dict_by_vals(d)
    assert set(utils.get_run_info("s.py")) == \
        set(jax_utils.get_run_info("s.py"))
    assert list(utils.pip_freeze_to_dataframe().columns) == \
        ["package", "version"]


def test_register_config_func_and_jax_package_paths():
    """Registered names resolve first; dotted paths into gpsat_tpu resolve
    to the same path in gpsat_tpu_torch, for every module of the port."""
    utils.register_config_func("times_three", lambda a: 3 * a)
    assert utils.config_func("times_three", args=[2]) == 6
    for path, want in (
            ("gpsat_tpu.utils.WGS84toEASE2", utils.WGS84toEASE2),
            ("gpsat_tpu.utils.datetime_to_day_float",
             utils.datetime_to_day_float),
            ("gpsat_tpu.datetime_utils.datetime_from_float_column",
             datetime_utils.datetime_from_float_column),
            ("gpsat_tpu.ncio.read_netcdf", ncio.read_netcdf)):
        assert utils._resolve_func(path) is want
    assert utils._resolve_func("WGS84toEASE2", source="gpsat_tpu.utils") \
        is utils.WGS84toEASE2
    assert utils._resolve_func("np.cumsum") is np.cumsum


def test_move_to_archive_matches_jax(tmp_path):
    for mod, name in ((utils, "a"), (jax_utils, "b")):
        path = tmp_path / f"{name}.txt"
        path.write_text("x")
        dest = mod.move_to_archive(str(path), suffix="_old")
        assert dest == str(tmp_path / "Archive" / f"{name}_old.txt")
        assert os.path.exists(dest) and not path.exists()
    assert utils.move_to_archive(str(tmp_path / "missing")) is None


# ---------------------------------------------------------------------------
# the DataLoader methods of this slice
# ---------------------------------------------------------------------------

def test_flat_files_and_hdf_writes_match_jax(prepared, tmp_path):
    data = os.path.join(prepared["torch"], "data", "example")
    kw = dict(file_dirs=data, file_regex=r"_RAW\.csv$",
              col_funcs={"n": {"func": "lambda z: z * 2",
                               "col_args": "z"}},
              row_select=[{"col": "z", "comp": ">", "val": 0.1}])
    got = DataLoader.read_flat_files(**kw)
    want = JaxDataLoader.read_flat_files(**kw)
    pd.testing.assert_frame_equal(got, want)
    for loader, name in ((DataLoader, "t.h5"), (JaxDataLoader, "j.h5")):
        path = str(tmp_path / name)
        loader.write_to_hdf(got, path, table="d", config={"a": 1},
                            run_info={"r": 2})
        loader.write_to_hdf(got, path, table="d", append=True)
        assert loader.hdf_tables_in_store(path=path) == ["d"]
        assert loader.get_attribute_from_table(path, "d", "config") == \
            {"a": 1}
    pd.testing.assert_frame_equal(store_table(str(tmp_path / "t.h5"), "d")[0],
                                  store_table(str(tmp_path / "j.h5"), "d")[0])


def test_expert_location_masks_match_jax():
    rng = np.random.default_rng(8)
    xs, ys = np.meshgrid(np.arange(6.0), np.arange(5.0))
    ref = pd.DataFrame({"x": np.tile(xs.ravel(), 2), "y": np.tile(ys.ravel(),
                                                                  2),
                        "date": np.repeat([0, 1], xs.size)})
    ref["obs"] = np.where(rng.uniform(size=len(ref)) < 0.3, np.nan, 1.0)
    masks = ["had_obs", {"grid_space": 2, "dims": ["x", "y"]},
             {"col": "x", "comp": ">", "val": 1}]
    got = DataLoader.get_masks_for_expert_loc(ref, masks, obs_col="obs")
    want = JaxDataLoader.get_masks_for_expert_loc(ref, masks, obs_col="obs")
    assert len(got) == len(want) == 3
    for g, w in zip(got[:2], want[:2]):
        pd.testing.assert_frame_equal(g, w)
    assert got[2] == want[2]


def test_multiindex_helpers_match_jax():
    rng = np.random.default_rng(9)
    idx = {"x": 1.0, "y": 2.0}
    got = DataLoader.make_multiindex_df(idx, a=rng.standard_normal((3, 2)))
    want = JaxDataLoader.make_multiindex_df(idx, a=got["a"].values)
    pd.testing.assert_frame_equal(got["a"], want["a"])
    df = pd.DataFrame({"_dim_0": [0, 0, 1, 1], "_dim_1": [0, 1, 0, 1],
                       "v": np.arange(4.0)})
    for k, v in JaxDataLoader.mindex_df_to_arrays(df).items():
        np.testing.assert_array_equal(DataLoader.mindex_df_to_arrays(df)[k],
                                      v)


# ---------------------------------------------------------------------------
# plots
# ---------------------------------------------------------------------------

def test_plots_write_pngs_under_agg(tmp_path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from gpsat_tpu_torch import plot_utils
    from gpsat_tpu_torch.models.exact_gpr import GPRModel
    rng = np.random.default_rng(10)
    x = rng.uniform(-500 * KM, 500 * KM, 300)
    y = rng.uniform(-500 * KM, 500 * KM, 300)
    lon, lat = utils.EASE2toWGS84(x, y)
    df = pd.DataFrame({"x": x, "y": y, "lon": lon, "lat": lat,
                       "z": np.sin(x / 2e5)})
    figs = {}
    figs["obs"], stats = plot_utils.plot_wrapper(df, "z", max_obs=200)
    assert "z" in stats.columns
    ls = pd.DataFrame({"x": np.repeat(x[:20], 2), "y": np.repeat(y[:20], 2),
                       "_dim_0": np.tile([0, 1], 20),
                       "lengthscales": rng.uniform(1, 2, 40)})
    dfs = {"lengthscales": ls, "preds": df.assign(**{"f*": df["z"]})}
    figs["hyper"] = plot_utils.plot_hyper_parameters(
        dfs, ["x", "y"], ["lengthscales"])
    figs["config"] = plot_utils.plots_from_config(
        [{"table": "preds", "val_col": "f*"},
         {"table": "preds", "val_col": "z", "plot_type": "hist"}], dfs)
    for name, fig in figs.items():
        path = tmp_path / f"{name}.png"
        fig.savefig(path)
        assert path.stat().st_size > 1000
        plt.close(fig)
    out = plot_utils.plot_minimal_example(
        lambda coords, obs: GPRModel(coords=coords, obs=obs, device="cpu"),
        opt_params={"max_iter": 30})
    assert np.isfinite(out["pred"]["f*"]).all()
    assert plot_utils.get_projection("south")["lat_0"] == -90
