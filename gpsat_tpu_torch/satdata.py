"""Production satellite-data readers (copy of gpsat_tpu/satdata.py, host
only) — native equivalents of the reference's `extra_funcs.py` ingestion
surface (along_track_preprocess at 68, bin_to_IS2 at 31,
load_sic_data_for_date at 149-195, read_IS2SITMOGR4 at 201), built on the
in-house netCDF IO (gpsat_tpu_torch.ncio) and the in-house EASE2 projection
(gpsat_tpu_torch.utils) instead of xarray/pyproj/s3fs (absent in minimal
images; remote S3 access is gated with a clear error). pandas is imported
inside the functions that build DataFrames.

Data model conventions (matching the reference's products):
- ICESat-2 along-track sections: netCDF with a 1-d `along_track_distance_
  section` dimension carrying `latitude`, `longitude`, `gps_seconds` (GPS
  epoch 1980-01-06) and value variables (ice_thickness / total_freeboard /
  snow_depth).
- IS2SITMOGR4 monthly gridded thickness: one netCDF per month on a 25 km
  north-polar EASE2 x/y grid.
- NOAA CDR sea-ice concentration: daily netCDF on the same style of grid,
  concentration variable named cdr_seaice_conc / sea_ice_conc / sic / ...
"""

import glob
import os
import re

import numpy as np

from gpsat_tpu_torch.ncio import read_netcdf
from gpsat_tpu_torch.utils import WGS84toEASE2

__all__ = ["along_track_preprocess", "read_is2sitmogr4",
           "sic_pseudo_obs", "load_sic_pseudo_obs_for_date", "bin_to_is2",
           "smap_url", "smap_cache_path", "check_and_cache_smap_date",
           "cache_smap_date_range", "load_smap_data_for_date"]

GPS_EPOCH = np.datetime64("1980-01-06T00:00:00")
_CONC_NAMES = ("cdr_seaice_conc", "cdr_seaice_conc_monthly", "sea_ice_conc",
               "seaice_conc_cdr", "concentration", "sic")


def along_track_preprocess(ds_or_path, data_variable="ice_thickness",
                           lat_0=90, lon_0=-45):
    """Along-track sections -> tidy DataFrame with (x, y, time, value).

    Reference behaviour (extra_funcs.py:68-97): rename latitude/longitude/
    gps_seconds, convert GPS seconds to datetimes, project lon/lat to EASE2
    (lat_0=90, lon_0=-45 north-polar), attach x/y. Returns a DataFrame (the
    tabular form the binning step consumes) instead of an xarray object.
    """
    import pandas as pd
    ds = read_netcdf(ds_or_path) if isinstance(ds_or_path, str) else ds_or_path

    def _vals(name, *alts):
        for n in (name,) + alts:
            if n in ds:
                return np.asarray(ds[n].values).reshape(-1)
        raise KeyError(f"variable '{name}' not in dataset "
                       f"(have {list(ds.keys())})")

    lat = _vals("latitude", "lat")
    lon = _vals("longitude", "lon")
    gps = _vals("gps_seconds", "time")
    if data_variable in ds:
        val = np.asarray(ds[data_variable].values).reshape(-1)
    else:   # reference fallback: thickness-only datasets
        val = _vals("ice_thickness")
    t = GPS_EPOCH + gps.astype("timedelta64[s]")
    x, y = WGS84toEASE2(lon=lon, lat=lat, lat_0=lat_0, lon_0=lon_0)
    df = pd.DataFrame({"x": x, "y": y, "time": t, data_variable: val})
    return df.dropna().reset_index(drop=True)


def _grid_xy(ds):
    """(x, y) 1-d grid coordinates with the reference's rename fallbacks
    (extra_funcs.py cdr_preprocess_nh: xgrid/ygrid, ni/nj, xc/yc)."""
    for xn, yn in (("x", "y"), ("xgrid", "ygrid"), ("xc", "yc"),
                   ("ni", "nj")):
        if xn in ds and yn in ds:
            return (np.asarray(ds[xn].values).reshape(-1),
                    np.asarray(ds[yn].values).reshape(-1))
    raise KeyError(f"no x/y grid coordinates found (have {list(ds.coords)})")


def _month_from_name(path):
    m = re.search(r"(\d{6})", os.path.basename(path))
    if m:
        s = m.group(1)
        return np.datetime64(f"{s[:4]}-{s[4:6]}-01")
    return np.datetime64("NaT")


def read_is2sitmogr4(local_data_path, pattern="*.nc",
                     val_cols=("ice_thickness",), data_type="netcdf-local"):
    """Monthly gridded IS2SITMOGR4 thickness -> long DataFrame
    (x, y, time, *val_cols), one row per finite grid cell.

    Reference: read_IS2SITMOGR4 (extra_funcs.py:201) with
    data_type='netcdf-local'; the zarr-s3/netcdf-s3 modes need s3fs, which
    is not available — requesting them raises with that explanation.
    """
    import pandas as pd
    if data_type != "netcdf-local":
        raise ImportError(
            f"read_is2sitmogr4 data_type='{data_type}' needs s3fs/zarr for "
            "remote S3 access, which is not installed in this environment; "
            "download the monthly netCDF files and use "
            "data_type='netcdf-local'")
    files = sorted(glob.glob(os.path.join(local_data_path, pattern)))
    assert files, f"no files matching {pattern} in {local_data_path}"
    frames = []
    for f in files:
        ds = read_netcdf(f)
        x, y = _grid_xy(ds)
        xm, ym = np.meshgrid(x, y)
        t = np.asarray(ds["time"].values).reshape(-1)[0] if "time" in ds \
            else _month_from_name(f)
        cols = {"x": xm.reshape(-1), "y": ym.reshape(-1)}
        keep = None
        for vc in val_cols:
            v = np.asarray(ds[vc].values, dtype=float).squeeze().reshape(-1)
            cols[vc] = v
            fin = np.isfinite(v)
            keep = fin if keep is None else (keep | fin)
        df = pd.DataFrame(cols)[keep if keep is not None else slice(None)]
        df["time"] = t
        frames.append(df)
    return pd.concat(frames, ignore_index=True)


def sic_pseudo_obs(ds, sic_cutoff=0.15, coarsen_factor=2,
                   val_col="ice_thickness", time=None, flip_y=True):
    """Zero-value pseudo-observations where sea-ice concentration is below
    `sic_cutoff` — the ice-edge anchor concatenated into the training set
    (reference: extra_funcs.py:149-195 + IS2_GPSat_train.py:782-786).

    ds: an NcDataset (or anything with the same surface) holding a 2-d
    concentration grid. Returns a DataFrame (x, y, val_col, time).
    """
    import pandas as pd
    conc_name = next((n for n in _CONC_NAMES if n in ds), None)
    assert conc_name is not None, \
        f"no concentration variable found (tried {_CONC_NAMES})"
    conc = np.asarray(ds[conc_name].values, dtype=float).squeeze()
    x, y = _grid_xy(ds)
    if flip_y:   # CDR grids are top-down vs the IS2 orientation
        conc = conc[::-1]
        # y coordinate order is unchanged: flipping data re-aligns it
    if coarsen_factor > 1:
        conc = conc[::coarsen_factor, ::coarsen_factor]
        x = x[::coarsen_factor]
        y = y[::coarsen_factor]
    xm, ym = np.meshgrid(x, y)
    low = np.isfinite(conc) & (conc < sic_cutoff)
    out = pd.DataFrame({"x": xm[low], "y": ym[low],
                        val_col: np.zeros(int(low.sum()))})
    if time is None and "time" in ds:
        time = np.asarray(ds["time"].values).reshape(-1)[0]
    out["time"] = time
    return out


def load_sic_pseudo_obs_for_date(date_str, sic_base_path, sic_cutoff=0.15,
                                 coarsen_factor=2, val_col="ice_thickness"):
    """Daily CDR file lookup + pseudo-obs extraction (reference:
    load_sic_data_for_date, local path branch; the S3 fallback needs s3fs
    and is not supported here). Returns an empty frame when no file exists
    (matching the reference's graceful degrade)."""
    import pandas as pd
    year = date_str[:4]
    compact = date_str.replace("-", "")
    files = sorted(glob.glob(os.path.join(sic_base_path, year,
                                          f"*{compact}*.nc")))
    if not files:
        files = sorted(glob.glob(os.path.join(sic_base_path,
                                              f"*{compact}*.nc")))
    if not files:
        return pd.DataFrame(columns=["x", "y", val_col, "time"])
    ds = read_netcdf(files[0])
    return sic_pseudo_obs(ds, sic_cutoff=sic_cutoff,
                          coarsen_factor=coarsen_factor, val_col=val_col,
                          time=np.datetime64(date_str))


# ---------------------------------------------------------------------------
# SMAP/SMOS thin-ice thickness (University of Bremen mix product) — the
# secondary instrument of the reference's IS2+SMAP fusion pipeline
# (reference: IS2_SM_GP/cache_smap_data.py:20-77 cache+availability report,
# IS2_SMAP_GPSat_train.py:142-350 per-date ingestion)
# ---------------------------------------------------------------------------

_SMAP_URL_FMT = ("https://data.seaice.uni-bremen.de/smos_smap/netCDF/north/"
                 "{year}/{compact}_north_mix_sit_v300.nc")
_SMAP_THICKNESS_VARS = ("combined_thickness", "smap_thickness",
                        "smos_thickness")


def smap_url(date_str):
    """Upstream URL for one day's SMAP/SMOS mix product
    (reference: cache_smap_data.py:41)."""
    compact = date_str.replace("-", "")
    return _SMAP_URL_FMT.format(year=compact[:4], compact=compact)


def smap_cache_path(date_str, cache_dir):
    """Canonical local cache filename (reference: cache_smap_data.py:48)."""
    compact = date_str.replace("-", "")
    return os.path.join(cache_dir, f"{compact}_north_mix_sit_v300.nc")


def check_and_cache_smap_date(date_str, cache_dir, fetcher=None):
    """Ensure one day's SMAP file is in the local cache.

    Returns {"date", "success", "cached", "missing"} exactly like the
    reference (cache_smap_data.py:20-77). `fetcher(url, dest_path)` performs
    the download; the default uses urllib and degrades to missing=True when
    the network is unavailable (this environment has no egress — pre-seed
    the cache directory, or pass a custom fetcher).
    """
    os.makedirs(cache_dir, exist_ok=True)
    path = smap_cache_path(date_str, cache_dir)
    result = {"date": date_str, "success": False, "cached": False,
              "missing": False}
    if os.path.exists(path):
        result.update(success=True, cached=True)
        return result
    if fetcher is None:
        def fetcher(url, dest):
            import urllib.request
            with urllib.request.urlopen(url, timeout=30) as r, \
                    open(dest, "wb") as f:
                f.write(r.read())
    try:
        fetcher(smap_url(date_str), path)
        result["success"] = True
    except Exception:
        if os.path.exists(path):    # remove partial download
            os.remove(path)
        result["missing"] = True
    return result


def cache_smap_date_range(start_date, end_date, cache_dir, fetcher=None,
                          report_csv=None, verbose=False):
    """Cache a date range + availability report DataFrame
    (reference: cache_smap_data.py:79-180; columns date/success/cached/
    missing, optional CSV dump)."""
    import pandas as pd
    days = pd.date_range(start_date, end_date, freq="D")
    rows = []
    for d in days:
        r = check_and_cache_smap_date(d.strftime("%Y-%m-%d"), cache_dir,
                                      fetcher=fetcher)
        if verbose:
            status = ("cached" if r["cached"] else
                      "downloaded" if r["success"] else "missing")
            print(f"[{r['date']}] {status}")
        rows.append(r)
    report = pd.DataFrame(rows)
    if report_csv:
        report.to_csv(report_csv, index=False)
    return report


def load_smap_data_for_date(date_str, cache_dir, thickness_min=0.0,
                            thickness_max=0.5, coarsen_factor=1,
                            exclude_regions=(), region_grid=None,
                            lonlat_path=None, is2_grid=None,
                            val_col="ice_thickness", fetcher=None):
    """One day's SMAP thin-ice thickness as tidy training rows.

    Reference semantics (IS2_SMAP_GPSat_train.py:142-350): read the cached
    netCDF (downloading it on miss via `check_and_cache_smap_date`), pick
    combined_thickness > smap_thickness > smos_thickness, convert cm -> m,
    keep thickness in [thickness_min, thickness_max] (SMAP is only valid
    for thin ice), stride-coarsen by `coarsen_factor`, and optionally drop
    points whose nearest cell of `region_grid` (an (x, y, mask) triple,
    e.g. the IS2SITMOGR4 region_mask) is in `exclude_regions` (the
    reference excludes the Central Arctic). Returns a DataFrame
    (x, y, val_col, time) — empty, same columns, when the file is missing
    (the reference's graceful degrade). With `is2_grid=(x_grid, y_grid)`
    also returns the product binned onto the IS2 grid via `bin_to_is2`.

    Grid coordinates come from the file's x/y variables when present;
    otherwise from a NSIDC0771-style lon/lat companion file (`lonlat_path`,
    flipped north-up like the reference) projected with the in-house EASE2
    transform.
    """
    import pandas as pd
    empty = pd.DataFrame(columns=["x", "y", val_col, "time"])
    r = check_and_cache_smap_date(date_str, cache_dir, fetcher=fetcher)
    if not r["success"]:
        return (empty, None) if is2_grid is not None else empty
    ds = read_netcdf(smap_cache_path(date_str, cache_dir))

    name = next((n for n in _SMAP_THICKNESS_VARS if n in ds), None)
    assert name is not None, \
        f"no SMAP thickness variable found (tried {_SMAP_THICKNESS_VARS})"
    thick = np.asarray(ds[name].values, dtype=float).squeeze() / 100.0

    try:
        x, y = _grid_xy(ds)
        xm, ym = np.meshgrid(x, y)
    except KeyError:
        assert lonlat_path is not None, \
            "SMAP file has no x/y grid; provide lonlat_path (NSIDC0771)"
        ll = read_netcdf(lonlat_path)
        lat = np.asarray(ll["latitude"].values, dtype=float).squeeze()[::-1]
        lon = np.asarray(ll["longitude"].values, dtype=float).squeeze()[::-1]
        xm, ym = WGS84toEASE2(lon=lon, lat=lat)

    ok = np.isfinite(thick) & (thick >= thickness_min) & \
        (thick <= thickness_max)
    thick = np.where(ok, thick, np.nan)
    if coarsen_factor > 1:
        thick = thick[::coarsen_factor, ::coarsen_factor]
        xm = xm[::coarsen_factor, ::coarsen_factor]
        ym = ym[::coarsen_factor, ::coarsen_factor]

    valid = np.isfinite(thick)
    df = pd.DataFrame({"x": xm[valid], "y": ym[valid],
                       val_col: thick[valid]})
    df["time"] = np.datetime64(date_str)

    if exclude_regions and region_grid is not None and len(df):
        from scipy.spatial import cKDTree
        rx, ry, rmask = region_grid
        rxm, rym = np.meshgrid(np.asarray(rx, float), np.asarray(ry, float))
        rv = np.asarray(rmask, float).reshape(-1)
        fin = np.isfinite(rv)
        tree = cKDTree(np.column_stack([rxm.reshape(-1)[fin],
                                        rym.reshape(-1)[fin]]))
        _, nn = tree.query(df[["x", "y"]].values)
        drop = np.isin(rv[fin][nn], list(exclude_regions))
        df = df.loc[~drop].reset_index(drop=True)

    if is2_grid is not None:
        gx, gy = is2_grid
        gridded = bin_to_is2(df, gx, gy, val_col=val_col) if len(df) else None
        return df, gridded
    return df


def bin_to_is2(df, x_grid, y_grid, val_col="ice_thickness", grid_res=25_000,
               limit=200_000, by_col="time"):
    """Bin along-track data onto the 25 km IS2 grid (reference: bin_to_IS2,
    extra_funcs.py:31-53). x_grid/y_grid: the target grid's coordinate
    arrays (their extent defines the bin ranges, padded by half a cell)."""
    x_grid = np.asarray(x_grid, dtype=float)
    y_grid = np.asarray(y_grid, dtype=float)
    from gpsat_tpu_torch.dataprepper import DataPrep
    return DataPrep.bin_data_by(
        df=df, by_cols=[by_col], val_col=val_col,
        x_col="x", y_col="y", grid_res=grid_res, limit=limit,
        x_range=[x_grid.min() - grid_res / 2, x_grid.max() + grid_res / 2],
        y_range=[y_grid.min() - grid_res / 2, y_grid.max() + grid_res / 2])
