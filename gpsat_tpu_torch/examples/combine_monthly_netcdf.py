"""Combine monthly gridded OI products into one cleaned netCDF (the port's
counterpart of examples/combine_monthly_netcdf.py).

Native equivalent of the reference's monthly-product combiner
(reference: IS2_SM_GP/combine_monthly_netcdf.py):

- scan `data_dir` for run subdirs named {run_string}_{YYYYMMDD}_{version},
  pick the product .nc inside each, and concatenate along a new time axis
  (all inputs are assumed to share one 2-d grid — no regridding);
- optionally attach static 2-d fields: grid-cell area (NSIDC0771-style) and
  a region mask (NSIDC0780-style), masking the Canadian Archipelago
  (region index 12) out of the thickness/uncertainty variables;
- optionally attach the month's middle-day (15th) sea-ice concentration
  from a CDR-style daily directory tree ({sic_dir}/{year}/*YYYYMM15*.nc),
  flipped north-up like the reference;
- write the combined product with the polar-stereographic CRS metadata.

Everything reads/writes through gpsat_tpu_torch.ncio (no xarray/netCDF4/cartopy
dependency). Usage:

    python -m gpsat_tpu_torch.examples.combine_monthly_netcdf --data-dir out/thickness \
        [--run-string run_30days_smap] [--version v01] [--out combined.nc]
"""

import argparse
import glob
import os
import re
from datetime import datetime

import numpy as np

from gpsat_tpu_torch.ncio import (NcDataset, NcVariable, read_netcdf,
                                  write_netcdf)
from gpsat_tpu_torch.utils import cprint

CAA_REGION_INDEX = 12   # NSIDC-0780 Canadian Archipelago

CRS_ATTRS = {
    "long_name": "NSIDC Sea Ice Polar Stereographic North",
    "grid_mapping_name": "polar_stereographic",
    "latitude_of_projection_origin": 90.0,
    "standard_parallel": 70.0,
    "straight_vertical_longitude_from_pole": -45.0,
    "false_easting": 0.0,
    "false_northing": 0.0,
}


def parse_date_from_filename(path):
    """YYYY-MM-DD or YYYYMMDD anywhere in the basename -> datetime or None
    (reference: combine_monthly_netcdf.py:57). Reference-parity helper for
    dating loose product files; the combiner flow itself derives dates from
    the {run_string}_{YYYYMMDD}_{version} directory names."""
    base = os.path.basename(path)
    m = re.search(r"(\d{4})-(\d{2})-(\d{2})", base)
    if not m:
        m = re.search(r"(\d{4})(\d{2})(\d{2})", base)
    return datetime(int(m.group(1)), int(m.group(2)), int(m.group(3))) \
        if m else None


def collect_monthly_files(data_dir, run_string, version_string,
                          file_pattern="*.nc"):
    """Find one product file per {run_string}_{YYYYMMDD}_{version} subdir;
    returns (paths, first-of-month dates) sorted by date
    (reference: combine_monthly_netcdf.py:70-117)."""
    prefix, suffix = run_string + "_", "_" + version_string
    dated = []
    for name in sorted(os.listdir(data_dir)):
        sub = os.path.join(data_dir, name)
        if not (os.path.isdir(sub) and name.startswith(prefix)
                and name.endswith(suffix)):
            continue
        middle = name[len(prefix):-len(suffix)]
        if len(middle) != 8 or not middle.isdigit():
            continue
        d = datetime(int(middle[:4]), int(middle[4:6]), 1)
        cands = sorted(glob.glob(os.path.join(sub, file_pattern))) or \
            sorted(glob.glob(os.path.join(sub, "*.nc")))
        if not cands:
            continue
        f = cands[0]
        mon = middle[:6]
        for c in cands:     # prefer a file naming this month
            if mon in os.path.basename(c):
                f = c
                break
        dated.append((d, f))
    dated.sort(key=lambda t: t[0])
    return [p for _, p in dated], [d for d, _ in dated]


def _var2d(ds, names):
    """First present variable among `names` as a float 2-d array."""
    for n in names:
        if n in ds:
            return np.asarray(ds[n].values, dtype=float).squeeze()
    return None


def load_middle_day_sic(sic_dir, year, month):
    """SIC for the 15th of the month from {sic_dir}/{year}/*YYYYMM15*.nc,
    flipped north-up (reference: combine_monthly_netcdf.py:152-191). The
    concentration-variable name list and flip convention are satdata's —
    one CDR reader surface, not two."""
    from gpsat_tpu_torch.satdata import _CONC_NAMES
    base = os.path.join(sic_dir, str(year))
    if not os.path.isdir(base):
        base = sic_dir
    date_str = f"{year:04d}{month:02d}15"
    files = sorted(glob.glob(os.path.join(base, f"*{date_str}*.nc")))
    if not files:
        files = sorted(glob.glob(os.path.join(
            base, f"*{year:04d}-{month:02d}-15*.nc")))
    if not files:
        return None
    ds = read_netcdf(files[0])
    conc = _var2d(ds, _CONC_NAMES)
    return None if conc is None else conc[::-1]


def combine_monthly_netcdf(data_dir, run_string="run_30days_smap",
                           version_string="v01", file_pattern="*.nc",
                           cell_area_path=None, region_mask_path=None,
                           sic_dir=None, caa_region=CAA_REGION_INDEX,
                           mask_vars=("ice_thickness", "ice_thickness_unc"),
                           out_path=None):
    """Concatenate monthly products + attach static/auxiliary fields.

    Returns the combined NcDataset (and writes it to `out_path` when
    given). Reference: combine_monthly_netcdf.py main flow (collect ->
    concat along time -> cell area -> region mask w/ CAA masking of
    thickness-like variables -> middle-day SIC -> CRS metadata).
    """
    files, dates = collect_monthly_files(data_dir, run_string,
                                         version_string, file_pattern)
    assert files, (f"no {run_string}_YYYYMMDD_{version_string} product dirs "
                   f"with .nc files under {data_dir}")

    first = read_netcdf(files[0])
    x = np.asarray(first["x"].values).reshape(-1)
    y = np.asarray(first["y"].values).reshape(-1)
    ny, nx = len(y), len(x)
    var_names = [k for k in first.keys()
                 if first[k].values.squeeze().ndim == 2]

    stacked = {v: [] for v in var_names}
    for f in files:
        ds = read_netcdf(f)
        for v in var_names:
            arr = _var2d(ds, (v,))
            assert arr is not None and arr.shape == (ny, nx), \
                f"{f}: variable {v} missing or off-grid {arr.shape}"
            stacked[v].append(arr)

    times = np.array([np.datetime64(d.strftime("%Y-%m-%d")) for d in dates],
                     dtype="datetime64[ns]")
    data_vars = {v: NcVariable(("time", "y", "x"),
                               np.stack(vals).astype(np.float32))
                 for v, vals in stacked.items()}

    if cell_area_path:
        area_ds = read_netcdf(cell_area_path)
        area = _var2d(area_ds, ("cell_area",) + tuple(area_ds.keys()))
        assert area is not None and area.shape == (ny, nx), \
            f"cell area grid {None if area is None else area.shape} != grid"
        data_vars["grid_cell_area"] = NcVariable(
            ("y", "x"), area.astype(np.float32), {"units": "m2"})

    if region_mask_path:
        rm_ds = read_netcdf(region_mask_path)
        r = _var2d(rm_ds, ("sea_ice_region_surface_mask", "region_mask")
                   + tuple(rm_ds.keys()))
        assert r is not None and r.shape == (ny, nx)
        r = r[::-1]     # reference flips to match grid orientation
        caa = r == caa_region
        data_vars["region_mask"] = NcVariable(
            ("y", "x"),
            np.where(np.isfinite(r), r, -9999).astype(np.int16),
            {"flag_meanings": "NSIDC-0780 region indices",
             "missing_value": -9999})
        for v in mask_vars:     # CAA masked out of thickness-like vars only
            if v in data_vars and data_vars[v].dims == ("time", "y", "x"):
                vals = data_vars[v].values.copy()
                vals[:, caa] = np.nan
                data_vars[v] = NcVariable(data_vars[v].dims, vals,
                                          data_vars[v].attrs)

    if sic_dir:
        sic = np.full((len(files), ny, nx), np.nan, dtype=np.float32)
        for i, d in enumerate(dates):
            s = load_middle_day_sic(sic_dir, d.year, d.month)
            if s is not None and s.shape == (ny, nx):
                sic[i] = s
        data_vars["sea_ice_conc"] = NcVariable(
            ("time", "y", "x"), sic,
            {"long_name": "middle-of-month sea ice concentration"})

    combined = NcDataset(
        data_vars=data_vars,
        coords={"time": times, "x": x, "y": y},
        attrs={**CRS_ATTRS,
               "source": f"{run_string}_*_{version_string} monthly products",
               "n_months": len(files)})
    if out_path:
        write_netcdf(combined, out_path)
        cprint(f"combined {len(files)} months -> {out_path}", "OKGREEN")
    return combined


# panel spec per variable: (title, colorbar label, vmin, vmax, cmap)
_BROWSE_PANELS = (
    ("sea_ice_conc", "sea ice concentration", "concentration", 0.0, 1.0,
     "Blues_r"),
    ("ice_thickness", "sea ice thickness", "ice thickness (m)", 0.0, 4.0,
     "viridis"),
    ("ice_thickness_unc", "thickness uncertainty", "uncertainty (m)", 0.0,
     1.0, "magma"),
)


def _masked2d(combined, name, ti, fill_value):
    if name not in combined:
        return None
    v = combined[name].values
    arr = np.asarray(v[ti] if v.ndim == 3 else v, dtype=float)
    return np.ma.masked_where(~np.isfinite(arr) | (arr == fill_value), arr)


def plot_browse_month(combined, time_idx, save_path, fill_value=-999.0):
    """V4-style per-month browse image: up to 3 panels (concentration,
    thickness, uncertainty) drawn on the product's own polar-stereographic
    x/y grid (reference: combine_monthly_netcdf.py:358 plot_browse_month_v1;
    the data are already projected, so no cartopy is needed)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x = np.asarray(combined["x"].values).reshape(-1)
    y = np.asarray(combined["y"].values).reshape(-1)
    t = combined.coords["time"][time_idx]
    mon = np.datetime_as_string(np.asarray(t, dtype="datetime64[M]"))

    panels = [(p, _masked2d(combined, p[0], time_idx, fill_value))
              for p in _BROWSE_PANELS]
    panels = [(p, a) for p, a in panels if a is not None]
    if not panels:
        return False
    fig, axs = plt.subplots(1, len(panels),
                            figsize=(4.2 * len(panels), 4.6))
    axs = np.atleast_1d(axs)
    for ax, ((_, title, cbl, vmin, vmax, cmap), arr) in zip(axs, panels):
        pm = ax.pcolormesh(x, y, arr, vmin=vmin, vmax=vmax, cmap=cmap,
                           shading="nearest")
        ax.set_aspect("equal")
        ax.set_title(title, fontsize=10)
        ax.set_xticks([])
        ax.set_yticks([])
        fig.colorbar(pm, ax=ax, orientation="horizontal", pad=0.03,
                     label=cbl, shrink=0.9)
    fig.suptitle(str(mon), fontsize=12)
    fig.savefig(save_path, dpi=200, bbox_inches="tight")
    plt.close(fig)
    return True


def plot_seasonal_cycle(combined, save_path, fill_value=-999.0,
                        regions=(1, 7)):
    """Seasonal-cycle browse image: area-weighted mean thickness and mean
    concentration per month, masked to region indices regions[0]..regions[1]
    when a region mask is present (reference: combine_monthly_netcdf.py:471)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    times = np.asarray(combined.coords["time"], dtype="datetime64[M]")
    th = combined["ice_thickness"].values \
        if "ice_thickness" in combined else None
    if th is None or th.ndim != 3:
        return False
    nt = th.shape[0]
    ok = np.isfinite(th) & (th != fill_value)
    if "region_mask" in combined:
        r = combined["region_mask"].values
        ok &= ((r >= regions[0]) & (r <= regions[1]))[None]
    area = combined["grid_cell_area"].values \
        if "grid_cell_area" in combined else np.ones(th.shape[1:])
    w = np.where(ok, area[None], 0.0)
    mean_th = np.divide(
        (np.where(ok, th, 0.0) * area[None]).sum(axis=(1, 2)),
        np.maximum(w.sum(axis=(1, 2)), 1e-30))
    series = [("area-weighted mean thickness (m)", mean_th)]
    if "sea_ice_conc" in combined:
        c = combined["sea_ice_conc"].values
        good = np.isfinite(c) & (c != fill_value) & ok
        # explicit guard: np.nanmean warns (warnings, not errstate) on
        # all-NaN months; an empty month plots as a gap
        cnt = good.sum(axis=(1, 2))
        tot = np.where(good, c, 0.0).sum(axis=(1, 2))
        series.append(("mean concentration",
                       np.where(cnt > 0, tot / np.maximum(cnt, 1), np.nan)))
    fig, axs = plt.subplots(len(series), 1, figsize=(8, 3 * len(series)),
                            sharex=True, squeeze=False)
    for ax, (label, vals) in zip(axs[:, 0], series):
        ax.plot(times.astype("datetime64[D]").astype("O"), vals[:nt],
                marker="o")
        ax.set_ylabel(label, fontsize=9)
        ax.grid(alpha=0.3)
    fig.suptitle("Seasonal cycle "
                 f"(regions {regions[0]}-{regions[1]})", fontsize=11)
    fig.savefig(save_path, dpi=200, bbox_inches="tight")
    plt.close(fig)
    return True


def write_browse_images(combined, browse_dir, base_name="combined",
                        fill_value=-999.0):
    """All browse products: one per-month panel PNG + one seasonal-cycle PNG
    (reference main flow: combine_monthly_netcdf.py:678-694). Returns the
    list of paths written."""
    os.makedirs(browse_dir, exist_ok=True)
    written = []
    p = os.path.join(browse_dir, f"{base_name}_browse_seasonal_cycle.png")
    if plot_seasonal_cycle(combined, p, fill_value):
        written.append(p)
    times = np.asarray(combined.coords["time"], dtype="datetime64[M]")
    for ti in range(len(times)):
        ym = np.datetime_as_string(times[ti]).replace("-", "")
        p = os.path.join(browse_dir, f"{base_name}_browse_{ym}.png")
        if plot_browse_month(combined, ti, p, fill_value):
            written.append(p)
    for p in written:
        cprint(f"browse: {p}", "OKBLUE")
    return written


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--run-string", default="run_30days_smap")
    ap.add_argument("--version", default="v01")
    ap.add_argument("--file-pattern", default="*.nc")
    ap.add_argument("--cell-area", default=None)
    ap.add_argument("--region-mask", default=None)
    ap.add_argument("--sic-dir", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--browse-dir", default=None,
                    help="write V4-style per-month browse PNGs + a "
                         "seasonal-cycle PNG here")
    ap.add_argument("--fill-value", type=float, default=-999.0)
    args = ap.parse_args(argv)
    out = args.out or os.path.join(
        args.data_dir, f"combined_{args.run_string}_{args.version}.nc")
    combined = combine_monthly_netcdf(
        args.data_dir, run_string=args.run_string,
        version_string=args.version, file_pattern=args.file_pattern,
        cell_area_path=args.cell_area, region_mask_path=args.region_mask,
        sic_dir=args.sic_dir, out_path=out)
    if args.browse_dir:
        write_browse_images(combined, args.browse_dir,
                            os.path.splitext(os.path.basename(out))[0],
                            args.fill_value)


if __name__ == "__main__":
    main()
