"""Native netCDF IO — works without xarray/netCDF4/zarr installed
(copy of gpsat_tpu/ncio.py; pandas and h5py are imported inside the
functions that need them).

netCDF4 files ARE HDF5 files following the dimension-scale convention, so the
reader/writer here sit directly on h5py; netCDF3 ("classic") files route
through scipy.io.netcdf_file. When xarray IS importable, callers can keep
using it — `NcDataset` deliberately exposes the same duck-typed surface the
dataloader needs (`dims` / `coords` / `data_vars` / `attrs` /
`to_dataframe()`), including where-clause pushdown onto coordinate dimensions
so a global_select on a huge gridded file subsets BEFORE densifying.

Reference surface replaced (GPSat reads/writes netCDF through xarray):
  - engine-map entries for .nc/.zarr (GPSat/dataloader.py:32-33)
  - xr.open_dataset read path (GPSat/dataloader.py:388-389)
  - xarray where pushdown `_bool_xarray_from_where` + `.where(drop)` +
    `.to_dataframe().dropna(how="all")` (GPSat/dataloader.py:1126-1155,1853)
  - the drivers' NetCDF export (IS2_GPSat_train.py:1063-1130)
  - `mindex_df_to_mindex_dataarray` (GPSat/dataloader.py:2529) via
    `dataset_from_dataframe`.
"""

import numpy as np

__all__ = ["NcVariable", "NcDataset", "read_netcdf", "write_netcdf",
           "dataset_from_dataframe", "have_xarray", "open_zarr"]

_OPS = {">=": np.greater_equal, ">": np.greater, "==": np.equal,
        "!=": np.not_equal, "<": np.less, "<=": np.less_equal}


def have_xarray():
    try:
        import xarray  # noqa: F401
        return True
    except ImportError:
        return False


def open_zarr(path, **kwargs):
    """Open a zarr store. Requires the optional `zarr` (or xarray with a zarr
    backend) dependency — gated with a clear error when absent."""
    try:
        import xarray as xr
        return xr.open_zarr(path, **kwargs)
    except ImportError:
        pass
    try:
        import zarr  # noqa: F401
    except ImportError:
        raise ImportError(
            "reading '.zarr' sources requires the optional 'zarr' (or "
            "'xarray') package, which is not installed in this environment. "
            "Install zarr/xarray, or convert the store to netCDF/HDF5/parquet "
            "first — .nc files are supported natively (gpsat_tpu_torch.ncio).")
    raise NotImplementedError(
        "bare-zarr (without xarray) reading is not implemented; install "
        "xarray or convert the store to netCDF")


class NcVariable:
    """One named N-d variable: dims (tuple of names), values, attrs."""

    def __init__(self, dims, values, attrs=None):
        self.dims = tuple(dims)
        self.values = np.asarray(values)
        self.attrs = dict(attrs or {})
        assert self.values.ndim == len(self.dims), \
            f"{self.values.ndim}-d values with dims {self.dims}"

    def __repr__(self):
        return f"NcVariable(dims={self.dims}, shape={self.values.shape})"


class NcDataset:
    """Minimal in-memory dataset: named dimension coordinates + data
    variables, mirroring the xarray surface the dataloader touches."""

    def __init__(self, data_vars=None, coords=None, attrs=None):
        self.data_vars = dict(data_vars or {})
        self.coords = {k: np.asarray(v).reshape(-1)
                       for k, v in (coords or {}).items()}
        self.attrs = dict(attrs or {})

    @property
    def dims(self):
        out = {}
        for k, v in self.coords.items():
            out[k] = len(v)
        for var in self.data_vars.values():
            for d, s in zip(var.dims, var.values.shape):
                out.setdefault(d, s)
        return out

    def __getitem__(self, name):
        if name in self.data_vars:
            return self.data_vars[name]
        if name in self.coords:
            return NcVariable((name,), self.coords[name])
        raise KeyError(name)

    def __contains__(self, name):
        return name in self.data_vars or name in self.coords

    def keys(self):
        return self.data_vars.keys()

    # -- selection ---------------------------------------------------------

    def isel(self, **indexers):
        """Subset along dimensions by integer/bool index arrays."""
        coords = dict(self.coords)
        for d, idx in indexers.items():
            if d in coords:
                coords[d] = coords[d][idx]
        data_vars = {}
        for name, var in self.data_vars.items():
            vals = var.values
            for ax, d in enumerate(var.dims):
                if d in indexers:
                    vals = np.take(vals, np.where(indexers[d])[0]
                                   if np.asarray(indexers[d]).dtype == bool
                                   else indexers[d], axis=ax)
            data_vars[name] = NcVariable(var.dims, vals, var.attrs)
        return NcDataset(data_vars, coords, self.attrs)

    def sel_where(self, where):
        """Apply a list of {col, comp, val} condition dicts.

        Conditions on coordinate dimensions subset along that dimension
        (the pushdown equivalent of the reference's `_bool_xarray_from_where`
        + `.where(mask, drop=True)`, GPSat/dataloader.py:1126-1155 under AND
        combination). Returns (subset_dataset, leftover_conditions) where
        leftovers reference data variables and must be applied after
        densification."""
        if where is None:
            return self, []
        if isinstance(where, dict):
            where = [where]
        ds, leftover = self, []
        for wd in where:
            wd = dict(wd)
            negate = wd.pop("negate", False)
            col, comp, val = wd.get("col"), wd.get("comp"), wd.get("val")
            if col in ds.coords and comp in _OPS:
                cv = ds.coords[col]
                if np.issubdtype(cv.dtype, np.datetime64) and isinstance(val, str):
                    val = np.datetime64(val)
                m = _OPS[comp](cv, val)
                if negate:
                    m = ~m
                ds = ds.isel(**{col: m})
            else:
                if negate:
                    wd["negate"] = True
                leftover.append(wd)
        return ds, leftover

    # -- densify -----------------------------------------------------------

    def to_dataframe(self, dropna=True):
        """Long-form DataFrame over the union of the data variables' dims
        (xarray semantics: every variable broadcast to the union grid;
        rows that are NaN across all variables dropped, matching the
        reference's `.to_dataframe().dropna(axis=0, how='all')`)."""
        import pandas as pd
        union = []
        for var in self.data_vars.values():
            for d in var.dims:
                if d not in union:
                    union.append(d)
        sizes = self.dims
        shape = tuple(sizes[d] for d in union)
        coord_vals = [self.coords.get(d, np.arange(sizes[d])) for d in union]

        cols = {}
        for name, var in self.data_vars.items():
            # expand to the union grid: place existing dims, size-1 the rest
            reshape = [sizes[d] if d in var.dims else 1 for d in union]
            order = [var.dims.index(d) for d in union if d in var.dims]
            vals = np.transpose(var.values, order) if var.dims else var.values
            cols[name] = np.broadcast_to(vals.reshape(reshape), shape).reshape(-1)
        if union:
            grids = np.meshgrid(*coord_vals, indexing="ij")
            idx_cols = {d: g.reshape(-1) for d, g in zip(union, grids)}
        else:
            idx_cols = {}
        df = pd.DataFrame({**idx_cols, **cols})
        if dropna and self.data_vars:
            keep = ~df[list(self.data_vars)].isna().all(axis=1)
            df = df.loc[keep]
        df.attrs = dict(self.attrs)
        return df.reset_index(drop=True)

    def __repr__(self):
        return (f"NcDataset(dims={self.dims}, coords={list(self.coords)}, "
                f"data_vars={list(self.data_vars)})")


# ---------------------------------------------------------------------------
# decode helpers (CF conventions subset)
# ---------------------------------------------------------------------------

def _decode(values, attrs):
    """Apply _FillValue/missing_value -> NaN and scale_factor/add_offset."""
    fill = attrs.get("_FillValue", attrs.get("missing_value"))
    scale = attrs.get("scale_factor")
    offset = attrs.get("add_offset")
    if fill is None and scale is None and offset is None:
        return values
    vals = np.asarray(values)
    if not np.issubdtype(vals.dtype, np.floating):
        vals = vals.astype(np.float64 if scale is not None or offset is not None
                           or fill is not None else vals.dtype)
    if fill is not None:
        fill = np.asarray(fill).reshape(-1)[0]
        vals = np.where(np.isclose(vals, float(fill)), np.nan, vals)
    if scale is not None:
        vals = vals * float(np.asarray(scale).reshape(-1)[0])
    if offset is not None:
        vals = vals + float(np.asarray(offset).reshape(-1)[0])
    return vals


def _attr_py(v):
    """h5py attr value -> plain python (bytes -> str)."""
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, np.ndarray) and v.dtype.kind == "S":
        return [x.decode("utf-8", "replace") for x in v]
    return v


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

def _read_netcdf4_h5(path, group=None, decode=True):
    import h5py
    ds_out = NcDataset()
    with h5py.File(path, "r") as f:
        root = f[group] if group else f
        ds_out.attrs = {k: _attr_py(v) for k, v in root.attrs.items()
                        if not k.startswith("_NC")}
        names = [k for k in root.keys()
                 if isinstance(root[k], h5py.Dataset)]
        scales = {k for k in names
                  if root[k].attrs.get("CLASS") in (b"DIMENSION_SCALE",
                                                    "DIMENSION_SCALE")}
        for k in names:
            d = root[k]
            attrs = {a: _attr_py(v) for a, v in d.attrs.items()
                     if a not in ("CLASS", "NAME", "DIMENSION_LIST",
                                  "REFERENCE_LIST", "_Netcdf4Dimid",
                                  "_Netcdf4Coordinates")}
            if k in scales:
                vals = d[...]
                ds_out.coords[k] = _decode(vals, attrs) if decode else vals
                continue
            dims = []
            for ax in range(d.ndim):
                try:
                    attached = list(d.dims[ax].keys()) if len(d.dims[ax]) else []
                except Exception:
                    attached = []
                if attached and d.dims[ax][0].name:
                    dims.append(d.dims[ax][0].name.split("/")[-1])
                else:
                    dims.append(f"phony_dim_{ax}")
            vals = d[...]
            if decode:
                vals = _decode(vals, attrs)
            ds_out.data_vars[k] = NcVariable(dims, vals, attrs)
    return ds_out


def _read_netcdf3_scipy(path, decode=True):
    from scipy.io import netcdf_file
    ds_out = NcDataset()
    with netcdf_file(path, "r", mmap=False) as f:
        ds_out.attrs = {k: _attr_py(v) for k, v in f._attributes.items()}
        for k, v in f.variables.items():
            attrs = {a: _attr_py(x) for a, x in v._attributes.items()}
            vals = np.asarray(v.data)
            if decode:
                vals = _decode(vals, attrs)
            if v.dimensions == (k,):
                ds_out.coords[k] = vals
            else:
                ds_out.data_vars[k] = NcVariable(v.dimensions, vals, attrs)
    return ds_out


def read_netcdf(path, group=None, decode=True, **unused):
    """Read a netCDF file into an NcDataset.

    netCDF4 (HDF5-backed) files read via h5py; netCDF3 classic via
    scipy.io.netcdf_file. Coordinate variables (dimension scales / 1-d vars
    named after their dimension) populate `.coords`."""
    with open(path, "rb") as fh:
        magic = fh.read(8)
    if magic[:3] == b"CDF":
        return _read_netcdf3_scipy(path, decode=decode)
    if magic[:8] == b"\x89HDF\r\n\x1a\n" or magic[1:4] == b"HDF":
        return _read_netcdf4_h5(path, group=group, decode=decode)
    raise ValueError(f"{path}: not a netCDF3 or netCDF4/HDF5 file "
                     f"(magic: {magic!r})")


# ---------------------------------------------------------------------------
# writer (netCDF4-flavoured HDF5: dimension-scale convention)
# ---------------------------------------------------------------------------

def write_netcdf(ds, path, mode="w", group=None):
    """Write an NcDataset (or xarray Dataset — same duck type) to an
    HDF5/netCDF4-style file using the dimension-scale convention, readable
    by netCDF4/xarray/h5netcdf and by `read_netcdf` above."""
    import h5py
    coords = {k: np.asarray(v) for k, v in dict(ds.coords).items()}
    # xarray stores variables under .data_vars with .dims/.values/.attrs —
    # NcVariable intentionally matches, so both pass through here
    data_vars = {k: ds.data_vars[k] for k in ds.data_vars}
    sizes = {}
    for var in data_vars.values():
        for d, s in zip(var.dims, np.asarray(var.values).shape):
            sizes.setdefault(d, s)

    with h5py.File(path, mode) as f:
        root = f.require_group(group) if group else f
        for k, v in dict(getattr(ds, "attrs", {}) or {}).items():
            try:
                root.attrs[k] = v
            except TypeError:
                root.attrs[k] = str(v)
        for d, size in sizes.items():
            vals = coords.get(d)
            if vals is None:
                vals = np.arange(size)
            dset = root.create_dataset(d, data=_encode_values(vals))
            dset.make_scale(d)
        for name, var in data_vars.items():
            vals = _encode_values(np.asarray(var.values))
            dset = root.create_dataset(name, data=vals)
            for ax, d in enumerate(var.dims):
                dset.dims[ax].attach_scale(root[d])
            for k, v in dict(getattr(var, "attrs", {}) or {}).items():
                try:
                    dset.attrs[k] = v
                except TypeError:
                    dset.attrs[k] = str(v)
    return path


def _encode_values(vals):
    """datetime64 -> int64 ns since epoch (h5py has no native datetime);
    object/str columns -> variable-length UTF-8."""
    vals = np.asarray(vals)
    if np.issubdtype(vals.dtype, np.datetime64):
        return vals.astype("datetime64[ns]").astype(np.int64)
    if vals.dtype == object or vals.dtype.kind == "U":
        import h5py
        return vals.astype(h5py.string_dtype("utf-8"))
    return vals


# ---------------------------------------------------------------------------
# DataFrame <-> gridded dataset (mindex_df_to_mindex_dataarray equivalent)
# ---------------------------------------------------------------------------

def dataset_from_dataframe(df, value_cols=None, index_cols=None, attrs=None):
    """Pivot a long-form DataFrame onto the dense grid spanned by its index
    columns — the reference's `mindex_df_to_mindex_dataarray`
    (GPSat/dataloader.py:2529) without the xarray dependency.

    index_cols default to the (Multi)Index names (reset if present); cells
    absent from the frame become NaN."""
    import pandas as pd
    if index_cols is None:
        index_cols = [n for n in (df.index.names or []) if n is not None]
        if index_cols:
            df = df.reset_index()
    assert index_cols, "index_cols must be provided (or df multi-indexed)"
    if value_cols is None:
        value_cols = [c for c in df.columns if c not in index_cols]

    coords = {c: np.sort(pd.unique(df[c].values)) for c in index_cols}
    shape = tuple(len(v) for v in coords.values())
    pos = [pd.Index(coords[c]).get_indexer(df[c].values) for c in index_cols]
    flat = np.ravel_multi_index(pos, shape)

    data_vars = {}
    for vc in value_cols:
        grid = np.full(int(np.prod(shape)), np.nan,
                       dtype=np.result_type(df[vc].values.dtype, np.float32)
                       if np.issubdtype(df[vc].values.dtype, np.number)
                       else object)
        grid[flat] = df[vc].values
        data_vars[vc] = NcVariable(tuple(index_cols), grid.reshape(shape))
    return NcDataset(data_vars, coords, attrs)
