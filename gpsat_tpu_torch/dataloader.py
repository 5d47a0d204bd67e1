"""Host-side tabular IO and query — the data plane feeding the device
(copy of gpsat_tpu/dataloader.py).

Re-designed equivalent of the reference's DataLoader (GPSat/dataloader.py,
3277 LoC): universal load from DataFrame/CSV/HDF5(parquet/pickle/npy), `where`
dict-query pushdown, row/column selection, column-derivation functions, KDTree
radius selection for local experts, expert-location generation, and flat-file
sweeps. HDF5 goes through gpsat_tpu_torch.store.ResultsStore (h5py) instead of
pandas.HDFStore (pytables).
"""

import os
import re
import warnings
from functools import reduce

import numpy as np
import pandas as pd
from scipy.spatial import KDTree

from gpsat_tpu_torch.store import ResultsStore
from gpsat_tpu_torch.utils import config_func, pandas_to_dict, cprint

__all__ = ["DataLoader"]


class DataLoader:
    """Namespace class of data-access staticmethods (reference: GPSat/dataloader.py:41)."""

    file_suffix_engine_map = {
        "csv": "read_csv",
        "tsv": "read_csv",
        "h5": "ResultsStore",
        "hdf5": "ResultsStore",
        "parquet": "read_parquet",
        "pkl": "read_pickle",
        "npy": "npy",
        # netCDF reads natively via gpsat_tpu_torch.ncio (h5py for netCDF4,
        # scipy.io for netCDF3); zarr requires the optional zarr/xarray deps
        # (reference suffix map: GPSat/dataloader.py:32-33)
        "nc": "netcdf",
        "nc4": "netcdf",
        "cdf": "netcdf",
        "zarr": "zarr",
    }

    # ------------------------------------------------------------------
    # column / row modification
    # ------------------------------------------------------------------

    @staticmethod
    def add_cols(df, col_func_dict=None, filename=None, verbose=False):
        """Add columns computed via config_func entries; in-place
        (reference: GPSat/dataloader.py:46)."""
        if col_func_dict is None:
            col_func_dict = {}
        for new_col, col_fun in col_func_dict.items():
            if isinstance(new_col, tuple):
                new_col = list(new_col)
                vals = config_func(df=df, filename=filename, **col_fun)
                assert len(vals) == len(new_col), \
                    f"columns {new_col} expect {len(new_col)} outputs, got {len(vals)}"
                for i, v in enumerate(vals):
                    df[new_col[i]] = v
            else:
                df[new_col] = config_func(df=df, filename=filename, **col_fun)

    @staticmethod
    def _bool_numpy_from_where(obj, wd):
        """Bool mask from a condition dict; supports 'negate'
        (reference: GPSat/dataloader.py:1886)."""
        wd = wd.copy()
        negate = wd.pop("negate", False)
        simple = all(k in wd for k in ("col", "comp", "val"))
        if simple:
            col, comp, val = wd["col"], wd["comp"], wd["val"]
            assert col in obj.columns, f"col: '{col}' is not in columns: {list(obj.columns)}"
            ops = {">=": np.greater_equal, ">": np.greater, "==": np.equal,
                   "!=": np.not_equal, "<": np.less, "<=": np.less_equal}
            assert comp in ops, f"comp: {comp} is not valid"
            col_vals = obj[col].values
            # date-string conditions against datetime columns (the canonical
            # GPSat global_select, e.g. {"col": "date", "comp": ">=",
            # "val": "2020-01-01"}) — numpy won't compare datetime64 with
            # str, so coerce the value (reference gets this free from
            # pandas/pytables where-string evaluation, dataloader.py:1161)
            col_dtype = getattr(col_vals, "dtype", None)
            if (isinstance(col_dtype, np.dtype)
                    and np.issubdtype(col_dtype, np.datetime64)
                    and isinstance(val, str)):
                val = np.datetime64(val)
            out = ops[comp](col_vals, val)
        else:
            out = config_func(df=obj, **wd)
            if hasattr(out, "dtype") and str(out.dtype) != "bool":
                warnings.warn("where condition did not return bool array")
        if negate:
            out = ~out
        return np.asarray(out)

    @classmethod
    def row_select_bool(cls, df, row_select=None, combine="AND", **kwargs):
        """AND/OR-combined bool mask over condition dicts
        (reference: GPSat/dataloader.py:137)."""
        if row_select is None:
            row_select = []
        elif isinstance(row_select, dict):
            row_select = [row_select]
        assert isinstance(row_select, list), \
            f"row_select must be list of dict, got: {type(row_select)}"
        combine = combine.upper()
        assert combine in ("AND", "OR")
        masks = [cls._bool_numpy_from_where(df, wd) for wd in row_select]
        if not masks:
            return np.ones(len(df), dtype=bool)
        op = (lambda a, b: a & b) if combine == "AND" else (lambda a, b: a | b)
        return reduce(op, masks)

    @staticmethod
    def add_data_to_col(df, add_data_to_col=None, verbose=False):
        """Assign constant (or repeated list) values to columns; returns new df
        (reference: GPSat/dataloader.py:1415)."""
        if add_data_to_col is None:
            return df
        assert isinstance(add_data_to_col, dict)
        for col, vals in add_data_to_col.items():
            vals = vals if isinstance(vals, (list, np.ndarray)) else [vals]
            reps = []
            for v in vals:
                tmp = df.copy()
                tmp[col] = v
                reps.append(tmp)
            df = pd.concat(reps, axis=0).reset_index(drop=True)
        return df

    # ------------------------------------------------------------------
    # sources
    # ------------------------------------------------------------------

    @classmethod
    def _get_source_from_str(cls, source, _engine=None, verbose=False, **kwargs):
        """str path -> DataFrame or open ResultsStore
        (reference: GPSat/dataloader.py:1294)."""
        assert isinstance(source, str)
        if _engine is None:
            suffix = source.split(".")[-1].lower()
            _engine = cls.file_suffix_engine_map.get(suffix)
            assert _engine is not None, \
                f"could not infer engine from source: {source}"
        if _engine in ("ResultsStore", "HDFStore"):
            return ResultsStore(source, mode="r")
        if _engine == "npy":
            return pd.DataFrame(np.load(source, **kwargs))
        if _engine in ("netcdf", "nc", "xarray"):
            from gpsat_tpu_torch import ncio
            if ncio.have_xarray():
                import xarray as xr
                return xr.open_dataset(source, **kwargs)
            return ncio.read_netcdf(source, **kwargs)
        if _engine == "zarr":
            from gpsat_tpu_torch import ncio
            return ncio.open_zarr(source, **kwargs)
        reader = getattr(pd, _engine, None)
        assert reader is not None, f"engine: {_engine} is not a pandas reader"
        return reader(source, **kwargs)

    @classmethod
    def data_select(cls, obj, where=None, table=None, return_df=True,
                    reset_index=False, drop=True, copy=True, close=False,
                    columns=None, **kwargs):
        """Select (possibly where-filtered) data from an in-memory or on-disk
        source (reference: GPSat/dataloader.py:1011)."""
        if isinstance(where, dict):
            where = [where]

        if isinstance(obj, ResultsStore):
            assert table is not None, "table must be provided for a ResultsStore source"
            df = obj.select(table, where=where, columns=columns, set_index=True)
            if close:
                obj.close()
            if reset_index:
                df = df.reset_index()
            return df

        # gridded sources (native NcDataset, or xarray Dataset/DataArray when
        # installed) — where conditions on coordinate dimensions push down
        # BEFORE densification (reference: GPSat/dataloader.py:1126-1155)
        if hasattr(obj, "data_vars") and hasattr(obj, "to_dataframe"):
            from gpsat_tpu_torch.ncio import NcDataset
            if isinstance(obj, NcDataset):
                sub, leftover = obj.sel_where(where)
                df = sub.to_dataframe()
            else:   # xarray duck type
                coord_names = set(getattr(obj, "coords", {}))
                pushed = [w for w in (where or [])
                          if w.get("col") in coord_names]
                leftover = [w for w in (where or []) if w not in pushed]
                out = obj
                for wd in pushed:
                    wd = dict(wd)
                    negate = wd.pop("negate", False)
                    m = cls._bool_numpy_from_where(
                        pd.DataFrame({wd["col"]:
                                      np.asarray(out.coords[wd["col"]])}), wd)
                    out = out.isel(**{wd["col"]: (~m if negate else m)})
                df = out.to_dataframe().dropna(axis=0, how="all").reset_index()
            if leftover:
                df = df.loc[cls.row_select_bool(df, row_select=leftover)]
            if columns is not None:
                df = df.loc[:, columns]
            if reset_index:
                df = df.reset_index(drop=drop)
            return df

        if isinstance(obj, pd.Series):
            obj = obj.to_frame()
        assert isinstance(obj, pd.DataFrame), \
            f"source type: {type(obj)} not handled"
        df = obj.copy() if copy else obj
        if where:
            mask = cls.row_select_bool(df, row_select=where)
            df = df.loc[mask]
        if columns is not None:
            df = df.loc[:, columns]
        if reset_index:
            df = df.reset_index(drop=drop)
        return df

    @classmethod
    def load(cls, source, where=None, engine=None, table=None,
             source_kwargs=None, col_funcs=None, row_select=None,
             col_select=None, reset_index=False, add_data_to_col=None,
             close=False, verbose=False, combine_row_select="AND", **kwargs):
        """Load + filter + derive columns in one call
        (reference: GPSat/dataloader.py:1522)."""
        if isinstance(source, str):
            source_kwargs = source_kwargs or {}
            close = True
            source = cls._get_source_from_str(source, _engine=engine, **source_kwargs)

        df = cls.data_select(obj=source, where=where, table=table,
                             return_df=True, reset_index=reset_index,
                             drop=True, copy=True, close=close, **kwargs)
        return cls._modify_df(df, col_funcs=col_funcs, row_select=row_select,
                              col_select=col_select,
                              add_data_to_col=add_data_to_col,
                              combine_row_select=combine_row_select,
                              verbose=verbose)

    @classmethod
    def _modify_df(cls, df, col_funcs=None, filename=None, row_select=None,
                   col_select=None, add_data_to_col=None,
                   combine_row_select="AND", verbose=False):
        df = cls.add_data_to_col(df, add_data_to_col=add_data_to_col, verbose=verbose)
        cls.add_cols(df, col_func_dict=col_funcs, verbose=verbose, filename=filename)
        select = cls.row_select_bool(df, row_select=row_select,
                                     combine=combine_row_select)
        df = df.loc[select, :]
        if col_select is not None:
            missing = [c for c in col_select if c not in df]
            assert not missing, f"col_select columns missing: {missing}"
            df = df.loc[:, col_select]
        return df

    # ------------------------------------------------------------------
    # flat-file sweeps (raw satellite data ingestion)
    # ------------------------------------------------------------------

    @classmethod
    def read_from_multiple_files(cls, file_dirs, file_regex=None, sub_dirs=None,
                                 read_engine="csv", col_funcs=None,
                                 row_select=None, col_select=None, verbose=False,
                                 strict=True, read_kwargs=None, **kwargs):
        """Read + concat many flat files, deriving columns per file
        (reference: GPSat/dataloader.py:232)."""
        if isinstance(file_dirs, str):
            file_dirs = [file_dirs]
        if sub_dirs:
            sub_dirs = [sub_dirs] if isinstance(sub_dirs, str) else sub_dirs
            file_dirs = [os.path.join(fd, sd) for fd in file_dirs for sd in sub_dirs]
        read_kwargs = read_kwargs or {}
        reader = {"csv": pd.read_csv, "tsv": pd.read_csv,
                  "parquet": pd.read_parquet}.get(read_engine, pd.read_csv)

        files = []
        for fd in file_dirs:
            if not os.path.isdir(fd):
                msg = f"file dir does not exist: {fd}"
                if strict:
                    raise FileNotFoundError(msg)
                warnings.warn(msg)
                continue
            for fn in sorted(os.listdir(fd)):
                full = os.path.join(fd, fn)
                if os.path.isfile(full) and (file_regex is None or re.search(file_regex, fn)):
                    files.append(full)
        if verbose:
            print(f"reading {len(files)} files")

        out = []
        for fp in files:
            df = reader(fp, **read_kwargs)
            cls.add_cols(df, col_func_dict=col_funcs, filename=fp, verbose=verbose)
            if row_select is not None:
                df = df.loc[cls.row_select_bool(df, row_select=row_select)]
            if col_select is not None:
                df = df.loc[:, col_select]
            out.append(df)
        assert out, f"no files matched regex {file_regex!r} in {file_dirs}"
        return pd.concat(out, axis=0).reset_index(drop=True)

    @classmethod
    def read_flat_files(cls, file_dirs, file_regex, sub_dirs=None,
                        read_csv_kwargs=None, col_funcs=None, row_select=None,
                        verbose=False, **kwargs):
        """CSV-flavoured wrapper of read_from_multiple_files
        (reference: GPSat/dataloader.py:446)."""
        return cls.read_from_multiple_files(
            file_dirs=file_dirs, file_regex=file_regex, sub_dirs=sub_dirs,
            read_engine="csv", col_funcs=col_funcs, row_select=row_select,
            read_kwargs=read_csv_kwargs, verbose=verbose, **kwargs)

    # ------------------------------------------------------------------
    # HDF5 write
    # ------------------------------------------------------------------

    @classmethod
    def write_to_hdf(cls, df, store, table=None, append=False, config=None,
                     run_info=None, index_cols=None):
        """Write a DataFrame (+ config/run-info attrs) to a results store
        (reference: GPSat/dataloader.py:646)."""
        own = False
        if isinstance(store, str):
            store = ResultsStore(store, mode="a")
            own = True
        assert table is not None, "table must be provided"
        try:
            if append:
                store.append(table, df, index_cols=index_cols)
            else:
                store.put(table, df, index_cols=index_cols)
            if config is not None:
                store.set_attr(table, "config", config)
            if run_info is not None:
                store.set_attr(table, "run_info", run_info)
        finally:
            if own:
                store.close()

    @classmethod
    def hdf_tables_in_store(cls, store=None, path=None):
        """(reference: GPSat/dataloader.py:718)"""
        if store is None:
            with ResultsStore(path, mode="r") as s:
                return s.keys()
        return store.keys()

    @staticmethod
    def get_attribute_from_table(source, table, attribute_name):
        """(reference: GPSat/dataloader.py:2990)"""
        own = isinstance(source, str)
        store = ResultsStore(source, mode="r") if own else source
        try:
            return store.get_attr(table, attribute_name)
        except Exception as e:
            warnings.warn(f"could not read attribute {attribute_name} from {table}: {e}")
            return None
        finally:
            if own:
                store.close()

    # ------------------------------------------------------------------
    # local (per-expert) selection
    # ------------------------------------------------------------------

    @staticmethod
    def kdt_tree_list_for_local_select(df, local_select):
        """Pre-build KDTrees for multi-column radius conditions
        (reference: GPSat/dataloader.py:2293)."""
        out = []
        for ls in local_select:
            col, comp = ls["col"], ls["comp"]
            if isinstance(col, str):
                out.append(None)
            else:
                assert comp in ("<", "<="), \
                    "multi-dimensional conditions support only < / <="
                out.append(KDTree(df.loc[:, col].values))
        return out

    @classmethod
    def local_data_select(cls, df, reference_location, local_select,
                          kdtree=None, verbose=False):
        """Select rows near a reference location per the local_select spec
        (reference: GPSat/dataloader.py:2354).

        Single-column conditions compare col against ref[col] + val; list-of-
        column conditions select points within euclidean radius val via KDTree.
        """
        select = np.ones(len(df), dtype=bool)
        reference_location = pandas_to_dict(reference_location)
        ops = {">=": np.greater_equal, ">": np.greater, "==": np.equal,
               "<": np.less, "<=": np.less_equal}
        for idx, ls in enumerate(local_select):
            col, comp = ls["col"], ls["comp"]
            if isinstance(col, str):
                assert col in df, f"col: {col} is not in data columns"
                assert col in reference_location, \
                    f"col: {col} is not in reference_location"
                assert comp in ops, f"comp: {comp} is not valid"
                select &= ops[comp](df[col].values,
                                    reference_location[col] + ls["val"])
            else:
                assert comp in ("<", "<="), \
                    "multi-dimensional conditions support only < / <="
                if kdtree is not None:
                    kdt = kdtree[idx] if isinstance(kdtree, list) else kdtree
                    assert isinstance(kdt, KDTree)
                else:
                    kdt = KDTree(df.loc[:, col].values)
                in_ids = kdt.query_ball_point(
                    x=[reference_location[c] for c in col], r=ls["val"])
                mask = np.zeros(len(df), dtype=bool)
                mask[in_ids] = True
                select &= mask
        return df.loc[select, :]

    @staticmethod
    def get_where_list(global_select, local_select=None, ref_loc=None):
        """Static + dynamic global_select entries -> concrete where dicts
        (reference: GPSat/dataloader.py:2893)."""
        out = []
        ref_loc = pandas_to_dict(ref_loc)
        for gs in global_select:
            if all(c in gs for c in ("col", "comp", "val")):
                out.append(gs)
            else:
                assert local_select is not None, \
                    f"dynamic where {gs} requires local_select"
                assert ref_loc is not None, f"dynamic where {gs} requires ref_loc"
                assert all(c in gs for c in ("loc_col", "src_col", "func")), \
                    f"dynamic where needs keys loc_col/src_col/func, got: {list(gs)}"
                loc_col = gs["loc_col"]
                assert loc_col in ref_loc, f"loc_col: {loc_col} not in ref_loc"
                func = gs["func"]
                if isinstance(func, str):
                    from gpsat_tpu_torch.utils import _resolve_func
                    func = _resolve_func(func)
                for ls in local_select:
                    if loc_col == ls["col"]:
                        out.append({"col": gs["src_col"], "comp": ls["comp"],
                                    "val": func(ref_loc[loc_col], ls["val"])})
        return out

    # ------------------------------------------------------------------
    # expert-location generation
    # ------------------------------------------------------------------

    @staticmethod
    def get_masks_for_expert_loc(ref_data, el_masks=None, obs_col=None,
                                 dims=None, reduce_dims=("date", "t")):
        """Build expert-location masks from a reference dataset
        (reference: GPSat/dataloader.py:2716; there the reference data is an
        xarray object — here it is a long-format DataFrame, the repo's native
        gridded representation).

        el_masks entries:
        - "had_obs": keep cells where `obs_col` has any non-NaN value across
          the reduce dimensions (reference reduces over 'date').
        - {"grid_space": g, "dims": [...]}: keep a regular coarse subgrid of
          the unique per-dim coordinate values (utils.sparse_true_array).
        - any other dict: passed through untouched (a row-select where-dict
          consumed directly by generate_local_expert_locations).

        Returns a list of masks; DataFrame masks hold the *allowed*
        coordinate combinations (semi-join semantics).

        `ref_data` may also be an xarray DataArray/Dataset (the reference's
        native type): it is duck-typed via `.coords`/`.to_dataframe` so no
        xarray import is needed here — grid_space masks read the coordinate
        vectors straight off `.coords`, and had_obs masks reduce over the
        gridded values via the long-format conversion.
        """
        from gpsat_tpu_torch.utils import sparse_true_array

        is_xr = hasattr(ref_data, "coords") and hasattr(ref_data,
                                                        "to_dataframe")

        def _coord_vals(dim):
            if is_xr:
                return np.asarray(ref_data.coords[dim].values)
            return np.unique(np.asarray(ref_data[dim]))

        if is_xr and any(m == "had_obs" for m in el_masks or []):
            # xarray -> long format once; DataArrays need a name for
            # to_dataframe
            da = ref_data
            if obs_col is not None and hasattr(da, "data_vars") \
                    and obs_col in getattr(da, "data_vars", {}):
                da = da[obs_col]
            name = getattr(da, "name", None) or obs_col or "obs"
            ref_df = da.rename(name).to_dataframe().reset_index() \
                if hasattr(da, "rename") else da.to_dataframe().reset_index()
            obs_col = name
        else:
            ref_df = ref_data

        masks = []
        for m in el_masks or []:
            if isinstance(m, str):
                if m == "had_obs":
                    assert obs_col is not None, "had_obs mask needs obs_col"
                    cell_dims = dims or [c for c in ref_df.columns
                                         if c != obs_col
                                         and c not in reduce_dims]
                    had = (ref_df.groupby(cell_dims)[obs_col]
                           .apply(lambda s: s.notna().any()))
                    masks.append(had[had].index.to_frame(index=False))
                else:
                    cprint(f"mask: {m} not understood", "FAIL")
            elif isinstance(m, dict) and "grid_space" in m:
                mdims = m["dims"] if isinstance(m["dims"], list) else [m["dims"]]
                coord_vals = [_coord_vals(d2) for d2 in mdims]
                keep = sparse_true_array(
                    tuple(len(v) for v in coord_vals),
                    grid_space=int(m["grid_space"]))
                mesh = np.meshgrid(*coord_vals, indexing="ij")
                masks.append(pd.DataFrame(
                    {d2: mm[keep] for d2, mm in zip(mdims, mesh)}))
            elif isinstance(m, dict):
                masks.append(m)
            else:
                cprint(f"mask: {m} not understood", "FAIL")
        return masks

    @classmethod
    def generate_local_expert_locations(cls, loc_dims, ref_data=None,
                                        format_type=None, masks=None,
                                        include_col="include", col_func_dict=None,
                                        row_select=None, keep_cols=None,
                                        sort_by=None):
        """Cartesian product of per-dimension location values -> DataFrame
        (reference: GPSat/dataloader.py:2610)."""
        import itertools
        dims, vals = zip(*[(k, np.asarray(v) if not np.isscalar(v) else np.array([v]))
                           for k, v in loc_dims.items()])
        rows = list(itertools.product(*vals))
        df = pd.DataFrame(rows, columns=list(dims))
        if col_func_dict:
            cls.add_cols(df, col_func_dict=col_func_dict)
        if row_select:
            df = df.loc[cls.row_select_bool(df, row_select=row_select)]
        if masks:
            masks = masks if isinstance(masks, list) else [masks]
            keep = np.ones(len(df), dtype=bool)
            for m in masks:
                if isinstance(m, pd.DataFrame):
                    # allowed-coordinate mask (get_masks_for_expert_loc):
                    # semi-join on the shared columns
                    cols = [c for c in m.columns if c in df.columns]
                    assert cols, \
                        f"mask DataFrame shares no columns with locations " \
                        f"({list(m.columns)} vs {list(df.columns)})"
                    key = pd.MultiIndex.from_frame(df[cols])
                    allowed = pd.MultiIndex.from_frame(
                        m[cols].drop_duplicates())
                    keep &= key.isin(allowed)
                else:
                    keep &= cls._bool_numpy_from_where(df, m)
            df = df.loc[keep]
        if keep_cols:
            df = df.loc[:, keep_cols]
        if sort_by:
            df = df.sort_values(sort_by)
        return df.reset_index(drop=True)

    # ------------------------------------------------------------------
    # netCDF write
    # ------------------------------------------------------------------

    @staticmethod
    def write_to_netcdf(ds, path, mode="w", **to_netcdf_kwargs):
        """Write a gridded dataset (NcDataset or xarray Dataset) to netCDF
        (reference: GPSat/dataloader.py:776). xarray objects use their own
        writer when the package is installed; otherwise the native
        dimension-scale HDF5 writer (gpsat_tpu_torch.ncio) handles both."""
        if hasattr(ds, "to_netcdf"):
            ds.to_netcdf(path=path, mode=mode, **to_netcdf_kwargs)
            return path
        from gpsat_tpu_torch.ncio import write_netcdf
        return write_netcdf(ds, path, mode=mode, **to_netcdf_kwargs)

    # ------------------------------------------------------------------
    # multi-index helpers
    # ------------------------------------------------------------------

    @staticmethod
    def make_multiindex_df(idx_dict, **kwargs):
        """Make {name: df} with a constant multi-index from idx_dict
        (reference: GPSat/dataloader.py:2451)."""
        idx_dict = pandas_to_dict(idx_dict)
        out = {}
        for name, df in kwargs.items():
            if isinstance(df, (np.ndarray, list)):
                df = pd.DataFrame(np.asarray(df))
            midx = pd.MultiIndex.from_tuples([tuple(idx_dict.values())] * len(df),
                                             names=list(idx_dict.keys()))
            df = df.copy()
            df.index = midx
            out[name] = df
        return out

    @staticmethod
    def mindex_df_to_arrays(df, value_cols=None, dim_prefix="_dim_"):
        """Extract {col: ndarray} from a table row-set with `_dim_*` columns —
        the parameter-loading path (reference equivalent:
        GPSat/dataloader.py:2529 mindex_df_to_mindex_dataarray)."""
        from gpsat_tpu_torch.utils import dataframe_to_array
        df = df.reset_index(drop=True)
        dim_cols = sorted([c for c in df.columns if re.match(rf"^{dim_prefix}\d+$", c)])
        if value_cols is None:
            value_cols = [c for c in df.columns if c not in dim_cols]
        out = {}
        for vc in value_cols:
            if dim_cols:
                out[vc] = dataframe_to_array(df, vc, idx_col=dim_cols, dropna=False)
            else:
                out[vc] = df[vc].values
        return out
