"""HDF5 results store, h5py-backed (copy of gpsat_tpu/store.py: the same
on-disk schema, so a store written by either package reads back in the
other).

The reference persists everything through pandas.HDFStore (pytables) tables
(reference: GPSat/local_experts.py:500-550, 691-747). pytables is not part of
this stack, so gpsat_tpu defines its own HDF5 table format on h5py with the
same *logical* schema and operations the framework needs:

- named tables (HDF5 groups) holding typed column datasets, appendable,
- index columns (multi-index semantics) stored as regular columns and
  restored on read (`select` returns a DataFrame indexed by them),
- `where` filtering with the same condition dicts/strings the reference uses,
- JSON-able per-table attributes (configs, run info).

h5py and pandas are imported when a store is opened or a table is read or
written, never when this module is imported (the card's machine has
neither).

Layout per table (HDF5 group `/table_name`):
    attrs: "index_cols" (JSON list), "column_order" (JSON list), user attrs
    one resizable 1-d dataset per column; strings are utf-8 vlen.
"""

import json
import os
import re

import numpy as np

__all__ = ["ResultsStore"]


def _str_dtype():
    import h5py
    return h5py.string_dtype(encoding="utf-8")


def _to_h5_array(values):
    """Column values -> (h5-storable array, logical dtype tag)."""
    arr = np.asarray(values)
    if arr.dtype.kind in ("O", "U", "S"):
        return np.asarray([("" if v is None else str(v)) for v in arr], dtype=object), "str"
    if arr.dtype.kind == "M":  # datetime64 -> int64 ns + tag
        return arr.astype("datetime64[ns]").astype(np.int64), "datetime64[ns]"
    if arr.dtype.kind == "b":
        return arr.astype(np.uint8), "bool"
    return arr, str(arr.dtype)


def _from_h5_array(arr, tag):
    if tag == "str":
        return np.asarray([v.decode() if isinstance(v, bytes) else v for v in arr],
                          dtype=object)
    if tag == "datetime64[ns]":
        return arr.astype(np.int64).astype("datetime64[ns]")
    if tag == "bool":
        return arr.astype(bool)
    return arr.astype(np.dtype(tag))


_WHERE_STR_RE = re.compile(
    r"^\s*([\w\.\-]+)\s*(==|!=|>=|<=|>|<)\s*(.+?)\s*$")


def _parse_where_entry(w):
    """Accept {'col','comp','val'} dicts or 'col == val' strings."""
    if isinstance(w, dict):
        return w["col"], w["comp"], w["val"]
    if isinstance(w, str):
        m = _WHERE_STR_RE.match(w)
        assert m, f"could not parse where string: {w!r}"
        col, comp, raw = m.groups()
        raw = raw.strip()
        if re.match(r"^['\"].*['\"]$", raw):
            val = raw[1:-1]
        else:
            try:
                val = int(raw)
            except ValueError:
                try:
                    val = float(raw)
                except ValueError:
                    val = raw
        return col, comp, val
    raise TypeError(f"where entry must be dict or str, got: {type(w)}")


_COMPARATORS = {
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    ">=": lambda a, b: a >= b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    "<": lambda a, b: a < b,
    "in": lambda a, b: np.isin(a, b),
}


class ResultsStore:
    """Appendable multi-table HDF5 store with pandas-like select semantics."""

    def __init__(self, path, mode="a"):
        self.path = path
        self.mode = mode
        if mode in ("a", "r+", "w") and os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        import h5py
        self._f = h5py.File(path, mode)

    # -- lifecycle -----------------------------------------------------------

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __contains__(self, table):
        return self.has_table(table)

    # -- table inspection ----------------------------------------------------

    def keys(self):
        return [k for k in self._f.keys()]

    def has_table(self, table):
        return table in self._f

    # -- write ---------------------------------------------------------------

    def append(self, table, df, index_cols=None, min_itemsize=None):
        """Append a DataFrame to a table, creating it if needed.

        index_cols: which columns form the (multi-)index on read. If the input
        DataFrame has a named (Multi)Index it is reset into columns and used.
        """
        import pandas as pd
        df = df.copy()
        if index_cols is None:
            if df.index.name is not None or (
                    isinstance(df.index, pd.MultiIndex) and any(df.index.names)):
                index_cols = [n for n in df.index.names if n is not None]
                df = df.reset_index()
            else:
                index_cols = []
        elif index_cols and list(df.index.names) == list(index_cols):
            df = df.reset_index()

        if table not in self._f:
            grp = self._f.create_group(table)
            grp.attrs["index_cols"] = json.dumps(list(index_cols))
            grp.attrs["column_order"] = json.dumps([str(c) for c in df.columns])
            for col in df.columns:
                arr, tag = _to_h5_array(df[col].values)
                dt = _str_dtype() if tag == "str" else arr.dtype
                ds = grp.create_dataset(str(col), shape=(len(arr),),
                                        maxshape=(None,), dtype=dt,
                                        chunks=(max(1, min(len(arr), 4096)),))
                ds[...] = arr
                ds.attrs["dtype_tag"] = tag
        else:
            grp = self._f[table]
            existing = json.loads(grp.attrs["column_order"])
            new_cols = [str(c) for c in df.columns]
            if set(new_cols) != set(existing):
                missing = [c for c in existing if c not in new_cols]
                extra = [c for c in new_cols if c not in existing]
                if missing:
                    raise ValueError(
                        f"append to '{table}': missing columns {missing}")
                if extra:
                    import warnings
                    warnings.warn(f"append to '{table}': ignoring extra columns {extra}")
            n_new = len(df)
            for col in existing:
                ds = grp[col]
                arr, tag = _to_h5_array(df[col].values)
                n_old = ds.shape[0]
                ds.resize((n_old + n_new,))
                ds[n_old:] = arr
        self._f.flush()

    def put(self, table, df, index_cols=None, attrs=None):
        """Create-or-replace a table."""
        if table in self._f:
            old_attrs = dict(self._f[table].attrs)
            del self._f[table]
        else:
            old_attrs = {}
        self.append(table, df, index_cols=index_cols)
        merged = {k: v for k, v in old_attrs.items()
                  if k not in ("index_cols", "column_order")}
        if attrs:
            merged.update(attrs)
        for k, v in merged.items():
            self.set_attr(table, k, v)

    def set_attr(self, table, key, value):
        """Attach a JSON-serialisable attribute to a table."""
        from gpsat_tpu_torch.utils import json_serializable
        grp = self._f[table]
        grp.attrs[f"user__{key}"] = json.dumps(json_serializable(value))
        self._f.flush()

    def get_attr(self, table, key, default=None):
        grp = self._f[table]
        raw = grp.attrs.get(f"user__{key}", None)
        return default if raw is None else json.loads(raw)

    def attrs(self, table):
        grp = self._f[table]
        return {k[len("user__"):]: json.loads(v) for k, v in grp.attrs.items()
                if k.startswith("user__")}

    # -- read ----------------------------------------------------------------

    def _read_column(self, grp, col, sel=None):
        """Column read with row pushdown: only the [first-match, last-match)
        byte range is read from disk, so windowed `where` queries on
        append-ordered stores (the reference's dominant access pattern —
        per-day global_select over a date-sorted table,
        GPSat/dataloader.py:1161-1192 pytables `where`) scale with the match
        size, not the table size."""
        ds = grp[col]
        tag = ds.attrs.get("dtype_tag", str(ds.dtype))
        if sel is None:
            raw = ds[...]
        else:
            nz = np.flatnonzero(sel)
            if len(nz) == 0:
                raw = ds[0:0]
            else:
                lo, hi = int(nz[0]), int(nz[-1]) + 1
                raw = ds[lo:hi]
                if hi - lo != len(nz):
                    raw = raw[sel[lo:hi]]
        return _from_h5_array(raw, tag)

    def select(self, table, where=None, columns=None, set_index=True):
        """Read a table as a DataFrame; optional where filter + column subset.

        where: None, a condition dict/str, or a list of them (ANDed) — the
        reference's HDFStore `where` semantics (GPSat/dataloader.py:1839).
        """
        assert table in self._f, f"table '{table}' not in store: {self.keys()}"
        grp = self._f[table]
        index_cols = json.loads(grp.attrs["index_cols"])
        column_order = json.loads(grp.attrs["column_order"])

        sel = None
        if where is not None:
            where = where if isinstance(where, list) else [where]
            for w in where:
                col, comp, val = _parse_where_entry(w)
                assert comp in _COMPARATORS, f"comp: {comp} not supported"
                assert col in grp, f"where column '{col}' not in table '{table}'"
                vals = self._read_column(grp, col)
                cond = _COMPARATORS[comp](vals, val)
                sel = cond if sel is None else (sel & cond)
            if sel is not None:
                sel = np.asarray(sel, dtype=bool)

        read_cols = column_order if columns is None else [
            c for c in column_order if c in set(columns) | set(index_cols)]
        import pandas as pd
        data = {c: self._read_column(grp, c, sel) for c in read_cols}
        df = pd.DataFrame(data)
        if set_index and index_cols:
            df = df.set_index(index_cols)
        return df

    def get(self, table):
        return self.select(table)

    def nrows(self, table):
        grp = self._f[table]
        cols = json.loads(grp.attrs["column_order"])
        return grp[cols[0]].shape[0] if cols else 0

    def index_cols(self, table):
        return json.loads(self._f[table].attrs["index_cols"])
