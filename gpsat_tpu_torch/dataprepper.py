"""Grid binning of raw observations (copy of gpsat_tpu/dataprepper.py;
reference: GPSat/dataprepper.py).

`bin_data` reproduces scipy.binned_statistic(_2d) binning over [x_range,
y_range] at grid_res; `bin_data_by` applies it per group of `by_cols`.

The reference returns an xarray.Dataset; xarray is not part of this stack, so
`bin_data_by` returns a lightweight GriddedDataset whose `.to_dataframe()`
yields the same long-form (dims-indexed) frame consumers use
(e.g. `bin_ds.to_dataframe().dropna().reset_index()` in the inline example).
"""

import types

import numpy as np
import pandas as pd
import scipy.stats as scst

from gpsat_tpu_torch.dataloader import DataLoader
from gpsat_tpu_torch.utils import config_func

__all__ = ["DataPrep", "GriddedDataset"]


class GriddedDataset:
    """Minimal xarray.Dataset stand-in: long-form gridded values + dims."""

    def __init__(self, df, dims, data_vars):
        self._df = df
        self.dims = list(dims)
        self.data_vars = list(data_vars)

    def to_dataframe(self):
        """Long-form DataFrame indexed by the grid dims (incl. NaN cells)."""
        return self._df.set_index(self.dims)

    def __repr__(self):
        return (f"GriddedDataset(dims={self.dims}, data_vars={self.data_vars}, "
                f"cells={len(self._df)})")


class DataPrep:
    """Binning namespace (reference: GPSat/dataprepper.py:23)."""

    @classmethod
    def bin_data_by(cls, df, col_funcs=None, row_select=None, by_cols=None,
                    val_col=None, x_col="x", y_col="y", x_range=None,
                    y_range=None, grid_res=None, bin_statistic="mean",
                    bin_2d=True, limit=10000, return_df=False, verbose=False):
        """Bin `val_col` per unique combination of `by_cols`
        (reference: GPSat/dataprepper.py:23)."""
        df = df.copy()
        if col_funcs:
            for new_col, col_fun in col_funcs.items():
                df[new_col] = config_func(df=df, **col_fun)

        if not bin_2d:
            y_col = x_col
        assert by_cols is not None, "by_cols must be provided"
        by_cols = [by_cols] if isinstance(by_cols, str) else list(by_cols)
        for bc in by_cols + [val_col, x_col, y_col]:
            assert bc in df, f"column: {bc} is not in df.columns: {list(df.columns)}"

        if row_select is not None:
            df = DataLoader.data_select(df, where=row_select)

        bc_pair = df.loc[:, by_cols].drop_duplicates()
        assert len(bc_pair) < limit, \
            f"unique by_cols combinations {len(bc_pair)} > limit {limit}"

        bin_statistic = bin_statistic if isinstance(bin_statistic, list) else [bin_statistic]

        rows = []
        for _, bcp in bc_pair.iterrows():
            select = np.ones(len(df), dtype=bool)
            for bc in by_cols:
                select &= (df[bc] == bcp[bc]).values
            df_bin = df.loc[select, :]

            group_vals = {}
            for bs_ix, bin_stat in enumerate(bin_statistic):
                b, crds = cls.bin_data(df_bin, x_range=x_range, y_range=y_range,
                                       grid_res=grid_res, x_col=x_col,
                                       y_col=y_col, val_col=val_col,
                                       bin_statistic=bin_stat, bin_2d=bin_2d,
                                       return_bin_center=True)
                if len(bin_statistic) == 1:
                    dataname = val_col
                elif isinstance(bin_stat, str):
                    dataname = f"{val_col}_{bin_stat}"
                elif isinstance(bin_stat, (types.FunctionType, types.BuiltinFunctionType)):
                    dataname = f"{val_col}_{bin_stat.__name__}"
                else:
                    dataname = f"{val_col}_{bs_ix}"
                group_vals[dataname] = (b, crds)

            first_b, crds = next(iter(group_vals.values()))
            if bin_2d:
                xc, yc = crds
                Y, X = np.meshgrid(yc, xc, indexing="ij")
                base = {y_col: Y.reshape(-1), x_col: X.reshape(-1)}
            else:
                base = {x_col: crds}
            frame = pd.DataFrame(base)
            for bc in by_cols:
                frame[bc] = bcp[bc]
            for dataname, (b, _) in group_vals.items():
                frame[dataname] = b.reshape(-1)
            rows.append(frame)

        long_df = pd.concat(rows, axis=0).reset_index(drop=True)
        dims = ([y_col, x_col] if bin_2d else [x_col]) + by_cols
        data_vars = [c for c in long_df.columns if c not in dims]
        ds = GriddedDataset(long_df, dims=dims, data_vars=data_vars)
        return ds.to_dataframe() if return_df else ds

    @staticmethod
    def bin_data(df, x_range=None, y_range=None, grid_res=None, x_col="x",
                 y_col="y", val_col=None, bin_statistic="mean", bin_2d=True,
                 return_bin_center=True):
        """Single 1-d/2-d binned statistic over a fixed grid
        (reference: GPSat/dataprepper.py:226).

        Returns (binned[Ny, Nx] (transposed like the reference), (x, y) bin
        centers or edges) for 2-d; (binned[Nx], x) for 1-d.
        """
        assert val_col is not None, "val_col must be provided"
        assert grid_res is not None, "grid_res must be provided"
        assert len(df) > 0, "df must have len > 0"

        if not bin_2d:
            y_col = x_col
        if x_range is None:
            x_range = [-4500000.0, 4500000.0]
        if y_range is None:
            y_range = [-4500000.0, 4500000.0]
        assert x_range[0] < x_range[1]
        assert y_range[0] < y_range[1]

        x_min, x_max = x_range
        y_min, y_max = y_range
        n_x = int((x_max - x_min) / grid_res) + 1
        n_y = int((y_max - y_min) / grid_res) + 1
        for c in (x_col, y_col, val_col):
            assert c in df, f"column: {c} is not in df.columns: {list(df.columns)}"

        x_edge = np.linspace(x_min, x_max, n_x)
        y_edge = np.linspace(y_min, y_max, n_y)
        x_in, y_in, vals = df[x_col].values, df[y_col].values, df[val_col].values

        if bin_2d:
            binned = scst.binned_statistic_2d(
                x_in, y_in, vals, statistic=bin_statistic,
                bins=[x_edge, y_edge], range=[[x_min, x_max], [y_min, y_max]])
        else:
            binned = scst.binned_statistic(
                x_in, vals, statistic=bin_statistic, bins=x_edge,
                range=[x_min, x_max])

        if return_bin_center:
            xy_out = (x_edge[:-1] + np.diff(x_edge) / 2,
                      y_edge[:-1] + np.diff(y_edge) / 2)
        else:
            xy_out = (x_edge, y_edge)

        if bin_2d:
            return binned[0].T, (xy_out[0], xy_out[1])
        return binned[0].T, xy_out[0]
