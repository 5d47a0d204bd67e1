"""Per-expert prediction-location generation (copy of
gpsat_tpu/prediction_locations.py; reference:
GPSat/prediction_locations.py:50).

Methods: 'expert_loc' (predict at the expert), 'shift_arrays' (meshgrid
offsets around the expert), 'from_dataframe' / 'from_source' (fixed grid with
radius culling). Missing coordinate dimensions are filled from the expert
location.

The reference's numba gufunc `_max_dist_bool` (prediction_locations.py:18) is
replaced with a chunked vectorised numpy radius cull; inputs of 100 000 rows
or more go through the native C++/OpenMP helper (gpsat_tpu_torch/native),
which gives the same mask.
"""

import numpy as np
import pandas as pd

from gpsat_tpu_torch.dataloader import DataLoader
from gpsat_tpu_torch.utils import match, to_array

__all__ = ["PredictionLocations", "max_dist_bool"]


def max_dist_bool(locs, ref_loc, max_dist, chunk=4_000_000, use_native=True):
    """Bool mask of rows of `locs` [n, d] within euclidean `max_dist` of
    `ref_loc` [d]; chunked to bound memory for ~1e8-row inputs.

    Large inputs route through the native C++/OpenMP kernel
    (gpsat_tpu_torch/native/hostops.cpp) when available."""
    locs = np.asarray(locs)
    if use_native and len(locs) >= 100_000:
        from gpsat_tpu_torch import native
        if native._load() is not None:
            return native.max_dist_bool(locs, ref_loc, max_dist)
    ref = np.asarray(ref_loc).reshape(-1)
    out = np.empty(len(locs), dtype=bool)
    md2 = float(max_dist) ** 2
    for s in range(0, len(locs), chunk):
        e = min(s + chunk, len(locs))
        d2 = np.sum((locs[s:e] - ref) ** 2, axis=1)
        out[s:e] = d2 < md2
    return out


class PredictionLocations:

    def __init__(self, method="expert_loc", coords_col=None, expert_loc=None,
                 **kwargs):
        self.method = method
        self.kwargs = kwargs
        self._coords_col = None
        self.coords_col = coords_col
        self._expert_loc = None
        self.expert_loc = expert_loc

    # -- properties ----------------------------------------------------------

    @property
    def coords_col(self):
        return self._coords_col

    @coords_col.setter
    def coords_col(self, value):
        if value is None:
            self._coords_col = None
        elif isinstance(value, np.ndarray):
            assert value.ndim == 1
            self._coords_col = value.tolist()
        elif isinstance(value, list):
            self._coords_col = value
        else:
            raise ValueError(f"coords_col type not handled: {type(value)}")

    @staticmethod
    def _1row_2d_array(x):
        if isinstance(x, list):
            x = np.array(x)
        assert isinstance(x, np.ndarray)
        if x.ndim == 1:
            x = x[None, :]
        assert x.ndim == 2 and x.shape[0] == 1, \
            f"expert location must be a single row, got shape {x.shape}"
        return x

    @property
    def expert_loc(self):
        return self._expert_loc

    @expert_loc.setter
    def expert_loc(self, value):
        if isinstance(value, np.ndarray):
            self._expert_loc = self._1row_2d_array(value)
        elif isinstance(value, (pd.DataFrame, pd.Series)):
            assert self.coords_col is not None, \
                "setting expert_loc from pandas requires coords_col"
            self._expert_loc = self._1row_2d_array(value[self.coords_col].values)
        elif isinstance(value, list):
            self._expert_loc = self._1row_2d_array(value)
        elif value is None:
            self._expert_loc = None
        else:
            raise ValueError(f"expert_loc type not handled: {type(value)}")

    # -- generation ----------------------------------------------------------

    def __call__(self):
        if self.method == "shift_arrays":
            out = self._shift_arrays(**self.kwargs)
        elif self.method == "expert_loc":
            out = self.expert_loc
        elif self.method == "from_dataframe":
            out = self._from_dataframe(**self.kwargs)
        elif self.method == "from_source":
            assert "load_kwargs" in self.kwargs, \
                "'from_source' requires 'load_kwargs' for DataLoader.load"
            load_kwargs = self.kwargs.pop("load_kwargs")
            df = DataLoader.load(**load_kwargs).drop_duplicates()
            self.method = "from_dataframe"
            self.kwargs["df"] = df
            out = self._from_dataframe(**self.kwargs)
        else:
            raise ValueError(f"method: '{self.method}' not implemented")

        if (self.method == "from_dataframe") and ("local_select" in self.kwargs):
            out = DataLoader.local_data_select(
                pd.DataFrame(out, columns=self.coords_col),
                reference_location=pd.DataFrame(self.expert_loc,
                                                columns=self.coords_col),
                local_select=self.kwargs["local_select"],
                verbose=False).values

        assert isinstance(out, np.ndarray), f"must return ndarray, got: {type(out)}"
        assert out.ndim == 2, f"must return 2d array, got {out.ndim}d"
        return out

    def _to_array(self, x):
        out, = to_array(x)
        return out

    def _shift_arrays(self, Xout=None, **kwargs):
        """Meshgrid of per-dimension offsets added to the expert location
        (reference: GPSat/prediction_locations.py:182)."""
        if Xout is None:
            xis = [self._to_array(kwargs.get(c, np.zeros(1))) for c in self.coords_col]
            for x in xis:
                assert x.ndim == 1
            Xis = np.meshgrid(*xis, indexing="ij")
            Xout = np.concatenate([X.flatten()[:, None] for X in Xis], axis=1)
            self.kwargs["Xout"] = Xout
        return Xout + self.expert_loc

    def _from_dataframe(self, df=None, df_file=None, max_dist=None,
                        copy_df=False, **kwargs):
        """Fixed-location grid culled to within max_dist of the expert
        (reference: GPSat/prediction_locations.py:208)."""
        if df is None:
            assert isinstance(df_file, str), \
                f"df is None; df_file must be a path, got: {type(df_file)}"
            df = pd.read_csv(df_file)
            found_cols = [c for c in self.coords_col if c in df.columns]
            df = df.loc[:, found_cols]
            self.kwargs["df"] = df.copy(True) if copy_df else df
        else:
            found_cols = [c for c in self.coords_col if c in df.columns]
            if df.shape[1] > len(found_cols):
                df = df.loc[:, found_cols]
                self.kwargs["df"] = df.copy(True) if copy_df else df

        fc_loc = [match([c], self.coords_col)[0] for c in found_cols]

        if max_dist is not None:
            if self.expert_loc.dtype != df.values.dtype:
                self.expert_loc = self.expert_loc.astype(df.values.dtype)
            b = max_dist_bool(df.values, self.expert_loc[0, fc_loc], max_dist)
        else:
            b = slice(None)

        if len(found_cols) == len(self.coords_col):
            out = df.loc[b, :].values
        else:
            nrow_out = len(df) if isinstance(b, slice) else int(b.sum())
            out = np.full((nrow_out, len(self.coords_col)), np.nan)
            out[:, fc_loc] = df.loc[b, :].values
            missing_cols = [cc for cc in self.coords_col if cc not in found_cols]
            missing_loc = match(missing_cols, self.coords_col)
            out[:, missing_loc] = self.expert_loc[:, missing_loc]
        return out
