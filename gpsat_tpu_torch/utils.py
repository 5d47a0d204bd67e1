"""Cross-cutting utilities (copy of gpsat_tpu/utils.py).

Coordinate projections (an in-house ellipsoidal Lambert azimuthal equal-area
implementation and polar stereographic, since pyproj is not a dependency),
config-expression evaluation (a registry,
operators and module paths first, `eval` only when enabled; a dotted path
into `gpsat_tpu.` resolves to the same path under `gpsat_tpu_torch.`, so
config files written for the JAX package run here without importing it),
config identity in the results store, Gaussian-weighted prediction merging,
array and DataFrame helpers, and run provenance. The numpy
softplus/sigmoid helpers of gpsat_tpu/utils.py are not copied: the port's
parameter transforms are the torch bijectors of ops/transforms.py.

pandas is imported inside the functions that build or read DataFrames, never
when this module is imported: the card's machine has no pandas, and the
device half of the pipeline (`local_experts.execute_buckets`) must run there.
"""

import json
import os
import re
import subprocess
import sys
import warnings
from datetime import date, datetime

import numpy as np

__all__ = ["cprint", "pretty_print_class", "to_array", "match",
           "WGS84toEASE2", "EASE2toWGS84", "WGS84toEASE2_New",
           "EASE2toWGS84_New", "WGS84toPolarStereo", "PolarStereoToWGS84",
           "grid_2d_flatten", "stats_on_vals", "rmse", "nll",
           "register_config_func", "config_func",
           "json_serializable", "nested_dict_literal_eval",
           "get_config_from_sysargv", "get_previous_oi_config",
           "check_prev_oi_config", "pandas_to_dict", "array_to_dataframe",
           "dataframe_to_array", "dict_of_array_to_dict_of_dataframe",
           "dataframe_to_2d_array", "get_weighted_values",
           "get_git_information", "get_run_info", "expand_dict_by_vals",
           "sparse_true_array", "datetime_to_day_float", "guess_track_num",
           "compare_dataframes", "log_lines", "pip_freeze_to_dataframe",
           "move_to_archive"]


def _loaded_pandas():
    """The pandas module if some caller has imported it, else None: an object
    can only be a DataFrame or Series once pandas is loaded."""
    return sys.modules.get("pandas")


# ---------------------------------------------------------------------------
# printing helpers
# ---------------------------------------------------------------------------

_BCOLORS = dict(
    HEADER="\033[95m",
    OKBLUE="\033[94m",
    OKCYAN="\033[96m",
    OKGREEN="\033[92m",
    WARNING="\033[93m",
    FAIL="\033[91m",
    ENDC="\033[0m",
    BOLD="\033[1m",
    UNDERLINE="\033[4m",
)


def cprint(x, c="ENDC", bcolors=None, sep=" ", end="\n"):
    """Coloured print (reference: GPSat/utils.py:2402)."""
    colors = _BCOLORS if bcolors is None else bcolors
    try:
        print(f"{colors[c]}{x}{colors['ENDC']}", sep=sep, end=end)
    except Exception:
        print(x)


def pretty_print_class(cls):
    """'<class 'x.y.Z'>' -> 'x.y.Z' (reference: GPSat/utils.py)."""
    return re.sub("'>$", "", re.sub("^<class '", "", str(cls)))


# ---------------------------------------------------------------------------
# array helpers
# ---------------------------------------------------------------------------

def to_array(*args, date_format="%Y-%m-%d"):
    """Generator converting each argument to a np.ndarray
    (reference: GPSat/utils.py:666)."""
    pd = _loaded_pandas()
    for x in args:
        if isinstance(x, np.ndarray):
            yield x
        elif isinstance(x, (int, np.integer)):
            yield np.array([x], dtype=np.int64 if not isinstance(x, np.integer) else None)
        elif isinstance(x, (float, np.floating)):
            yield np.array([x], dtype=np.float64 if not isinstance(x, np.floating) else None)
        elif isinstance(x, (list, tuple)):
            yield np.array(x)
        elif pd is not None and isinstance(x, (pd.Series, pd.Index)):
            yield x.values
        elif isinstance(x, datetime):
            yield np.array([x.strftime("%Y-%m-%d %H:%M:%S")], dtype="datetime64[s]")
        elif isinstance(x, date):
            yield np.array([x.strftime(date_format)], dtype="datetime64[D]")
        elif isinstance(x, np.datetime64):
            yield np.array([x])
        elif isinstance(x, bool):
            yield np.array([x], dtype=bool)
        elif x is None:
            yield np.array([])
        else:
            warnings.warn(f"to_array: no explicit handling of type: {type(x)}, using np.array")
            yield np.array([x])


def match(x, y, exact=True, tol=1e-9):
    """For each element of x return the index of the first match in y
    (reference: GPSat/utils.py:742)."""
    x_, y_ = list(to_array(x, y))
    if not exact:
        mask = np.abs(x_[:, None] - y_[None, :]) <= tol
    else:
        mask = x_[:, None] == y_[None, :]
    assert mask.any(axis=1).all(), f"match: some values not found: {x_[~mask.any(axis=1)]}"
    return np.argmax(mask, axis=1)


# ---------------------------------------------------------------------------
# EASE2 <-> WGS84: ellipsoidal Lambert azimuthal equal-area projection
# (in-house implementation of the +proj=laea +ellps=WGS84 transform used by the
#  reference through pyproj; reference: GPSat/utils.py:565,617)
# ---------------------------------------------------------------------------

_WGS84_A = 6378137.0
_WGS84_F = 1.0 / 298.257223563
_WGS84_E2 = _WGS84_F * (2.0 - _WGS84_F)
_WGS84_E = np.sqrt(_WGS84_E2)


def _laea_q(sin_phi):
    """Snyder eq. 3-12: the authalic-latitude 'q' function."""
    e, e2 = _WGS84_E, _WGS84_E2
    es = e * sin_phi
    return (1.0 - e2) * (sin_phi / (1.0 - e2 * sin_phi**2)
                         - (1.0 / (2.0 * e)) * np.log((1.0 - es) / (1.0 + es)))


_LAEA_QP = float(_laea_q(1.0))


def _phi_from_q(q, iters=8):
    """Invert q(phi) by Newton-style iteration (Snyder eq. 3-16)."""
    e, e2 = _WGS84_E, _WGS84_E2
    q = np.asarray(q, dtype=float)
    # seed with authalic sphere latitude
    ratio = np.clip(q / _LAEA_QP, -1.0, 1.0)
    phi = np.arcsin(ratio)
    at_pole = np.abs(np.abs(ratio) - 1.0) < 1e-14
    for _ in range(iters):
        sin_phi = np.sin(phi)
        cos_phi = np.cos(phi)
        es = e * sin_phi
        one_m = 1.0 - e2 * sin_phi**2
        with np.errstate(divide="ignore", invalid="ignore"):
            delta = (one_m**2 / (2.0 * np.where(np.abs(cos_phi) < 1e-15, 1e-15, cos_phi))) * (
                q / (1.0 - e2)
                - sin_phi / one_m
                + (1.0 / (2.0 * e)) * np.log((1.0 - es) / (1.0 + es))
            )
        phi = np.where(at_pole, phi, phi + delta)
    return np.where(at_pole, np.sign(q) * np.pi / 2.0, phi)


def WGS84toEASE2(lon, lat, return_vals="both", lon_0=0, lat_0=90):
    """WGS84 lon/lat (deg) -> LAEA (EASE2-style) x/y in metres.

    Matches pyproj's '+proj=laea +lon_0=.. +lat_0=.. +ellps=WGS84' transform
    (reference: GPSat/utils.py:565). Polar and oblique aspects supported.
    """
    valid = ["both", "x", "y"]
    assert return_vals in valid, f"return_vals: {return_vals} not in {valid}"
    lon_arr = np.asarray(lon, dtype=float)
    lat_arr = np.asarray(lat, dtype=float)
    lam = np.radians(lon_arr - lon_0)
    # wrap to [-pi, pi]
    lam = np.arctan2(np.sin(lam), np.cos(lam))
    phi = np.radians(lat_arr)
    a, qp = _WGS84_A, _LAEA_QP
    q = _laea_q(np.sin(phi))

    if lat_0 >= 89.999999:   # north polar aspect (Snyder 24-23/21-30/21-31)
        rho = a * np.sqrt(np.maximum(qp - q, 0.0))
        x = rho * np.sin(lam)
        y = -rho * np.cos(lam)
    elif lat_0 <= -89.999999:  # south polar aspect
        rho = a * np.sqrt(np.maximum(qp + q, 0.0))
        x = rho * np.sin(lam)
        y = rho * np.cos(lam)
    else:  # oblique / equatorial aspect (Snyder 24-17..24-19)
        phi1 = np.radians(lat_0)
        q1 = _laea_q(np.sin(phi1))
        beta = np.arcsin(np.clip(q / qp, -1.0, 1.0))
        beta1 = np.arcsin(np.clip(q1 / qp, -1.0, 1.0))
        Rq = a * np.sqrt(qp / 2.0)
        m1 = np.cos(phi1) / np.sqrt(1.0 - _WGS84_E2 * np.sin(phi1) ** 2)
        D = a * m1 / (Rq * np.cos(beta1))
        denom = 1.0 + np.sin(beta1) * np.sin(beta) + np.cos(beta1) * np.cos(beta) * np.cos(lam)
        B = Rq * np.sqrt(2.0 / np.maximum(denom, 1e-300))
        x = B * D * np.cos(beta) * np.sin(lam)
        y = (B / D) * (np.cos(beta1) * np.sin(beta) - np.sin(beta1) * np.cos(beta) * np.cos(lam))

    if np.ndim(lon) == 0 and np.ndim(lat) == 0:
        x, y = float(x), float(y)
    if return_vals == "both":
        return x, y
    return x if return_vals == "x" else y


def EASE2toWGS84(x, y, return_vals="both", lon_0=0, lat_0=90):
    """LAEA (EASE2-style) x/y in metres -> WGS84 lon/lat (deg).

    Inverse of :func:`WGS84toEASE2` (reference: GPSat/utils.py:617).
    """
    valid = ["both", "lon", "lat"]
    assert return_vals in valid, f"return_vals: {return_vals} not in {valid}"
    x_arr = np.asarray(x, dtype=float)
    y_arr = np.asarray(y, dtype=float)
    a, qp = _WGS84_A, _LAEA_QP
    rho = np.hypot(x_arr, y_arr)

    if lat_0 >= 89.999999:
        q = qp - (rho / a) ** 2
        lam = np.arctan2(x_arr, -y_arr)
        phi = _phi_from_q(q)
        phi = np.where(rho < 1e-12, np.pi / 2.0, phi)
    elif lat_0 <= -89.999999:
        q = (rho / a) ** 2 - qp
        lam = np.arctan2(x_arr, y_arr)
        phi = _phi_from_q(q)
        phi = np.where(rho < 1e-12, -np.pi / 2.0, phi)
    else:
        phi1 = np.radians(lat_0)
        q1 = _laea_q(np.sin(phi1))
        beta1 = np.arcsin(np.clip(q1 / qp, -1.0, 1.0))
        Rq = a * np.sqrt(qp / 2.0)
        m1 = np.cos(phi1) / np.sqrt(1.0 - _WGS84_E2 * np.sin(phi1) ** 2)
        D = a * m1 / (Rq * np.cos(beta1))
        rho_ = np.hypot(x_arr / D, D * y_arr)
        ce = 2.0 * np.arcsin(np.clip(rho_ / (2.0 * Rq), -1.0, 1.0))
        with np.errstate(divide="ignore", invalid="ignore"):
            q = qp * (np.cos(ce) * np.sin(beta1)
                      + (D * y_arr * np.sin(ce) * np.cos(beta1)) / np.where(rho_ == 0, 1.0, rho_))
        lam = np.arctan2(x_arr * np.sin(ce),
                         D * rho_ * np.cos(beta1) * np.cos(ce)
                         - D**2 * y_arr * np.sin(beta1) * np.sin(ce))
        phi = _phi_from_q(q)
        phi = np.where(rho_ < 1e-12, phi1, phi)

    lon_out = np.degrees(lam) + lon_0
    lon_out = (lon_out + 180.0) % 360.0 - 180.0
    lat_out = np.degrees(phi)
    if np.ndim(x) == 0 and np.ndim(y) == 0:
        lon_out, lat_out = float(lon_out), float(lat_out)
    if return_vals == "both":
        return lon_out, lat_out
    return lon_out if return_vals == "lon" else lat_out


# deprecated aliases kept for config compatibility
def WGS84toEASE2_New(*args, **kwargs):
    return WGS84toEASE2(*args, **kwargs)


def EASE2toWGS84_New(*args, **kwargs):
    return EASE2toWGS84(*args, **kwargs)


# The functions of this section read the eccentricity at call time: the
# rounded value below, with _LAEA_QP from f(2 - f) above, as
# gpsat_tpu/utils.py has them. The difference (5e-17 relative) reaches 3e-11
# in x, y near the pole, where qp - q cancels.
_WGS84_E2 = 0.00669437999014132
_WGS84_E = np.sqrt(_WGS84_E2)


def WGS84toPolarStereo(lon, lat, lon_0=0.0, lat_0=90.0, lat_ts=None):
    """WGS84 lon/lat (deg) -> polar stereographic x/y in metres.

    Ellipsoidal form (Snyder 1987, eqs. 15-9 / 21-33..34), matching
    '+proj=stere +lat_0=+-90 +lon_0=.. [+lat_ts=..] +ellps=WGS84' — i.e.
    cartopy's NorthPolarStereo/SouthPolarStereo, the projection the
    reference plots in (reference: GPSat/plot_utils.py:181). lat_ts is the
    latitude of true scale (None => true scale at the pole, k0=1; EPSG:3413
    uses lat_0=90, lon_0=-45, lat_ts=70).
    """
    a, e = _WGS84_A, _WGS84_E
    south = lat_0 < 0
    lon_r = np.radians(np.asarray(lon, dtype=float))
    lat_r = np.radians(np.asarray(lat, dtype=float))
    if south:
        lon_r, lat_r = -lon_r, -lat_r
        lon_0 = -lon_0
    lam0 = np.radians(lon_0)

    def _t(phi):
        es = e * np.sin(phi)
        return (np.tan(np.pi / 4.0 - phi / 2.0)
                / ((1.0 - es) / (1.0 + es)) ** (e / 2.0))

    t = _t(lat_r)
    if lat_ts is None:
        rho = 2.0 * a * t / np.sqrt((1.0 + e) ** (1.0 + e)
                                    * (1.0 - e) ** (1.0 - e))
    else:
        phic = np.radians(abs(lat_ts))
        mc = np.cos(phic) / np.sqrt(1.0 - _WGS84_E2 * np.sin(phic) ** 2)
        rho = a * mc * t / _t(phic)
    x = rho * np.sin(lon_r - lam0)
    y = -rho * np.cos(lon_r - lam0)
    if south:
        x, y = -x, -y
    return x, y


def PolarStereoToWGS84(x, y, lon_0=0.0, lat_0=90.0, lat_ts=None):
    """Inverse of :func:`WGS84toPolarStereo` (iterative latitude solve,
    Snyder eq. 7-9)."""
    a, e = _WGS84_A, _WGS84_E
    south = lat_0 < 0
    x_arr = np.asarray(x, dtype=float)
    y_arr = np.asarray(y, dtype=float)
    if south:
        x_arr, y_arr = -x_arr, -y_arr
        lon_0 = -lon_0
    rho = np.hypot(x_arr, y_arr)
    if lat_ts is None:
        t = rho * np.sqrt((1.0 + e) ** (1.0 + e)
                          * (1.0 - e) ** (1.0 - e)) / (2.0 * a)
    else:
        phic = np.radians(abs(lat_ts))
        mc = np.cos(phic) / np.sqrt(1.0 - _WGS84_E2 * np.sin(phic) ** 2)
        es = e * np.sin(phic)
        tc = (np.tan(np.pi / 4.0 - phic / 2.0)
              / ((1.0 - es) / (1.0 + es)) ** (e / 2.0))
        t = rho * tc / (a * mc)
    phi = np.pi / 2.0 - 2.0 * np.arctan(t)
    for _ in range(8):
        es = e * np.sin(phi)
        phi = np.pi / 2.0 - 2.0 * np.arctan(
            t * ((1.0 - es) / (1.0 + es)) ** (e / 2.0))
    lam = np.radians(lon_0) + np.arctan2(x_arr, -y_arr)
    lon = np.degrees(lam)
    lat = np.degrees(phi)
    if south:
        lon, lat = -lon, -lat
    lon = (lon + 180.0) % 360.0 - 180.0
    return lon, lat


def grid_2d_flatten(x_range, y_range, grid_res=None, step_size=None,
                    num_step=None, center=True):
    """Flattened 2-d grid of (x, y) points (reference: GPSat/utils.py:1788).

    Note the reference's output column order is (y-varied, x-varied) from
    meshgrid over (y, x) — we reproduce its exact output: rows iterate x-major,
    columns are [x, y].
    """
    assert (grid_res is not None) or (step_size is not None) or (num_step is not None), \
        "must specify one of grid_res, step_size, num_step"
    if grid_res is not None:
        step_size = grid_res
    if step_size is not None:
        x_edges = np.arange(x_range[0], x_range[1] + step_size, step_size)
        y_edges = np.arange(y_range[0], y_range[1] + step_size, step_size)
    else:
        x_edges = np.linspace(x_range[0], x_range[1], int(num_step))
        y_edges = np.linspace(y_range[0], y_range[1], int(num_step))

    if center:
        x_pts = x_edges[:-1] + np.diff(x_edges) / 2
        y_pts = y_edges[:-1] + np.diff(y_edges) / 2
    else:
        x_pts, y_pts = x_edges, y_edges

    X, Y = np.meshgrid(x_pts, y_pts, indexing="xy")
    return np.concatenate([X.flatten()[:, None], Y.flatten()[:, None]], axis=1)


def sparse_true_array(shape, grid_space=1, grid_space_offset=0):
    """Bool array True on a regularly-spaced sub-grid
    (reference: GPSat/utils.py:1075)."""
    out = np.zeros(shape, dtype=bool)
    slices = tuple(slice(grid_space_offset, None, grid_space) for _ in shape)
    out[slices] = True
    return out


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------

def stats_on_vals(vals, measure=None, name=None, qs=None):
    """One-column summary-statistics DataFrame (reference: GPSat/utils.py:496)."""
    import pandas as pd
    out = {
        "measure": measure,
        "size": vals.size,
        "num_not_nan": (~np.isnan(vals)).sum(),
        "num_inf": np.isinf(vals).sum(),
        "min": np.nanmin(vals),
        "mean": np.nanmean(vals),
        "max": np.nanmax(vals),
        "std": np.nanstd(vals),
        "skew": float(pd.Series(vals[~np.isnan(vals)]).skew()),
        "kurtosis": float(pd.Series(vals[~np.isnan(vals)]).kurtosis()),
    }
    if qs is None:
        qs = [0.05] + np.arange(0.1, 1.0, 0.1).round(1).tolist() + [0.95]
    quantiles = {f"q{q:.2f}": np.nanquantile(vals, q) for q in qs}
    out = {**out, **quantiles}
    columns = None if name is None else [name]
    return pd.DataFrame.from_dict(out, orient="index", columns=columns)


def rmse(y, mu):
    """Root-mean-square error (reference: GPSat/utils.py:2452)."""
    return np.sqrt(np.mean((y - mu) ** 2))


def nll(y, mu, sig, return_tot=True):
    """Independent-normal negative log likelihood (reference: GPSat/utils.py:2456)."""
    out = np.log(sig * np.sqrt(2 * np.pi)) + (y - mu) ** 2 / (2 * sig**2)
    if return_tot:
        return np.sum(out[~np.isnan(out)])
    return out


# ---------------------------------------------------------------------------
# config-driven function evaluation (reference: GPSat/utils.py:311)
# ---------------------------------------------------------------------------

#: functions registered for use from JSON configs by plain name
CONFIG_FUNC_REGISTRY = {}


def register_config_func(name, fn=None):
    """Register a named function usable from JSON configs via config_func."""
    if fn is None:
        def deco(f):
            CONFIG_FUNC_REGISTRY[name] = f
            return f
        return deco
    CONFIG_FUNC_REGISTRY[name] = fn
    return fn


_OPERATOR_RE = re.compile(r"[\|&\=\+\-\*/\%<>]")

_OPERATOR_FUNCS = {
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    ">=": lambda a, b: a >= b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    "<": lambda a, b: a < b,
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "%": lambda a, b: a % b,
    "|": lambda a, b: a | b,
    "&": lambda a, b: a & b,
    "=": lambda a, b: a == b,
}


def _eval_allowed():
    return os.environ.get("GPSAT_TPU_ALLOW_EVAL", "1") not in ("0", "false", "False")


def _port_module(path):
    """A dotted path into the JAX package ("gpsat_tpu" or "gpsat_tpu.x.y")
    as the same path in this package, since every gpsat_tpu module brings
    jax in with it."""
    head, dot, rest = path.partition(".")
    return f"gpsat_tpu_torch{dot}{rest}" if head == "gpsat_tpu" else path


def _resolve_func(func, source=None):
    """Resolve a config 'func' entry to a callable without blind eval."""
    if callable(func):
        return func
    assert isinstance(func, str), f"func must be str or callable, got {type(func)}"

    if func in CONFIG_FUNC_REGISTRY:
        return CONFIG_FUNC_REGISTRY[func]
    if func in _OPERATOR_FUNCS:
        return _OPERATOR_FUNCS[func]
    import importlib
    if source is not None:
        mod = importlib.import_module(_port_module(source))
        return getattr(mod, func)
    # dotted path, e.g. "np.sin", "numpy.cumprod", "pd.to_datetime",
    # "gpsat_tpu.utils.WGS84toEASE2" (resolved in gpsat_tpu_torch.utils):
    # the longest importable module prefix, then attributes
    if re.fullmatch(r"[A-Za-z_][\w\.]*", func) and "." in func:
        parts = _port_module(func).split(".")
        parts[0] = {"np": "numpy", "pd": "pandas"}.get(parts[0], parts[0])
        for cut in range(len(parts) - 1, 0, -1):
            try:
                obj = importlib.import_module(".".join(parts[:cut]))
            except ImportError:
                continue
            for p in parts[cut:]:
                obj = getattr(obj, p)
            return obj
    # lambda string or arbitrary expression: requires opt-in eval
    if re.search("^lambda", func):
        if _eval_allowed():
            return eval(func)  # noqa: S307 - explicit opt-in via GPSAT_TPU_ALLOW_EVAL
        raise ValueError(
            f"config func {func!r} is a lambda string but eval is disabled "
            f"(set GPSAT_TPU_ALLOW_EVAL=1 or name a module function)")
    if _OPERATOR_RE.search(func):
        # operator-ish expression such as ">=", fall back to binary-eval form
        if _eval_allowed():
            return lambda arg1, arg2: eval(f"arg1 {func} arg2")  # noqa: S307
        raise ValueError(f"operator func {func!r} not recognised and eval disabled")
    if _eval_allowed():
        try:
            return eval(func)  # noqa: S307
        except NameError:
            raise ValueError(f"could not resolve config func: {func!r}")
    raise ValueError(f"could not resolve config func: {func!r} (eval disabled)")


def get_col_values(df, col, return_numpy=True):
    """Column(s) from a DataFrame; index via special name 'index'
    (reference: GPSat/utils.py)."""
    if isinstance(col, (list, tuple)):
        out = df.loc[:, list(col)]
        return out.values if return_numpy else out
    out = df.index if col == "index" else df[col]
    return out.values if return_numpy else out


def config_func(func, source=None, args=None, kwargs=None, col_args=None,
                col_kwargs=None, df=None, filename_as_arg=False, filename=None,
                col_numpy=True):
    """Apply a (JSON-declarable) function, optionally on DataFrame columns.

    Semantics follow the reference (GPSat/utils.py:311): `args`/`kwargs` are
    literals, `col_args`/`col_kwargs` name DataFrame columns, and column args
    precede literal args. Strings are resolved as operators or module paths
    first; bare `eval` only runs when the GPSAT_TPU_ALLOW_EVAL
    environment variable permits it.
    """
    if args is None:
        args = []
    elif not isinstance(args, list):
        args = [args]
    if col_args is None:
        col_args = []
    elif not isinstance(col_args, list):
        col_args = [col_args]
    kwargs = {} if kwargs is None else kwargs
    col_kwargs = {} if col_kwargs is None else col_kwargs
    assert isinstance(kwargs, dict), "kwargs needs to be a dict"
    assert isinstance(col_kwargs, dict), "col_kwargs needs to be a dict"

    if df is None:
        assert len(col_args) == 0, f"df not provided, but col_args: {col_args} were"
        assert len(col_kwargs) == 0, f"df not provided, but col_kwargs: {col_kwargs} were"
    else:
        col_args = [get_col_values(df, c, return_numpy=col_numpy) for c in col_args]
        col_kwargs = {k: get_col_values(df, c, return_numpy=col_numpy)
                      for k, c in col_kwargs.items()}

    all_args = list(col_args) + list(args)
    if filename_as_arg:
        if filename is None:
            print("filename_as_arg is True but filename is None, won't add to args")
        else:
            all_args = [filename] + all_args
    all_kwargs = {**col_kwargs, **kwargs}

    fun = _resolve_func(func, source=source)
    out = fun(*all_args, **all_kwargs)
    pd = _loaded_pandas()
    if pd is not None and isinstance(out, pd.Series):
        out = out.values
    return out


# ---------------------------------------------------------------------------
# json / config helpers
# ---------------------------------------------------------------------------

def json_serializable(d, max_len_df=100):
    """Recursively convert a config-ish object into JSON-serialisable form
    (reference: GPSat/utils.py:1366)."""
    if isinstance(d, dict):
        return {str(k) if isinstance(k, tuple) else k: json_serializable(v, max_len_df)
                for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return [json_serializable(v, max_len_df) for v in d]
    if isinstance(d, np.ndarray):
        return json_serializable(d.tolist(), max_len_df)
    if isinstance(d, (np.integer,)):
        return int(d)
    if isinstance(d, (np.floating,)):
        return float(d)
    if isinstance(d, (np.bool_,)):
        return bool(d)
    pd = _loaded_pandas()
    if pd is not None and isinstance(d, pd.DataFrame):
        if len(d) > max_len_df:
            return f"<DataFrame with {len(d)} rows - not serialised>"
        return json_serializable(d.to_dict(orient="list"), max_len_df)
    if pd is not None and isinstance(d, pd.Series):
        return json_serializable(d.to_dict(), max_len_df)
    if isinstance(d, (datetime, date, np.datetime64)):
        return str(d)
    if callable(d) and not isinstance(d, (str, bytes)):
        return str(d)
    if isinstance(d, (str, int, float, bool)) or d is None:
        return d
    return str(d)


def nested_dict_literal_eval(d, verbose=False):
    """Convert "('a', 'b')"-style str keys back to tuple keys
    (reference: GPSat/utils.py:31)."""
    if isinstance(d, list):
        return [nested_dict_literal_eval(v, verbose) for v in d]
    if not isinstance(d, dict):
        return d
    out = {}
    for k, v in d.items():
        new_k = k
        if isinstance(k, str) and re.match(r"^\(.*\)$", k):
            try:
                import ast
                new_k = ast.literal_eval(k)
            except (ValueError, SyntaxError):
                if verbose:
                    print(f"could not literal_eval key: {k}")
        out[new_k] = nested_dict_literal_eval(v, verbose) if isinstance(v, dict) else (
            [nested_dict_literal_eval(i, verbose) for i in v] if isinstance(v, list) else v)
    return out


def get_config_from_sysargv(argv_num=1):
    """Read a JSON config path from sys.argv (reference: GPSat/utils.py:139)."""
    config = None
    try:
        path = sys.argv[argv_num]
        if path.endswith(".json"):
            with open(path, "r") as f:
                config = nested_dict_literal_eval(json.load(f))
        else:
            print(f"expected JSON config path as argument {argv_num}, got: {path}")
    except IndexError:
        print(f"no argument {argv_num} provided")
    return config


def _config_str(config):
    return json.dumps(json_serializable(config), sort_keys=True)


def get_previous_oi_config(store_path, oi_config, skip_valid_checks_on=None,
                           table_name="oi_config"):
    """Fetch (or create) the stored oi_config entry, assigning a config_id
    (reference behaviour: GPSat/utils.py:1136).

    Configs are stored as JSON strings in a results-store table; an exact
    string match re-uses the existing integer config_id, otherwise the config
    is appended with a new id.
    """
    import pandas as pd
    from gpsat_tpu_torch.store import ResultsStore

    if skip_valid_checks_on is None:
        skip_valid_checks_on = []

    cfg_str = _config_str(oi_config)
    with ResultsStore(store_path, mode="a") as store:
        if store.has_table(table_name):
            prev = store.select(table_name).reset_index(drop=True)
            matches = prev.index[prev["config"] == cfg_str].tolist()
            if len(matches):
                cid = int(prev.loc[matches[0], "idx"])
                prev_config = nested_dict_literal_eval(json.loads(prev.loc[matches[0], "config"]))
                return prev_config, skip_valid_checks_on, cid
            cid = int(prev["idx"].max()) + 1
            last_config = nested_dict_literal_eval(
                json.loads(prev.loc[prev.index[-1], "config"]))
        else:
            cid = 1
            last_config = oi_config
        new_row = pd.DataFrame({"config": [cfg_str],
                                "datetime": [str(datetime.now())],
                                "idx": [cid]})
        store.append(table_name, new_row, index_cols=[])
    return last_config, skip_valid_checks_on, cid


def check_prev_oi_config(prev_oi_config, oi_config, skip_valid_checks_on=None):
    """Assert the current config matches the previous one, up to skipped keys
    (reference: GPSat/utils.py:1276)."""
    if skip_valid_checks_on is None:
        skip_valid_checks_on = []
    if prev_oi_config is oi_config:
        return
    for k, v in oi_config.items():
        if k in skip_valid_checks_on:
            continue
        if k not in prev_oi_config:
            continue
        prev_v = prev_oi_config[k]
        assert _config_str(v) == _config_str(prev_v), (
            f"oi_config key '{k}' differs from previous run and is not in "
            f"skip_valid_checks_on; delete the store or skip this check.\n"
            f"current: {v}\nprevious: {prev_v}")


# ---------------------------------------------------------------------------
# DataFrame <-> dict-of-arrays helpers
# ---------------------------------------------------------------------------

def pandas_to_dict(x):
    """Series/1-row-DataFrame/dict -> dict (reference: GPSat/utils.py:1728)."""
    if isinstance(x, dict):
        return x
    pd = _loaded_pandas()
    if pd is not None and isinstance(x, pd.Series):
        return x.to_dict()
    if pd is not None and isinstance(x, pd.DataFrame):
        assert len(x) == 1, f"pandas_to_dict: DataFrame has {len(x)} rows, expected 1"
        return x.iloc[0, :].to_dict()
    warnings.warn(f"pandas_to_dict received type: {type(x)}, passing back as is")
    return x


def dataframe_to_array(df, val_col, idx_col=None, dropna=True, fill_val=np.nan):
    """Integer dim columns/index of a DataFrame -> ndarray
    (reference: GPSat/utils.py:1498)."""
    import pandas as pd
    if idx_col is None:
        if dropna:
            df = df[[val_col]].dropna()
        idx = df.index
        if isinstance(idx, pd.MultiIndex):
            idx_vals = np.array(idx.values.tolist())
            dims = {dn: idx_vals[:, i] for i, dn in enumerate(idx.names)}
        else:
            dims = {idx.names[0]: idx.values}
    else:
        if dropna:
            df = df.loc[~pd.isnull(df[val_col])]
        idx_col = idx_col if isinstance(idx_col, list) else [idx_col]
        dims = {ic: df[ic].values.astype(int) for ic in idx_col}
    shape = tuple(int(np.max(v)) + 1 for v in dims.values())
    out = np.full(shape, fill_val, dtype=df[val_col].dtype)
    out[tuple(dims.values())] = df[val_col].values
    return out


def array_to_dataframe(x, name, dim_prefix="_dim_", reset_index=False):
    """ndarray -> DataFrame with a '_dim_i' MultiIndex over array dimensions
    (reference: GPSat/utils.py:1437)."""
    import pandas as pd
    if isinstance(x, (int, float, bool, str, np.integer, np.floating, np.bool_)):
        x = np.array([x])
    assert isinstance(x, np.ndarray), f"array_to_dataframe expected ndarray, got: {type(x)}"
    if x.ndim == 0:
        x = x[None]
    dim_names = [f"{dim_prefix}{i}" for i in range(x.ndim)]
    midx = pd.MultiIndex.from_product([np.arange(n) for n in x.shape], names=dim_names)
    out = pd.DataFrame(np.asarray(x).reshape(-1), index=midx, columns=[name])
    if reset_index:
        out = out.reset_index()
    return out


def dict_of_array_to_dict_of_dataframe(array_dict, concat=False, reset_index=False):
    """{name: ndarray} -> {name_or_ndim: DataFrame}; when ``concat`` is True,
    arrays with the same ndim are outer-joined on their '_dim_*' index
    (reference: GPSat/utils.py:1619)."""
    import pandas as pd
    out = {}
    for k, v in array_dict.items():
        df = array_to_dataframe(v, k)
        if concat:
            num_dims = 1 if isinstance(v, (int, float, bool, str)) else max(np.ndim(v), 1)
            out.setdefault(num_dims, []).append(df)
        else:
            out[k] = df
    if concat:
        out = {k: pd.concat(v, join="outer", axis=1) for k, v in out.items()}
    if reset_index:
        out = {k: v.reset_index() for k, v in out.items()}
    return out


def dataframe_to_2d_array(df, x_col, y_col, val_col, tol=1e-9, fill_val=np.nan,
                          dtype=None, decimals=1):
    """Pivot (x, y, val) rows into a dense 2-d array + coordinate grids
    (reference: GPSat/utils.py:2218)."""
    x_vals = np.sort(df[x_col].round(decimals).unique())
    y_vals = np.sort(df[y_col].round(decimals).unique())
    x_grid, y_grid = np.meshgrid(x_vals, y_vals)
    ix = match(df[x_col].round(decimals).values, x_vals)
    iy = match(df[y_col].round(decimals).values, y_vals)
    val2d = np.full(x_grid.shape, fill_val, dtype=dtype)
    val2d[iy, ix] = df[val_col].values
    return val2d, x_grid, y_grid


# ---------------------------------------------------------------------------
# weighted prediction merge — the "gather" step
# ---------------------------------------------------------------------------

def get_weighted_values(df, ref_col, dist_to_col, val_cols,
                        weight_function="gaussian", drop_weight_cols=True,
                        **weight_kwargs):
    """Gaussian-distance-weighted merge of overlapping per-expert predictions
    (reference: GPSat/utils.py:2081).

    w = exp(-||ref - dist_to||^2 / (2 l^2)); output is sum(w*v)/sum(w) grouped
    by the reference (prediction) location.
    """
    import pandas as pd
    ref_col = [ref_col] if isinstance(ref_col, str) else list(ref_col)
    dist_to_col = [dist_to_col] if isinstance(dist_to_col, str) else list(dist_to_col)
    val_cols = [val_cols] if isinstance(val_cols, str) else list(val_cols)

    x0 = df[ref_col].values
    x = df[dist_to_col].values
    assert x0.shape == x.shape, \
        f"ref_col shape {x0.shape} != dist_to_col shape {x.shape}"

    if weight_function == "gaussian":
        lscale = weight_kwargs.get("lengthscale", None)
        assert lscale is not None, "lengthscale must be provided for gaussian weights"
        d2 = np.sum((x0 - x) ** 2, axis=1) / lscale**2
        w = np.exp(-d2 / 2)
    else:
        raise NotImplementedError(f"weight_function: {weight_function} is not implemented")

    out = []
    for vc in val_cols:
        tmp = df[ref_col].copy()
        tmp["_w"] = w
        tmp[f"w_{vc}"] = w * df[vc].values
        agg = tmp.groupby(ref_col)[["_w", f"w_{vc}"]].sum()
        agg[vc] = agg[f"w_{vc}"] / agg["_w"]
        if drop_weight_cols:
            agg = agg.drop(["_w", f"w_{vc}"], axis=1)
        out.append(agg)
    out = pd.concat(out, axis=1)
    return out.reset_index()


# ---------------------------------------------------------------------------
# run provenance and misc helpers
# ---------------------------------------------------------------------------

def get_git_information():
    """Current repo branch / commit / remote info (reference: GPSat/utils.py:969)."""
    out = {}
    try:
        out["branch"] = subprocess.check_output(
            ["git", "rev-parse", "--abbrev-ref", "HEAD"],
            stderr=subprocess.DEVNULL).decode().strip()
        out["commit"] = subprocess.check_output(
            ["git", "rev-parse", "HEAD"], stderr=subprocess.DEVNULL).decode().strip()
        remote = subprocess.check_output(
            ["git", "remote", "-v"], stderr=subprocess.DEVNULL).decode().strip()
        out["remote"] = remote.split("\n") if remote else []
    except Exception:
        pass
    return out


def get_run_info(script_path=None):
    """Run metadata: time, script, python version, git info
    (reference: GPSat/dataloader.py:1974)."""
    info = {
        "run_time": str(datetime.now()),
        "python_executable": sys.executable,
        "script_path": script_path,
    }
    info.update(get_git_information())
    return info


def expand_dict_by_vals(d, expand_keys=None):
    """Cartesian-expand list-valued keys of a dict into a list of dicts
    (reference: GPSat/utils.py:1933)."""
    import itertools
    if expand_keys is None:
        expand_keys = [k for k, v in d.items() if isinstance(v, list)]
    expand_keys = [k for k in expand_keys if k in d]
    fixed = {k: v for k, v in d.items() if k not in expand_keys}
    if not expand_keys:
        return [dict(d)]
    vals = [d[k] if isinstance(d[k], list) else [d[k]] for k in expand_keys]
    out = []
    for combo in itertools.product(*vals):
        new = dict(fixed)
        new.update(dict(zip(expand_keys, combo)))
        out.append(new)
    return out


def datetime_to_day_float(vals):
    """Datetime-ish values (datetime64, str, pandas col) -> float days
    (datetime64[D]-as-float, the reference's 't' coordinate convention:
    examples/inline_example.py:140)."""
    arr = np.asarray(vals)
    if arr.dtype.kind != "M":
        arr = np.asarray(arr, dtype="datetime64[s]")
    return arr.astype("datetime64[D]").astype(float)


def guess_track_num(x, thresh, start_track=0):
    """Infer satellite track numbers from jumps in a (time-like) column:
    increment the track counter whenever successive values jump by more than
    `thresh` (reference: GPSat/utils.py:2466, numba-jit there)."""
    x = np.asarray(x)
    if len(x) == 0:
        return np.array([])
    jumps = np.abs(np.diff(x)) > thresh
    track = np.concatenate([[0], np.cumsum(jumps)]) + start_track
    return track.astype(float)


def compare_dataframes(df1, df2, key_cols, val_cols=None, tol=1e-9):
    """Outer-join two DataFrames on key_cols and report per-column max abs
    differences (reference: GPSat/utils.py:2510; the integration-test
    comparison primitive)."""
    if val_cols is None:
        val_cols = [c for c in df1.columns if c not in key_cols
                    and np.issubdtype(df1[c].dtype, np.number)]
    merged = df1.merge(df2, on=list(key_cols), how="outer",
                       suffixes=("_1", "_2"), indicator=True)
    out = {"rows_df1": len(df1), "rows_df2": len(df2),
           "unmatched": int((merged["_merge"] != "both").sum())}
    for c in val_cols:
        a, b = merged.get(f"{c}_1"), merged.get(f"{c}_2")
        if a is None or b is None:
            out[c] = np.nan
            continue
        diff = np.abs(a.values.astype(float) - b.values.astype(float))
        out[c] = float(np.nanmax(diff)) if len(diff) else 0.0
    out["within_tol"] = all(
        (np.isnan(v) or v <= tol) for k, v in out.items()
        if k not in ("rows_df1", "rows_df2", "unmatched", "within_tol"))
    return out


def log_lines(*args, level="INFO"):
    """Lightweight multi-line logger (reference: GPSat/utils.py:1329)."""
    for a in args:
        print(f"[{level}] {a}")


def pip_freeze_to_dataframe():
    """Installed-package table for run provenance
    (reference: GPSat/utils.py:2589)."""
    import importlib.metadata as md
    import pandas as pd
    rows = [{"package": d.metadata["Name"], "version": d.version}
            for d in md.distributions()]
    return pd.DataFrame(rows).sort_values("package").reset_index(drop=True)


def move_to_archive(file, archive_dir=None, suffix=""):
    """Move a file into an Archive subdirectory, optionally suffixed
    (reference: GPSat/utils.py:178)."""
    import shutil
    if not os.path.exists(file):
        return None
    base_dir = os.path.dirname(file) or "."
    archive_dir = archive_dir or os.path.join(base_dir, "Archive")
    os.makedirs(archive_dir, exist_ok=True)
    name, ext = os.path.splitext(os.path.basename(file))
    dest = os.path.join(archive_dir, f"{name}{suffix}{ext}")
    shutil.move(file, dest)
    return dest
