"""Utilities of the pipeline (copy of the functions of gpsat_tpu/utils.py
that the port's host modules call).

Config-expression evaluation (operators and module paths first, `eval` only
when enabled), config identity in the results store, and small array and
DataFrame helpers. The projections, weighted merging and the rest of
gpsat_tpu/utils.py come with later slices of the port.

pandas is imported inside the functions that build or read DataFrames, never
when this module is imported: the card's machine has no pandas, and the
device half of the pipeline (`local_experts.execute_buckets`) must run there.
"""

import json
import os
import re
import sys
import warnings
from datetime import date, datetime

import numpy as np

__all__ = ["cprint", "pretty_print_class", "to_array", "match",
           "grid_2d_flatten", "config_func",
           "json_serializable", "nested_dict_literal_eval",
           "get_config_from_sysargv", "get_previous_oi_config",
           "check_prev_oi_config", "pandas_to_dict", "dataframe_to_array",
           "sparse_true_array"]


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
# config-driven function evaluation (reference: GPSat/utils.py:311)
# ---------------------------------------------------------------------------

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


def _resolve_func(func, source=None):
    """Resolve a config 'func' entry to a callable without blind eval."""
    if callable(func):
        return func
    assert isinstance(func, str), f"func must be str or callable, got {type(func)}"

    if func in _OPERATOR_FUNCS:
        return _OPERATOR_FUNCS[func]
    import importlib
    if source is not None:
        mod = importlib.import_module(source)
        return getattr(mod, func)
    # dotted path, e.g. "np.sin", "numpy.cumprod", "pd.to_datetime"
    if re.fullmatch(r"[A-Za-z_][\w\.]*", func) and "." in func:
        parts = func.split(".")
        module = {"np": "numpy", "pd": "pandas"}.get(parts[0], parts[0])
        try:
            head = importlib.import_module(module)
        except ImportError:
            head = None
        if head is not None:
            obj = head
            for p in parts[1:]:
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
