"""Post-processing: hyperparameter-field smoothing and prediction gluing
(copy of gpsat_tpu/postprocessing.py; reference: GPSat/postprocessing.py).

The reference smooths each hyperparameter field with an O(E^2) all-pairs
numba gufunc (postprocessing.py:22-52). Here the same Gaussian-weight smoother
runs in torch, in float64, on the card unless the caller passes another
device: E ~ 1e4 experts is a 1e8-pair elementwise problem and one
matrix-vector product per block of output rows. Rows are processed in
blocks so the [rows, E] temporaries stay bounded whatever E is.

Over a device mesh (parallel/mesh.Mesh) two smoothers split the output
rows: `gaussian_2d_smooth_sharded` gives each shard a block of rows against
every source, and `gaussian_2d_smooth_tiled` a strip of rows along x against
the sources within a halo of it. Each shard's blocks are issued on its own
device and stream before the first result is read back.

`smooth_field` is the numpy core of one field slice (clamp, smooth, clamp);
`smooth_hyperparameters` is the results-store wrapper around it, with the
JAX package's choice between the dense and the tiled smoother (`method`).
pandas is imported only inside the functions that build DataFrames, so the
core runs where pandas and h5py are absent.
"""

import argparse
import json
import re
from dataclasses import dataclass
from typing import Dict, List, Union

import numpy as np
import torch

from gpsat_tpu_torch import resolve_device
from gpsat_tpu_torch.utils import (cprint, json_serializable,
                                   nested_dict_literal_eval)

__all__ = ["SmoothingConfig", "smooth_field", "smooth_hyperparameters",
           "gaussian_2d_smooth", "gaussian_2d_smooth_masked",
           "gaussian_2d_smooth_sharded", "gaussian_2d_smooth_tiled",
           "glue_local_predictions_1d", "glue_local_predictions_2d"]

#: bytes of one [rows, E] float64 temporary of a smoothing block
BLOCK_BYTES = 1 << 28


def _smooth_block(x0, y0, x, y, l_x, l_y, v, ok):
    """out[i] = sum_j w_ij v_j / sum_j w_ij over the sources with ok_j,
    w_ij = exp(-(((x_j-x0_i)/l_x)^2 + ((y_j-y0_i)/l_y)^2)/2); NaN where no
    source has weight."""
    w = ((x[None, :] - x0[:, None]) / l_x).square_()
    w += ((y[None, :] - y0[:, None]) / l_y).square_()
    w.mul_(-0.5).exp_().mul_(ok[None, :])
    w_sum = w.sum(dim=1)
    empty = w_sum == 0
    out = (w @ v) / torch.where(empty, torch.ones_like(w_sum), w_sum)
    return torch.where(empty, torch.full_like(out, torch.nan), out)


def _smooth_launch(x0, y0, x, y, l_x, l_y, vals, dev):
    """Issue gaussian_2d_smooth's work on `dev` (and its current stream);
    returns the [E_out] float64 tensor there, not yet read back."""
    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)
    x0, y0, x, y, vals = (t(a) for a in (x0, y0, x, y, vals))
    ok = ~torch.isnan(vals)
    v = torch.where(ok, vals, torch.zeros_like(vals))
    ok = ok.to(torch.float64)
    E_out = len(x0)
    rows = max(1, BLOCK_BYTES // (8 * max(len(x), 1)))
    out = torch.empty(E_out, dtype=torch.float64, device=dev)
    for s in range(0, E_out, rows):
        e = min(s + rows, E_out)
        out[s:e] = _smooth_block(x0[s:e], y0[s:e], x, y, float(l_x),
                                 float(l_y), v, ok)
    return out


def gaussian_2d_smooth(x0, y0, x, y, l_x, l_y, vals, device=None):
    """Gaussian-kernel smooth of vals at source (x, y) evaluated at (x0, y0),
    in float64 on `device` (the card unless the caller passes another); NaN
    sources are skipped, and an output with no weighted source is NaN
    (reference: postprocessing.py:22). Output rows go in blocks whose
    [rows, E] temporary is BLOCK_BYTES. Returns a numpy array."""
    return _smooth_launch(x0, y0, x, y, l_x, l_y, vals,
                          resolve_device(device)).cpu().numpy()


def _masked_sources(sm, vals):
    """Padded sources (sm False) as NaN values, which the smoother skips."""
    return np.where(np.asarray(sm, dtype=bool), vals, np.nan)


def gaussian_2d_smooth_masked(x0, y0, m0, x, y, sm, l_x, l_y, vals,
                              device=None):
    """The tile-local smoother: padded outputs (m0 False -> NaN) against
    padded sources (sm False -> skipped), as gaussian_2d_smooth otherwise."""
    out = gaussian_2d_smooth(x0, y0, x, y, l_x, l_y, _masked_sources(sm, vals),
                             device=device)
    out[~np.asarray(m0, dtype=bool)] = np.nan
    return out


def _on_mesh(mesh, launches):
    """Issue launches[k]() under shard k's scope for every k, then read each
    result back under the same scope: numpy arrays in shard order."""
    pending = []
    for k, fn in enumerate(launches):
        with mesh.scope(k):
            pending.append(fn(mesh.devices[k]))
    out = []
    for k, t in enumerate(pending):
        with mesh.scope(k):
            out.append(t.cpu().numpy())
    return out


def gaussian_2d_smooth_sharded(x0, y0, x, y, l_x, l_y, vals, mesh=None):
    """Multi-device Gaussian smoother (gpsat_tpu/postprocessing.py:389-446):
    output rows padded to a mesh multiple and split into one contiguous
    block per shard, every source copied to each shard's device, each block
    through gaussian_2d_smooth's f64 blocks there. `mesh` defaults to every
    card (parallel/mesh.get_mesh); one shard is the dense smoother."""
    from gpsat_tpu_torch.parallel.mesh import get_mesh, pad_to_multiple
    mesh = get_mesh() if mesh is None else mesh
    n_dev = mesh.size
    if n_dev == 1:
        return gaussian_2d_smooth(x0, y0, x, y, l_x, l_y, vals,
                                  device=mesh.devices[0])
    E_out = len(x0)
    E_pad = pad_to_multiple(E_out, n_dev)

    def pad(a):
        a = np.asarray(a, dtype=np.float64)
        return np.concatenate([a, np.zeros(E_pad - len(a))])
    x0p, y0p = pad(x0), pad(y0)
    b = E_pad // n_dev

    def launch(k):
        blk = slice(k * b, (k + 1) * b)
        return lambda dev: _smooth_launch(x0p[blk], y0p[blk], x, y, l_x, l_y,
                                          vals, dev)
    out = _on_mesh(mesh, [launch(k) for k in range(n_dev)])
    return np.concatenate(out)[:E_out]


def gaussian_2d_smooth_tiled(x0, y0, x, y, l_x, l_y, vals, mesh=None,
                             halo_factor=6.0):
    """Halo tiled smoother (gpsat_tpu/postprocessing.py:71-158): each shard
    owns a strip of output experts along x (a stable argsort of x0 split
    into mesh.size strips) and the sources within `halo_factor * l_x` of
    its strip, assembled on the host and padded to the widest strip and
    halo; each strip runs gaussian_2d_smooth_masked's computation on its
    shard's device. Sources beyond the halo carry weight below
    exp(-halo_factor^2 / 2) (~1.5e-8 at 6 sigma). One shard, or fewer than
    two outputs a shard, gives the dense smoother. `mesh` defaults to every
    card."""
    from gpsat_tpu_torch.parallel.mesh import get_mesh
    mesh = get_mesh() if mesh is None else mesh
    n_dev = mesh.size
    x0, y0, x, y, vals = (np.asarray(a, dtype=np.float64)
                          for a in (x0, y0, x, y, vals))
    E_out = len(x0)
    if n_dev == 1 or E_out < 2 * n_dev:
        return gaussian_2d_smooth(x0, y0, x, y, l_x, l_y, vals,
                                  device=mesh.devices[0])

    # strips: quantile split of outputs along x (balanced counts)
    order = np.argsort(x0, kind="stable")
    strips = np.array_split(order, n_dev)
    R = float(halo_factor) * float(l_x)
    src_idx = []
    for s in strips:
        lo, hi = x0[s].min() - R, x0[s].max() + R
        src_idx.append(np.where((x >= lo) & (x <= hi))[0])
    S_max = max(max(len(si) for si in src_idx), 1)
    Eo_max = max(len(s) for s in strips)

    def padded(a, idx, width, fill=0.0):
        out = np.full(width, fill)
        out[:len(idx)] = a[idx]
        return out

    def launch(k):
        s, si = strips[k], src_idx[k]
        sm = np.arange(S_max) < len(si)
        return lambda dev: _smooth_launch(
            padded(x0, s, Eo_max), padded(y0, s, Eo_max),
            padded(x, si, S_max), padded(y, si, S_max), l_x, l_y,
            _masked_sources(sm, padded(vals, si, S_max, np.nan)), dev)
    tiles = _on_mesh(mesh, [launch(k) for k in range(n_dev)])
    out = np.full(E_out, np.nan)
    for s, tile in zip(strips, tiles):
        out[s] = tile[:len(s)]
    return out


@dataclass
class SmoothingConfig:
    """Per-hyperparameter smoothing settings (reference: postprocessing.py:55)."""
    l_x: Union[int, float] = 1
    l_y: Union[int, float] = 1
    max: Union[int, float, list, None] = None
    min: Union[int, float, list, None] = None

    def __getitem__(self, item):
        if hasattr(self, item):
            return getattr(self, item)
        raise AttributeError(f"{item} is not an attribute of SmoothingConfig")

    def get(self, key, default=None):
        return getattr(self, key, default)


_NON_PARAM_TABLES = ("preds", "run_details", "expert_locs", "oi_config")


def _resolve_component_limit(limit, row, dim_cols):
    """min/max may be a per-component list (e.g. per lengthscale dim)."""
    if isinstance(limit, (list, np.ndarray)) and len(limit) > 0:
        comp = int(row[dim_cols[-1]]) if dim_cols else 0
        return limit[min(comp, len(limit) - 1)]
    return limit


def smooth_field(x0, y0, vals, l_x, l_y, min=None, max=None, device=None,
                 mesh=None):
    """One field slice of smooth_hyperparameters, numpy in and out: clamp
    vals to [min, max], Gaussian-smooth them over the same (x0, y0) (with
    `mesh`, by the tiled smoother over it; else densely on `device`), and
    clamp the result again (reference: postprocessing.py:253-277)."""
    vals = np.asarray(vals, dtype=float).copy()
    if max is not None:
        vals[vals > max] = max
    if min is not None:
        vals[vals < min] = min
    if mesh is not None:
        smoothed = gaussian_2d_smooth_tiled(x0, y0, x0, y0, l_x, l_y, vals,
                                            mesh=mesh)
    else:
        smoothed = gaussian_2d_smooth(x0, y0, x0, y0, l_x, l_y, vals,
                                      device=device)
    if min is not None:
        smoothed = np.maximum(smoothed, min)
    if max is not None:
        smoothed = np.minimum(smoothed, max)
    return smoothed


def smooth_hyperparameters(result_file: str,
                           params_to_smooth: List[str],
                           smooth_config_dict: Dict[str, dict],
                           xy_dims: List[str] = ("x", "y"),
                           reference_table_suffix: str = "",
                           table_suffix: str = "_SMOOTHED",
                           output_file: str = None,
                           model_name: str = None,
                           save_config_file: bool = True,
                           method: str = "auto",
                           device=None, mesh=None):
    """Smooth hyperparameter fields and write `*{table_suffix}` tables
    (reference: postprocessing.py:96).

    Per parameter and per unique slice of the non-(x, y) dimensions the field
    goes through `smooth_field` on `device` (the card unless the caller
    passes another): clamped to [min, max] and Gaussian-smoothed with
    lengthscales (l_x, l_y). Unsmoothed parameter tables are copied under the
    new suffix. Optionally writes a follow-up prediction config
    (optimise=False, load_params pointing at the smoothed tables).

    `method` chooses the smoother as the JAX package does
    (gpsat_tpu/postprocessing.py:263-272): "tiled" the tiled smoother over
    `mesh`, "auto" the tiled one where the mesh has more than one device and
    the slice at least 4096 experts, anything else the dense one. `mesh`
    (parallel/mesh.Mesh) defaults to every card on a CUDA `device`, and to
    `device` alone otherwise.
    """
    import pandas as pd
    from gpsat_tpu_torch.local_experts import get_results_from_h5file
    from gpsat_tpu_torch.parallel.mesh import Mesh, get_mesh
    from gpsat_tpu_torch.store import ResultsStore

    if mesh is None and method in ("auto", "tiled"):
        dev = resolve_device(device)
        mesh = get_mesh() if dev.type == "cuda" else Mesh([dev])
    n_dev = 1 if mesh is None else mesh.size
    xy_dims = list(xy_dims)
    smooth_config_dict = {
        k: (v if isinstance(v, SmoothingConfig) else SmoothingConfig(**v))
        for k, v in smooth_config_dict.items()}

    suffixed = [f"{p}{reference_table_suffix}" for p in params_to_smooth]
    dfs, oi_configs = get_results_from_h5file(
        result_file, merge_on_expert_locations=False,
        select_tables=None, table_suffix=reference_table_suffix)
    assert oi_configs, f"no oi_config found in {result_file}"
    coords_col = oi_configs[-1]["data"]["coords_col"]

    # candidate parameter tables = stored tables that are not bookkeeping
    def _is_param_table(name):
        base = re.sub(f"{re.escape(reference_table_suffix)}$", "", name) \
            if reference_table_suffix else name
        return not any(base == t or base.startswith(t) for t in _NON_PARAM_TABLES)

    param_tables = [k for k in dfs if _is_param_table(k)]
    other_params = [k for k in param_tables if k not in suffixed]

    out = {}
    out_cfgs = {}
    for hp_with_suffix, hp in zip(suffixed, params_to_smooth):
        assert hp_with_suffix in dfs, \
            f"parameter {hp_with_suffix} not found in {list(dfs)}"
        cfg = smooth_config_dict.get(hp_with_suffix,
                                     smooth_config_dict.get(hp))
        assert cfg is not None, f"no smoothing config for {hp}"
        df = dfs[hp_with_suffix].copy(True)
        df_org_cols = df.columns.values.tolist()

        other_dims = [c for c in coords_col if c not in xy_dims]
        dim_cols = [c for c in df.columns if re.search(r"^_dim_\d", c)]
        other_dims = other_dims + dim_cols
        unique_odims = df[other_dims].drop_duplicates() if other_dims \
            else pd.DataFrame({"_all_": [0]})

        smooth_list = []
        for _, row in unique_odims.iterrows():
            if other_dims:
                row_df = row.to_frame().T.merge(df, on=other_dims, how="inner")
            else:
                row_df = df.copy()
            use_tiled = method == "tiled" or (
                method == "auto" and n_dev > 1 and len(row_df) >= 4096)
            row_df[hp] = smooth_field(
                row_df[xy_dims[0]].values.astype(float),
                row_df[xy_dims[1]].values.astype(float),
                row_df[hp].values.astype(float), cfg["l_x"], cfg["l_y"],
                min=_resolve_component_limit(cfg.get("min"), row, dim_cols),
                max=_resolve_component_limit(cfg.get("max"), row, dim_cols),
                device=device, mesh=mesh if use_tiled else None)

            tmp = row_df[[hp] + xy_dims].copy(True).dropna()
            for od in other_dims:
                tmp[od] = row[od]
            tmp = tmp[df_org_cols]
            smooth_list.append(tmp)

        smooth_df = pd.concat(smooth_list)
        smooth_df = smooth_df.set_index(coords_col)
        out_table = f"{hp_with_suffix}{table_suffix}"
        cprint(f"adding smoothed table: {out_table}", c="OKCYAN")
        out[out_table] = smooth_df
        out_cfgs[out_table] = {"l_x": cfg["l_x"], "l_y": cfg["l_y"],
                               "min": cfg.get("min"), "max": cfg.get("max")}

    for param in other_params:
        out_table = f"{param}{table_suffix}"
        cprint(f"copying table: {param} to {out_table}", c="OKCYAN")
        cp = dfs[param].copy(True)
        out[out_table] = cp.set_index(coords_col)
        out_cfgs[out_table] = {"comment": f"no smoothing, copied from {param}"}

    output_file = result_file if output_file is None else output_file
    with ResultsStore(output_file, mode="a") as store:
        for k, v in out.items():
            store.put(k, v, attrs={"smooth_config": out_cfgs.get(k, {})})

    if save_config_file:
        out_config = re.sub(r"\.h5$",
                            f"{reference_table_suffix}{table_suffix}.json",
                            result_file)
        tmp = []
        for oic in oi_configs:
            oic = dict(oic)
            run_kwargs = dict(oic.get("run_kwargs", {}))
            run_kwargs["optimise"] = False
            run_kwargs["table_suffix"] = f"{reference_table_suffix}{table_suffix}"
            run_kwargs["store_path"] = output_file
            model = dict(oic.get("model", {}))
            model["load_params"] = {
                "file": output_file,
                "table_suffix": f"{reference_table_suffix}{table_suffix}"}
            oic["run_kwargs"] = run_kwargs
            oic["model"] = model
            tmp.append(json_serializable(oic))
        cprint(f"writing follow-up prediction config to: {out_config}", "OKBLUE")
        with open(out_config, "w") as f:
            json.dump(tmp, f, indent=4)
        return out_config


# ---------------------------------------------------------------------------
# prediction gluing (reference: postprocessing.py:462,533)
# ---------------------------------------------------------------------------

def _glue(preds_df, expert_locs_df, sigma, dims, R=3):
    from scipy.stats import norm
    preds = preds_df.copy(True)
    if isinstance(sigma, (int, float)):
        sigma = [sigma] * len(dims)
    if "f*_std" not in preds:
        loc = preds.columns.get_loc("f*_var") + 1
        preds.insert(loc, "f*_std", np.sqrt(preds["f*_var"]))
    total_w = np.ones(len(preds))
    for i, dcol in enumerate(dims):
        h = np.diff(np.sort(expert_locs_df[dcol].unique())).min()
        total_w = total_w * norm.pdf(preds[f"pred_loc_{dcol}"], preds[dcol],
                                     h / sigma[i])
    preds["total_weights"] = total_w
    keys = [f"pred_loc_{d}" for d in dims]
    preds["f*"] = preds["f*"] * total_w
    preds["f*_std"] = preds["f*_std"] * total_w
    glued = preds[keys + ["total_weights", "f*", "f*_std"]] \
        .groupby(keys).sum().reset_index()
    glued["f*"] = glued["f*"] / glued["total_weights"]
    glued["f*_std"] = glued["f*_std"] / glued["total_weights"]
    return glued.drop("total_weights", axis=1)


def glue_local_predictions_1d(preds_df, expert_locs_df, R=3):
    """Gaussian-weight blend of overlapping 1-d expert predictions
    (reference: postprocessing.py:462)."""
    return _glue(preds_df, expert_locs_df, sigma=R, dims=["x"])


def glue_local_predictions_2d(preds_df, expert_locs_df, R=3):
    """Gaussian-weight blend of overlapping 2-d expert predictions
    (reference: postprocessing.py:533)."""
    return _glue(preds_df, expert_locs_df, sigma=R, dims=["x", "y"])


# ---------------------------------------------------------------------------
# CLI (reference: postprocessing.py:616)
# ---------------------------------------------------------------------------

def main(argv=None):
    """python -m gpsat_tpu_torch.postprocessing <config.json> [--device D]:
    smooth_hyperparameters(**config) on the card, or on D."""
    parser = argparse.ArgumentParser(
        prog="python -m gpsat_tpu_torch.postprocessing",
        description="smooth the hyperparameter fields of a results store")
    parser.add_argument("config", help="JSON of smooth_hyperparameters' "
                                       "keyword arguments")
    parser.add_argument("--device", default=None,
                        help="torch device of the smoother (default: cuda)")
    args = parser.parse_args(argv)
    with open(args.config) as f:
        config = nested_dict_literal_eval(json.load(f))
    return smooth_hyperparameters(**config, device=args.device)


if __name__ == "__main__":
    main()
