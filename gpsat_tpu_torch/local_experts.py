"""LocalExpertOI — the experiment engine of the port (torch port of
gpsat_tpu/local_experts.py; reference: GPSat/local_experts.py:116,761).

A sweep runs in four phases:

1. host gather    — group experts by global-data `where`, load each group's
                    data once, KD-select per-expert local data + prediction
                    locations (`LocalExpertOI._gather_*`, pandas);
2. bucketise      — group experts into padded (N_obs, N_pred) levels
                    (gpsat_tpu_torch.parallel.scheduler.make_buckets);
3. device execute — per level, one `fit_predict_many` of the batched engine
                    (gpsat_tpu_torch.models.batched) on the card;
4. store          — append preds / run_details / per-parameter tables with the
                    reference's HDF5 schema (multi-index on expert coords,
                    `table_suffix` namespacing, config identity, resume).

Phases 2-3 are `execute_buckets`, a module-level function on numpy arrays:
`LocalExpertOI.run` calls it, and a machine without pandas or h5py (the
card's) can call it directly. This module imports neither package when it is
imported; the methods that build DataFrames or open a store import them.

Semantics preserved from the JAX package: min_obs skipping (recorded for
restart), zero-pred-loc records, config-id provenance, anti-join resume,
load_params re-prediction, constraint handling incl. coords_scale'd
lengthscale bounds, and the device mesh: with more than one card, `run`
splits each level's experts over every card (parallel/mesh), as the JAX
package shards them over its devices.
"""

import json
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Union

import numpy as np
import torch

from gpsat_tpu_torch import resolve_device
from gpsat_tpu_torch.parallel.mesh import get_mesh
from gpsat_tpu_torch.parallel.scheduler import make_buckets

__all__ = ["LocalExpertOI", "LocalExpertData", "get_results_from_h5file",
           "make_engine", "assemble_bucket", "execute_buckets"]

PRED_KEYS = ("f*", "f*_var", "y_var")


@dataclass
class LocalExpertData:
    """Observation source + selection spec (reference: GPSat/local_experts.py:43)."""
    obs_col: Union[str, None] = None
    coords_col: Union[list, None] = None
    global_select: Union[list, None] = None
    local_select: Union[list, None] = None
    where: Union[list, None] = None
    row_select: Union[list, None] = None
    col_select: Union[list, None] = None
    col_funcs: Union[dict, None] = None
    table: Union[str, None] = None
    data_source: object = None
    engine: Union[str, None] = None
    read_kwargs: Union[dict, None] = None

    def set_data_source(self, verbose=False):
        from gpsat_tpu_torch.dataloader import DataLoader
        kwargs = self.read_kwargs or {}
        if isinstance(self.data_source, str):
            self.data_source = DataLoader._get_source_from_str(
                self.data_source, _engine=self.engine, **kwargs)

    def load(self, where=None, verbose=False, **kwargs):
        from gpsat_tpu_torch.dataloader import DataLoader
        if isinstance(self.data_source, str):
            self.set_data_source(verbose=verbose)
        use_where = list(self.where) if self.where is not None else None
        if where is not None:
            where = where if isinstance(where, list) else [where]
            use_where = where if use_where is None else use_where + where
        return DataLoader.load(source=self.data_source, where=use_where,
                               table=self.table, col_funcs=self.col_funcs,
                               row_select=self.row_select,
                               col_select=self.col_select, engine=self.engine,
                               source_kwargs=self.read_kwargs, verbose=verbose,
                               **kwargs)


def _device_count(device):
    """Devices a run on `device` can split its experts over: every card for
    a CUDA device, one otherwise."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def _device_name(device):
    """'cuda:<card name>' on a CUDA device, 'cpu:cpu' on the host (the JAX
    package's 'platform:device_kind')."""
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return f"{device.type}:{device.type}"


# ---------------------------------------------------------------------------
# the device half of a sweep: engine, bucket assembly, bucket execution
# ---------------------------------------------------------------------------

def make_engine(model, init_params=None, constraints=None, coords_dim=3,
                optim_kwargs=None, device=None):
    """The batched engine of a model class, configured as `run` configures
    it (gpsat_tpu/local_experts.py:364-378, :564-588): BatchedGPR for
    GPRModel, BatchedSGPR for SGPRModel, BatchedSVGP for SVGPModel,
    BatchedVFF for VFFModel and BatchedASVGP for ASVGPModel (other classes by
    their name, ASVGP before SVGP, SGPR and VFF, BatchedGPR last);
    `coords_scale` marking the lengthscale bounds as scaled, and the rest of
    `init_params` (kernel, num_inducing_points, SGPR's route, ...) passed to
    the engine. The engine runs on `device` ("cuda" unless the caller passes
    another)."""
    from gpsat_tpu_torch.models.asvgp import ASVGPModel
    from gpsat_tpu_torch.models.batched import (BatchedASVGP, BatchedGPR,
                                                BatchedSGPR, BatchedSVGP,
                                                BatchedVFF)
    from gpsat_tpu_torch.models.exact_gpr import GPRModel
    from gpsat_tpu_torch.models.sgpr import SGPRModel
    from gpsat_tpu_torch.models.svgp import SVGPModel
    from gpsat_tpu_torch.models.vff import VFFModel

    init_params = dict(init_params or {})
    if isinstance(constraints, dict):
        constraints = {k: dict(v) for k, v in constraints.items()}
        # coords_scale implies scaled lengthscale bounds
        # (reference: GPSat/local_experts.py:1110-1115)
        if init_params.get("coords_scale") is not None and \
                "lengthscales" in constraints:
            constraints["lengthscales"]["scale"] = True
    else:
        constraints = None

    engines = {GPRModel: BatchedGPR, SGPRModel: BatchedSGPR,
               SVGPModel: BatchedSVGP, VFFModel: BatchedVFF,
               ASVGPModel: BatchedASVGP}
    engine_cls = engines.get(model)
    if engine_cls is None:
        # fall back by name for custom subclasses
        name = getattr(model, "__name__", "")
        engine_cls = (BatchedASVGP if "ASVGP" in name else
                      BatchedSVGP if "SVGP" in name else
                      BatchedSGPR if "SGPR" in name else
                      BatchedVFF if "VFF" in name else BatchedGPR)
    ip = {k: v for k, v in init_params.items()
          if k not in ("coords_scale", "obs_scale", "obs_mean")}
    return engine_cls(coords_dim=coords_dim, constraints=constraints,
                      coords_scale=init_params.get("coords_scale"),
                      optim_kwargs=optim_kwargs, device=device, **ip)


def assemble_bucket(bk, X_list, obs_list, pred_list, coords_scale, obs_scale,
                    obs_mean=None, overrides=None, predict=True,
                    expert_locs=None):
    """Padded host arrays of one bucket of `make_buckets` (the JAX package's
    `_assemble`, gpsat_tpu/local_experts.py:469-505).

    Inputs are per-expert, in raw units: X_list[i] [n_i, d] coordinates,
    obs_list[i] [n_i] observations, pred_list[i] [p_i, d] prediction
    coordinates or None; coords_scale [1, d] and obs_scale [1, 1];
    expert_locs [E, d] the experts' locations or None. Returns (X [B, N, d],
    y [B, N], mask [B, N], Xs [B, P, d] or None, f_bar [B], overrides
    [B, ...] or None, expert locations [B, d] in scaled units (zero on
    padded rows) or None).
    """
    ids = bk["indices"]
    B, Nmax, Pmax = bk["batch_pad"], bk["n_max"], bk["p_max"]
    d = np.shape(X_list[ids[0]])[1]

    X = np.zeros((B, Nmax, d))
    y = np.zeros((B, Nmax))
    mask = np.zeros((B, Nmax), dtype=bool)
    Xs = np.zeros((B, max(Pmax, 1), d)) if predict else None
    f_bar = np.zeros(B)

    for bi, ei in enumerate(ids):
        obs = np.asarray(obs_list[ei], dtype=float)
        n = len(obs)
        X[bi, :n] = X_list[ei] / coords_scale
        if obs_mean == "local":
            f_bar[bi] = obs.mean()
        elif obs_mean is not None:
            f_bar[bi] = float(np.asarray(obs_mean).reshape(-1)[0])
        y[bi, :n] = (obs - f_bar[bi]) / obs_scale[0, 0]
        mask[bi, :n] = True
        if predict and pred_list[ei] is not None:
            pc = pred_list[ei]
            Xs[bi, :len(pc)] = pc / coords_scale

    ov = None
    if overrides is not None:
        ov = {k: v[ids] if len(ids) == B else
              np.concatenate([v[ids], np.full((B - len(ids),) + v.shape[1:],
                                              np.nan)], axis=0)
              for k, v in overrides.items()}
    el_scaled = None
    if expert_locs is not None:
        el_scaled = np.zeros((B, d))
        el_scaled[:len(ids)] = np.asarray(expert_locs, dtype=float)[ids] \
            / coords_scale
    return X, y, mask, Xs, f_bar, ov, el_scaled


def _put(out, ids, v):
    """out[ids] = v, v's trailing dims written into the leading corner of
    out's (an SGPR bucket's inducing points hold min(M, N) rows)."""
    v = np.asarray(v)
    out[(ids,) + tuple(slice(0, s) for s in v.shape[1:])] = v


def execute_buckets(engine, X_list, obs_list, pred_list, coords_scale=1.0,
                    obs_scale=1.0, obs_mean=None, overrides=None,
                    optimise=True, predict=True, batch_size=None,
                    on_bucket=None, verbose=False, expert_locs=None,
                    mesh=None):
    """Fit and predict E experts given as per-expert numpy arrays: group them
    into padded levels (`make_buckets`), assemble each level on the host
    (`assemble_bucket`, one level ahead in a thread while the engine runs the
    current one), and run `engine.fit_predict_many` on each level. This is
    the bucket loop of `LocalExpertOI.run` (gpsat_tpu/local_experts.py:
    457-552) with no pandas and no store.

    Inputs as `assemble_bucket`'s (lists of E entries, raw units); every
    expert is run (`run` leaves out the skipped ones). `overrides`: {param:
    [E, ...] array, NaN where absent}. `expert_locs` [E, d], the experts'
    locations in raw units: each level hands them, scaled, to the engine's
    `fit_predict_many` (BatchedVFF's box domains centre on them; without
    them it takes each expert's data centroid).
    `on_bucket(ids, result, f_bar, per_expert_time)`, if given, is called
    after each level with the engine's result for the experts `ids` (f_bar
    [B], seconds per expert). `mesh` (parallel/mesh.Mesh), if given, goes to
    every `fit_predict_many`, which splits the level's experts over its
    shards.

    Returns per-expert arrays: params {name: [E, *engine.param_shape(name)]}
    (NaN where a level holds fewer inducing points than the engine's M),
    objective [E], converged [E], iterations [E], preds {"f*", "f*_var",
    "y_var": [E, P_max], NaN beyond each expert's P}, n_pred [E], f_bar [E],
    run_time [E] (the level's seconds per expert); and `buckets`, one dict a
    level: n_max, p_max, experts, seconds (the JAX package's bucket time),
    assemble_seconds, engine_seconds, pool_iterations (of the level's last
    pool run, 0 where the level ran no pool) and shard_pool_iterations (each
    shard's of that run; [] where the level ran no pool).
    """
    E = len(X_list)
    coords_scale = np.atleast_2d(coords_scale).astype(float)
    obs_scale = np.atleast_2d(obs_scale).astype(float)
    n_obs = np.array([len(o) for o in obs_list], dtype=int)
    n_pred = np.array([0 if (not predict or pc is None) else len(pc)
                       for pc in pred_list], dtype=int)
    buckets = make_buckets(n_obs, n_pred,
                           batch_size=batch_size if batch_size is not None
                           else max(E, 1))
    if verbose:
        print(f"{E} experts in {len(buckets)} buckets "
              f"(device: {_device_name(engine.device)})")

    p_all = int(n_pred.max()) if E and predict else 0
    out = {"params": {n: np.full((E,) + tuple(engine.param_shape(n)), np.nan)
                      for n in engine.param_names},
           "objective": np.full(E, np.nan),
           "converged": np.zeros(E, dtype=bool),
           "iterations": np.zeros(E, dtype=int),
           "preds": {k: np.full((E, p_all), np.nan) for k in PRED_KEYS}
           if predict else {},
           "n_pred": n_pred, "f_bar": np.zeros(E),
           "run_time": np.full(E, np.nan), "buckets": []}

    def assemble(bk):
        t0 = time.perf_counter()
        arrays = assemble_bucket(bk, X_list, obs_list, pred_list,
                                 coords_scale, obs_scale, obs_mean,
                                 overrides, predict, expert_locs)
        return arrays, time.perf_counter() - t0

    # one-deep prefetch: the next level's host assembly overlaps the current
    # level's device execution
    with ThreadPoolExecutor(max_workers=1) as prefetch:
        pending = prefetch.submit(assemble, buckets[0]) if buckets else None
        for bki, bk in enumerate(buckets):
            t0 = time.perf_counter()
            (X, y, mask, Xs, f_bar, ov, el_scaled), t_asm = pending.result()
            if bki + 1 < len(buckets):
                pending = prefetch.submit(assemble, buckets[bki + 1])
            ids = bk["indices"]
            engine._last_pool_iterations = 0
            engine._last_shard_pool_iterations = []
            t1 = time.perf_counter()
            result = engine.fit_predict_many(
                X, y, mask, Xs=Xs, optimise=optimise, predict=predict,
                param_overrides=ov, expert_locs=el_scaled, mesh=mesh)
            t2 = time.perf_counter()
            b = len(ids)
            bucket_time = t2 - t0
            per_expert_time = bucket_time / max(b, 1)

            for name, v in result["params"].items():
                _put(out["params"][name], ids, np.asarray(v)[:b])
            out["objective"][ids] = np.asarray(result["objective"])[:b]
            out["converged"][ids] = np.asarray(result["converged"])[:b]
            out["iterations"][ids] = np.asarray(result.get(
                "iterations", np.zeros(b, int)))[:b]
            for k in out["preds"]:
                if k in result["preds"]:
                    v = np.asarray(result["preds"][k])
                    for bi, ei in enumerate(ids):
                        P = n_pred[ei]
                        out["preds"][k][ei, :P] = v[bi, :P]
            out["f_bar"][ids] = f_bar[:b]
            out["run_time"][ids] = per_expert_time
            out["buckets"].append({
                "n_max": bk["n_max"], "p_max": bk["p_max"], "experts": b,
                "seconds": bucket_time, "assemble_seconds": t_asm,
                "engine_seconds": t2 - t1,
                "pool_iterations": int(engine._last_pool_iterations),
                "shard_pool_iterations": list(
                    engine._last_shard_pool_iterations)})
            if on_bucket is not None:
                on_bucket(ids, result, f_bar, per_expert_time)
            if verbose:
                print(f"bucket N={bk['n_max']} P={bk['p_max']} B={b}: "
                      f"{bucket_time:.2f}s ({b / bucket_time:.1f} experts/s)")
    return out


# ---------------------------------------------------------------------------
# the experiment
# ---------------------------------------------------------------------------

class LocalExpertOI:
    """Main interface for a local-expert optimal-interpolation experiment.

    Runs its engine on `device` ("cuda" unless the caller passes another,
    e.g. "cpu"); raises without a card unless given a CPU device. The device
    never enters the stored config, so a store's oi_config is the JAX
    package's for the same experiment."""

    def __init__(self, expert_loc_config=None, data_config=None,
                 model_config=None, pred_loc_config=None,
                 locations=None, data=None, model=None, pred_loc=None,
                 device=None):
        # legacy argument names accepted like the reference
        expert_loc_config = expert_loc_config if expert_loc_config is not None else locations
        data_config = data_config if data_config is not None else data
        model_config = model_config if model_config is not None else model
        pred_loc_config = pred_loc_config if pred_loc_config is not None else pred_loc

        self.device = resolve_device(device)
        self.config = {}
        self.data = None
        self.model = None
        self.pred_loc = None
        self.expert_locs = None

        if data_config is not None:
            self.set_data(**data_config)
        if model_config is not None:
            self.set_model(**model_config)
        if expert_loc_config is not None:
            self.set_expert_locations(**expert_loc_config)
        # like the reference (GPSat/local_experts.py:254-260 via
        # _none_to_dict_check), a missing pred_loc config defaults to
        # PredictionLocations(method="expert_loc") — predict at the expert
        self.set_pred_loc(**(pred_loc_config or {}))

    # ------------------------------------------------------------------
    # configuration
    # ------------------------------------------------------------------

    def set_data(self, **kwargs):
        from gpsat_tpu_torch.utils import json_serializable
        self.config["data"] = json_serializable(dict(kwargs))
        self.data = LocalExpertData(**kwargs)
        if isinstance(self.data.data_source, str):
            self.data.set_data_source()

    def set_model(self, oi_model=None, init_params=None, constraints=None,
                  load_params=None, optim_kwargs=None, pred_kwargs=None,
                  params_to_store=None, replacement_threshold=None,
                  replacement_model=None, replacement_init_params=None,
                  replacement_constraints=None, replacement_optim_kwargs=None,
                  replacement_pred_kwargs=None):
        from gpsat_tpu_torch.models import get_model
        from gpsat_tpu_torch.utils import json_serializable
        self.config["model"] = json_serializable(dict(
            oi_model=oi_model, init_params=init_params, constraints=constraints,
            load_params=load_params, optim_kwargs=optim_kwargs,
            pred_kwargs=pred_kwargs, params_to_store=params_to_store,
            replacement_threshold=replacement_threshold,
            replacement_model=replacement_model))
        self.model = oi_model
        if isinstance(self.model, str):
            self.model = get_model(self.model)
        elif isinstance(self.model, dict):
            import importlib
            import sys
            sys.path.append(self.model["path_to_model"])
            module = importlib.import_module(self.model["path_to_model"])
            self.model = getattr(module, self.model["model_name"])
        self.model_init_params = {} if init_params is None else dict(init_params)
        self.constraints = constraints
        self.model_load_params = load_params
        self.optim_kwargs = {} if optim_kwargs is None else dict(optim_kwargs)
        self.pred_kwargs = {} if pred_kwargs is None else dict(pred_kwargs)
        self.params_to_store = None if params_to_store in (None, "all") else params_to_store
        if replacement_threshold is not None:
            # batched engines pad ragged experts, so a cheaper replacement
            # model for small experts is unnecessary; accepted for config
            # compatibility (reference: GPSat/local_experts.py:339-346)
            warnings.warn("replacement_model/threshold accepted but ignored: "
                          "the batched scheduler handles small experts directly")

    def set_expert_locations(self, df=None, file=None, source=None, where=None,
                             add_data_to_col=None, col_funcs=None,
                             keep_cols=None, col_select=None, row_select=None,
                             sort_by=None, reset_index=False,
                             source_kwargs=None, verbose=False, **kwargs):
        from gpsat_tpu_torch.dataloader import DataLoader
        from gpsat_tpu_torch.utils import json_serializable
        if (col_select is None) and (keep_cols is not None):
            col_select = keep_cols
        if source is None and df is not None:
            source = df
        if source is None and file is not None:
            source = file
        if source is None:
            return None
        self.config["locations"] = json_serializable(dict(
            source=source if isinstance(source, str) else "<dataframe>",
            where=where, col_funcs=col_funcs, col_select=col_select,
            row_select=row_select, sort_by=sort_by))
        locs = DataLoader.load(source=source, where=where,
                               source_kwargs=source_kwargs, col_funcs=col_funcs,
                               row_select=row_select, col_select=col_select,
                               reset_index=reset_index,
                               add_data_to_col=add_data_to_col,
                               verbose=verbose, **kwargs)
        if sort_by:
            locs = locs.sort_values(sort_by)
        self.expert_locs = locs.reset_index(drop=True)

    def set_pred_loc(self, **kwargs):
        import pandas as pd
        from gpsat_tpu_torch.prediction_locations import PredictionLocations
        from gpsat_tpu_torch.utils import json_serializable
        self.config["pred_loc"] = json_serializable(
            {k: (v if not isinstance(v, pd.DataFrame) else "<dataframe>")
             for k, v in kwargs.items()})
        self.pred_loc = PredictionLocations(**kwargs)
        if isinstance(self.data, LocalExpertData):
            self.pred_loc.coords_col = self.data.coords_col

    # ------------------------------------------------------------------
    # resume helpers (reference: GPSat/local_experts.py:475-497)
    # ------------------------------------------------------------------

    @staticmethod
    def _remove_previously_run_locations(store_path, xprt_locs,
                                         table="run_details"):
        from gpsat_tpu_torch.store import ResultsStore
        try:
            with ResultsStore(store_path, mode="r") as store:
                if not store.has_table(table):
                    return xprt_locs
                prev = store.select(table)
            idx_names = [n for n in prev.index.names if n is not None]
            if not idx_names:
                return xprt_locs
            prev = prev.reset_index()[idx_names].drop_duplicates()
            tmp = xprt_locs.merge(prev, how="left", on=idx_names,
                                  indicator="found_already")
            keep = tmp["found_already"] == "left_only"
            print(f"for table: {table} returning {keep.sum()} / {len(keep)} entries")
            return xprt_locs.loc[keep.values].copy(True)
        except (OSError, KeyError, FileNotFoundError):
            return xprt_locs

    # ------------------------------------------------------------------
    # parameter loading (for smoothed re-prediction etc.)
    # ------------------------------------------------------------------

    def _load_param_overrides(self, xprt_locs, coords_col, engine,
                              file, table_suffix="", param_names=None,
                              index_adjust=None, **unused):
        """Read per-expert parameter tables and align them to xprt_locs.

        Returns (overrides: {param: [E, ...] array with NaN where missing},
        have_all: [E] bool). Reference equivalent:
        GPSat/local_experts.py:553-689 (_read_params_from_file), vectorised to
        one table read per parameter instead of one HDF5 select per expert.
        """
        from gpsat_tpu_torch.store import ResultsStore
        if param_names is None:
            param_names = engine.param_names
        # only hyperparameters gate the "has all params" check; inducing
        # points and the variational extras (inducing_mean, ...) are
        # best-effort warm starts
        required = set(engine.HYPER_NAMES)
        E = len(xprt_locs)
        overrides, have = {}, np.ones(E, dtype=bool)
        key_df = xprt_locs[coords_col].reset_index(drop=True)

        with ResultsStore(file, mode="r") as store:
            for pn in param_names:
                tname = f"{pn}{table_suffix}"
                if not store.has_table(tname):
                    if pn in required:
                        warnings.warn(f"param table {tname} not found in {file}")
                        have[:] = False
                    continue
                df = store.select(tname).reset_index()
                dim_cols = sorted([c for c in df.columns if c.startswith("_dim_")])
                shape = engine.param_shape(pn)
                size = int(np.prod(shape)) if shape else 1
                arr = np.full((E, size), np.nan)
                if dim_cols:
                    piv = df.pivot_table(index=coords_col, columns=dim_cols,
                                         values=pn, aggfunc="last")
                    # row-major (dim_0, dim_1, ...) order, flat columns so the
                    # merge below stays single-level
                    piv = piv.sort_index(axis=1)
                    piv.columns = range(piv.shape[1])
                else:
                    piv = df.set_index(coords_col)[[pn]]
                merged = key_df.merge(piv.reset_index(), on=coords_col, how="left")
                vals = merged.drop(columns=coords_col).values
                arr[:, :min(size, vals.shape[1])] = vals[:, :size]
                overrides[pn] = arr.reshape((E,) + (shape if shape else ()))
                if pn in required:
                    have &= ~np.isnan(arr).any(axis=1)
        return overrides, have

    # ------------------------------------------------------------------
    # the batched sweep
    # ------------------------------------------------------------------

    def run(self, store_path=None, store_every=10, check_config_compatible=True,
            skip_valid_checks_on=None, optimise=True, predict=True, min_obs=3,
            table_suffix="", batch_size=None, use_mesh=True,
            multihost="auto", verbose=True):
        """Full sweep: train + predict every expert location, batched.

        API and store schema match the JAX package's run (and the
        reference's, GPSat/local_experts.py:761); `batch_size` caps the
        experts handed to the engine per level. With `use_mesh` and more
        than one card (torch.cuda.device_count() for a CUDA engine; a CPU
        engine counts one device), each level's experts split over every
        card (parallel/mesh.get_mesh), as the JAX package decides it
        (gpsat_tpu/local_experts.py:445-461).

        multihost: "auto" (default) detects a multi-process run (initialised
        torch.distributed, GPSAT_PROCESS_ID/GPSAT_NUM_PROCESSES, or SLURM_*)
        and makes this process sweep only its strided stripe of the expert
        grid into a rank-namespaced store (share-nothing); merge with
        gpsat_tpu_torch.parallel.multihost.merge_result_stores. False
        disables detection.
        """
        import pandas as pd
        from gpsat_tpu_torch.parallel.multihost import (partition_experts,
                                                        process_info,
                                                        rank_store_path)
        from gpsat_tpu_torch.store import ResultsStore
        from gpsat_tpu_torch.utils import (check_prev_oi_config, cprint,
                                           get_previous_oi_config,
                                           json_serializable,
                                           pretty_print_class)

        self.config["run_kwargs"] = json_serializable(dict(
            store_path=store_path, store_every=store_every,
            check_config_compatible=check_config_compatible,
            skip_valid_checks_on=skip_valid_checks_on, optimise=optimise,
            predict=predict, min_obs=min_obs, table_suffix=table_suffix))

        assert isinstance(self.expert_locs, pd.DataFrame), \
            f"expert_locs is {type(self.expert_locs)}, expected DataFrame"
        assert self.data is not None and self.data.data_source is not None, \
            "'data_source' is None"
        assert self.model is not None, "'model' is None"
        assert isinstance(store_path, str), "store_path must be provided"
        min_obs = max(1, int(min_obs))

        # -- multi-process partitioning (share-nothing) ---------------------
        rank, world = (0, 1) if multihost is False else process_info()
        expert_locs_run = self.expert_locs
        if world > 1:
            store_path = rank_store_path(store_path, rank, world)
            expert_locs_run = partition_experts(self.expert_locs, rank, world)
            if verbose:
                cprint(f"multihost: rank {rank}/{world} -> "
                       f"{len(expert_locs_run)} experts, store {store_path}",
                       "OKCYAN")

        t_start = time.perf_counter()
        coords_col = self.data.coords_col
        obs_col = self.data.obs_col if not isinstance(self.data.obs_col, list) \
            else self.data.obs_col[0]

        # -- config identity + resume ------------------------------------
        prev_oi_config, skip_valid_checks_on, config_id = get_previous_oi_config(
            store_path, oi_config=self.config,
            skip_valid_checks_on=skip_valid_checks_on,
            table_name=f"oi_config{table_suffix}")
        if check_config_compatible:
            check_prev_oi_config(prev_oi_config, oi_config=self.config,
                                 skip_valid_checks_on=skip_valid_checks_on)

        store_locs = self._remove_previously_run_locations(
            store_path, expert_locs_run.copy(True),
            table=f"expert_locs{table_suffix}")
        if len(store_locs):
            with ResultsStore(store_path, mode="a") as store:
                store.append(f"expert_locs{table_suffix}",
                             store_locs.set_index(coords_col))

        xprt_locs = self._remove_previously_run_locations(
            store_path, expert_locs_run.copy(True),
            table=f"run_details{table_suffix}")
        E = len(xprt_locs)
        if E == 0:
            print("no new expert locations to run")
            return None
        xprt_locs = xprt_locs.reset_index(drop=True)

        # -- build the batched engine -------------------------------------
        init_params = dict(self.model_init_params)
        coords_scale = np.atleast_2d(init_params.get("coords_scale", 1.0)).astype(float)
        obs_scale = np.atleast_2d(init_params.get("obs_scale", 1.0)).astype(float)
        obs_mean_cfg = init_params.get("obs_mean", None)
        engine = make_engine(self.model, init_params, self.constraints,
                             coords_dim=len(coords_col),
                             optim_kwargs=self.optim_kwargs, device=self.device)

        # -- phase 1: host gather -----------------------------------------
        gather_t0 = time.perf_counter()
        local_idx, local_dfs, group_of_expert = self._gather_local_data(
            xprt_locs, coords_col)
        pred_coords = self._gather_pred_locations(xprt_locs, coords_col,
                                                  predict=predict)
        n_obs = np.array([len(ix) for ix in local_idx])
        n_pred = np.array([0 if pc is None else len(pc) for pc in pred_coords])
        gather_time = time.perf_counter() - gather_t0
        if verbose:
            cprint(f"gather phase: {gather_time:.2f}s; experts: {E}, "
                   f"median obs: {np.median(n_obs):.0f}, "
                   f"median preds: {np.median(n_pred):.0f}", "OKCYAN")

        # -- parameter loading --------------------------------------------
        overrides, have_params = None, np.ones(E, dtype=bool)
        save_params = True
        if self.model_load_params is not None:
            lp = dict(self.model_load_params)
            if lp.get("previous", False):
                warnings.warn("load_params['previous'] (sequential warm start) "
                              "is not supported by the batched scheduler; "
                              "ignoring")
            elif lp.get("file") is not None:
                overrides, have_params = self._load_param_overrides(
                    xprt_locs, coords_col, engine, **lp)
                same_table = (lp.get("file") == store_path and
                              lp.get("table_suffix", "") == table_suffix)
                save_params = not (same_table and (not optimise))

        # -- phase 2: classify experts ------------------------------------
        runnable = (n_obs >= min_obs) & have_params
        if predict:
            has_pred = n_pred > 0
        else:
            has_pred = np.ones(E, dtype=bool)
        too_few = (n_obs < min_obs) & has_pred
        run_ids = np.where(runnable & has_pred)[0]

        store_buffer = {}
        device = _device_name(engine.device)
        model_name = pretty_print_class(self.model)[:64]

        # record zero-pred-loc experts so restarts skip them (the reference
        # 'continue's silently with a TODO admitting they should be stored —
        # GPSat/local_experts.py:962-965), then too-few-obs experts
        # (reference: GPSat/local_experts.py:988-1012)
        for i in np.concatenate([np.where(~has_pred)[0], np.where(too_few)[0]]):
            rd = self._run_details_row(xprt_locs.iloc[i], coords_col,
                                       num_obs=int(n_obs[i]), run_time=np.nan,
                                       objective=np.nan, optimise=optimise,
                                       success=False, model_name=model_name,
                                       device="", config_id=config_id)
            self._buffer(store_buffer, "run_details", rd)

        # -- phases 2-3: bucket + execute, storing each level as it ends ----
        mesh = get_mesh() if (use_mesh and _device_count(engine.device) > 1) \
            else None
        X_list, obs_list, pred_list = [], [], []
        for ei in run_ids:
            gdf = local_dfs[group_of_expert[ei]]
            rows = local_idx[ei]
            X_list.append(gdf.loc[rows, coords_col].values)
            obs_list.append(gdf.loc[rows, obs_col].values.astype(float))
            pred_list.append(pred_coords[ei] if predict else None)
        run_overrides = None if overrides is None else \
            {k: v[run_ids] for k, v in overrides.items()}

        def store_bucket(ids, result, f_bar, per_expert_time):
            self._store_bucket_results(
                store_buffer, result, run_ids[ids], xprt_locs, coords_col,
                n_obs, n_pred, pred_coords, f_bar, per_expert_time, optimise,
                predict, save_params, model_name, device, config_id)
            self._flush(store_buffer, store_path, table_suffix)

        done = execute_buckets(
            engine, X_list, obs_list, pred_list, coords_scale=coords_scale,
            obs_scale=obs_scale, obs_mean=obs_mean_cfg, overrides=run_overrides,
            optimise=optimise, predict=predict, batch_size=batch_size,
            on_bucket=store_bucket, verbose=verbose,
            expert_locs=xprt_locs.loc[run_ids, coords_col].values, mesh=mesh)

        # flush remaining (e.g. only skip records)
        self._flush(store_buffer, store_path, table_suffix, force=True)
        if verbose:
            cprint(f"'run': {time.perf_counter() - t_start:.3f} seconds "
                   f"({sum(b['experts'] for b in done['buckets'])} experts)",
                   "OKGREEN")
        return None

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _gather_local_data(self, xprt_locs, coords_col):
        """Group experts by global where-list; load each group's data once and
        KD-select per-expert local row indices."""
        from gpsat_tpu_torch.dataloader import DataLoader
        from gpsat_tpu_torch.utils import json_serializable
        E = len(xprt_locs)
        global_select = self.data.global_select or []
        local_select = self.data.local_select or []

        group_key, group_where = [], {}
        for i in range(E):
            rl = xprt_locs.iloc[[i]]
            where = DataLoader.get_where_list(global_select,
                                              local_select=local_select,
                                              ref_loc=rl)
            key = json.dumps(json_serializable(where), sort_keys=True)
            group_key.append(key)
            group_where[key] = where

        local_dfs, group_of_expert, local_idx = {}, [None] * E, [None] * E
        for key, where in group_where.items():
            members = [i for i in range(E) if group_key[i] == key]
            df = self.data.load(where=where if where else None,
                                reset_index=True)
            local_dfs[key] = df
            kdts = DataLoader.kdt_tree_list_for_local_select(df, local_select) \
                if local_select else None

            # per-expert KD radius queries are independent reads of the same
            # tree/frame; cKDTree.query_ball_point releases the GIL, so a
            # thread pool runs them in parallel
            def _select(i):
                rl = xprt_locs.iloc[[i]]
                sel = DataLoader.local_data_select(
                    df, reference_location=rl, local_select=local_select,
                    kdtree=kdts, verbose=False)
                return i, sel.index.values

            if len(members) > 8:
                with ThreadPoolExecutor(max_workers=8) as tpe:
                    results = list(tpe.map(_select, members))
            else:
                results = [_select(i) for i in members]
            for i, idx in results:
                local_idx[i] = idx
                group_of_expert[i] = key
        return local_idx, local_dfs, group_of_expert

    def _gather_pred_locations(self, xprt_locs, coords_col, predict=True):
        """Per-expert prediction coordinate arrays (raw units)."""
        from gpsat_tpu_torch.prediction_locations import PredictionLocations
        E = len(xprt_locs)
        if not predict:
            return [None] * E
        if self.pred_loc is None:
            # no pred_loc was ever configured (setters used piecemeal):
            # default to predicting at the expert location like the reference.
            # Built directly (not via set_pred_loc) so the config identity
            # computed at the top of run() is not mutated afterwards.
            self.pred_loc = PredictionLocations()
        if self.pred_loc.coords_col is None:
            self.pred_loc.coords_col = coords_col
        out = []
        for i in range(E):
            self.pred_loc.expert_loc = xprt_locs.iloc[[i]]
            pc = self.pred_loc()
            out.append(pc if len(pc) else None)
        return out

    @staticmethod
    def _run_details_row(rl, coords_col, num_obs, run_time, objective,
                         optimise, success, model_name, device, config_id):
        import pandas as pd
        midx = pd.MultiIndex.from_tuples(
            [tuple(rl[coords_col].values.reshape(-1))], names=coords_col)
        return pd.DataFrame({
            "num_obs": [num_obs], "run_time": [run_time],
            "optimise_iterations": [0],
            "objective_value": [objective], "parameters_optimised": [optimise],
            "optimise_success": [success], "model": [model_name],
            "device": [device], "config_id": [config_id]}, index=midx)

    def _store_bucket_results(self, buffer, result, ids, xprt_locs, coords_col,
                              n_obs, n_pred, pred_coords, f_bar,
                              per_expert_time, optimise, predict, save_params,
                              model_name, device, config_id):
        import pandas as pd
        b_valid = len(ids)
        params = result["params"]
        objective = result["objective"]
        converged = result["converged"]
        preds = result["preds"]

        # run_details ------------------------------------------------------
        exp_coords = xprt_locs.loc[ids, coords_col].values
        midx = pd.MultiIndex.from_arrays(exp_coords.T, names=coords_col)
        # run_time is the bucket average (the reference's schema has one
        # wall-time per expert row; batched execution has no meaningful
        # per-expert wall time). The per-expert skew the pool compacts is
        # exposed via optimise_iterations instead.
        iters = np.asarray(result.get("iterations",
                                      np.zeros(b_valid, int)))[:b_valid]
        rd = pd.DataFrame({
            "num_obs": n_obs[ids].astype(int),
            "run_time": np.full(b_valid, per_expert_time),
            "optimise_iterations": iters.astype(int),
            "objective_value": objective[:b_valid],
            "parameters_optimised": np.full(b_valid, bool(optimise)),
            "optimise_success": (converged[:b_valid] if optimise
                                 else np.zeros(b_valid, dtype=bool)),
            "model": model_name, "device": device, "config_id": config_id,
        }, index=midx)
        self._buffer(buffer, "run_details", rd)

        # per-parameter tables --------------------------------------------
        if save_params:
            pts = self.params_to_store
            for pn, vals in params.items():
                if pts is not None and pn not in pts:
                    continue
                v = np.asarray(vals)[:b_valid]
                if v.ndim == 1:
                    pdf = pd.DataFrame({"_dim_0": 0, pn: v}, index=midx)
                elif v.ndim == 2:
                    D = v.shape[1]
                    rep_idx = pd.MultiIndex.from_arrays(
                        np.repeat(exp_coords, D, axis=0).T, names=coords_col)
                    pdf = pd.DataFrame({"_dim_0": np.tile(np.arange(D), b_valid),
                                        pn: v.reshape(-1)}, index=rep_idx)
                else:
                    M, D = v.shape[1], v.shape[2]
                    rep_idx = pd.MultiIndex.from_arrays(
                        np.repeat(exp_coords, M * D, axis=0).T, names=coords_col)
                    pdf = pd.DataFrame({
                        "_dim_0": np.tile(np.repeat(np.arange(M), D), b_valid),
                        "_dim_1": np.tile(np.arange(D), b_valid * M),
                        pn: v.reshape(-1)}, index=rep_idx)
                self._buffer(buffer, pn, pdf)

        # predictions ------------------------------------------------------
        if predict and preds:
            frames = []
            for bi, ei in enumerate(ids):
                pc = pred_coords[ei]
                if pc is None:
                    continue
                P = len(pc)
                row_idx = pd.MultiIndex.from_arrays(
                    np.repeat(exp_coords[bi][None, :], P, axis=0).T,
                    names=coords_col)
                data = {"_dim_0": np.arange(P)}
                for k in PRED_KEYS:
                    data[k] = np.asarray(preds[k])[bi, :P]
                data["f_bar"] = np.full(P, f_bar[bi])
                for ci, c in enumerate(coords_col):
                    data[f"pred_loc_{c}"] = pc[:, ci]
                frames.append(pd.DataFrame(data, index=row_idx))
            if frames:
                self._buffer(buffer, "preds", pd.concat(frames, axis=0))

    @staticmethod
    def _buffer(buffer, table, df):
        buffer.setdefault(table, []).append(df)

    def plot_locations_and_obs(self, obs_sample=20000, ax=None,
                               show=False, save_path=None):
        """Scatter of observation positions with expert locations overlaid
        (reference: GPSat/local_experts.py:1282)."""
        import matplotlib
        if save_path or not show:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        assert self.expert_locs is not None, "expert_locs not set"
        df = self.data.load(reset_index=True)
        if obs_sample and len(df) > obs_sample:
            df = df.sample(obs_sample, random_state=0)
        cc = self.data.coords_col
        if ax is None:
            fig, ax = plt.subplots(figsize=(8, 8))
        else:
            fig = ax.figure
        ax.scatter(df[cc[0]], df[cc[1]], s=2, c="C0", alpha=0.4,
                   label="observations")
        ax.scatter(self.expert_locs[cc[0]], self.expert_locs[cc[1]], s=40,
                   c="C3", marker="x", label="expert locations")
        ax.set_xlabel(cc[0]); ax.set_ylabel(cc[1])
        ax.legend(); ax.set_aspect("equal")
        if save_path:
            fig.savefig(save_path, dpi=100)
        if show:  # pragma: no cover
            plt.show()
        return fig

    @staticmethod
    def _flush(buffer, store_path, table_suffix, force=True):
        import pandas as pd
        from gpsat_tpu_torch.store import ResultsStore
        if not buffer:
            return
        with ResultsStore(store_path, mode="a") as store:
            for table, dfs in buffer.items():
                df = pd.concat(dfs, axis=0)
                store.append(f"{table}{table_suffix}", df)
        buffer.clear()


# ---------------------------------------------------------------------------
# results reading (reference: GPSat/local_experts.py:1467)
# ---------------------------------------------------------------------------

def get_results_from_h5file(results_file, global_col_funcs=None,
                            merge_on_expert_locations=True, select_tables=None,
                            table_suffix="", add_suffix_to_table=True,
                            verbose=False):
    """Read all (or selected) tables + stored oi_config list from a results
    store. Returns (dict of DataFrames, list of config dicts)."""
    from gpsat_tpu_torch.dataloader import DataLoader
    from gpsat_tpu_torch.store import ResultsStore
    from gpsat_tpu_torch.utils import nested_dict_literal_eval
    if select_tables is not None and add_suffix_to_table:
        select_tables = [f"{t}{table_suffix}" for t in select_tables]

    dfs, oi_config = {}, []
    with ResultsStore(results_file, mode="r") as store:
        keys = store.keys()
        cfg_table = f"oi_config{table_suffix}"
        if cfg_table in keys:
            cdf = store.select(cfg_table).reset_index(drop=True)
            cdf = cdf[["config"]].drop_duplicates()
            oi_config = [nested_dict_literal_eval(json.loads(c))
                         for c in cdf["config"].values]
        for k in keys:
            if select_tables is not None and k not in select_tables:
                continue
            try:
                dfs[k] = store.select(k).reset_index()
            except Exception as e:
                print(f"issue reading table {k}: {e}")

    if global_col_funcs is not None:
        for k in dfs:
            try:
                DataLoader.add_cols(df=dfs[k], col_func_dict=global_col_funcs)
            except Exception as e:
                print(f"col_funcs failed on table {k}: {e}")

    expert_locations = None
    el_table = f"expert_locs{table_suffix}"
    if el_table in dfs:
        expert_locations = dfs[el_table].copy(True)
    if expert_locations is not None and merge_on_expert_locations:
        try:
            coords_col = oi_config[0]["data"]["coords_col"]
        except (IndexError, KeyError):
            coords_col = None
        if coords_col:
            for k in dfs:
                if np.isin(coords_col, dfs[k].columns).all():
                    dfs[k] = dfs[k].merge(expert_locations, on=coords_col,
                                          how="left",
                                          suffixes=["", "_expert_location"])
    return dfs, oi_config
