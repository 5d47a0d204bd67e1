"""The port's host modules (gpsat_tpu_torch store, dataloader, dataprepper,
prediction_locations, utils, config_dataclasses, parallel/multihost) against
the JAX package's on the same seeded frames; stores written by one package
read back in the other; `execute_buckets` against per-bucket engine calls;
and the device half of the pipeline with pandas, h5py and jax blocked."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pandas as pd
import pytest
import torch

from gpsat_tpu import utils as jax_utils
from gpsat_tpu.config_dataclasses import ExperimentConfig as JaxExperimentConfig
from gpsat_tpu.dataloader import DataLoader as JaxDataLoader
from gpsat_tpu.dataprepper import DataPrep as JaxDataPrep
from gpsat_tpu.local_experts import get_results_from_h5file as jax_results
from gpsat_tpu.parallel import multihost as jax_multihost
from gpsat_tpu.prediction_locations import \
    PredictionLocations as JaxPredictionLocations
from gpsat_tpu.store import ResultsStore as JaxResultsStore
from gpsat_tpu_torch import utils
from gpsat_tpu_torch.config_dataclasses import ExperimentConfig
from gpsat_tpu_torch.dataloader import DataLoader
from gpsat_tpu_torch.dataprepper import DataPrep
from gpsat_tpu_torch.local_experts import (LocalExpertOI, assemble_bucket,
                                           execute_buckets,
                                           get_results_from_h5file,
                                           make_engine)
from gpsat_tpu_torch.models.exact_gpr import GPRModel
from gpsat_tpu_torch.parallel import multihost
from gpsat_tpu_torch.parallel.scheduler import make_buckets
from gpsat_tpu_torch.prediction_locations import PredictionLocations
from gpsat_tpu_torch.store import ResultsStore

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "golden_inline.h5")
KM = 1000.0


@pytest.fixture
def sample_df():
    rng = np.random.default_rng(0)
    return pd.DataFrame({
        "x": rng.uniform(-3, 3, 200),
        "y": rng.uniform(-3, 3, 200),
        "t": rng.integers(0, 5, 200).astype(float),
        "z": rng.standard_normal(200),
        "source": rng.choice(["A", "B"], 200),
        "date": np.datetime64("2020-03-01")
        + rng.integers(0, 9, 200).astype("timedelta64[D]"),
        "flag": rng.integers(0, 2, 200).astype(bool),
    })


# ---------------------------------------------------------------------------
# stores: one package writes, the other reads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer, reader", [(ResultsStore, JaxResultsStore),
                                            (JaxResultsStore, ResultsStore)])
def test_store_round_trip_across_packages(tmp_path, sample_df, writer,
                                          reader):
    """Every column type, a multi-index, appends, attributes and where
    filters written by one package read back equal in the other."""
    path = str(tmp_path / "s.h5")
    indexed = sample_df.set_index(["x", "y"])
    with writer(path) as s:
        s.append("data", sample_df)
        s.append("data", sample_df)
        s.append("mi", indexed)
        s.set_attr("mi", "config", {"a": [1, 2], "b": "c"})
    with reader(path, "r") as s:
        back = s.select("data").reset_index(drop=True)
        mi = s.select("mi")
        sel = s.select("data", where=[{"col": "t", "comp": ">=", "val": 2},
                                      "source == 'A'"])
        assert s.get_attr("mi", "config") == {"a": [1, 2], "b": "c"}
        assert s.index_cols("mi") == ["x", "y"]
    both = pd.concat([sample_df, sample_df]).reset_index(drop=True)
    pd.testing.assert_frame_equal(back, both, check_dtype=False)
    pd.testing.assert_frame_equal(mi, indexed, check_dtype=False)
    want = both[(both["t"] >= 2) & (both["source"] == "A")]
    pd.testing.assert_frame_equal(sel.reset_index(drop=True),
                                  want.reset_index(drop=True),
                                  check_dtype=False)


@pytest.fixture(scope="module")
def port_store(tmp_path_factory):
    """A results store written by the port's LocalExpertOI (a small GPR run
    on the CPU in f64)."""
    rng = np.random.default_rng(3)
    df = pd.DataFrame({"x": rng.uniform(-10, 10, 80),
                       "y": rng.uniform(-10, 10, 80),
                       "z": rng.standard_normal(80), "t": 0.0})
    eloc = pd.DataFrame({"x": [-3.0, 3.0, 0.0], "y": [0.0, 0.0, 3.0],
                         "t": 0.0})
    ploc = pd.DataFrame({"x": [-1.0, 0.0, 1.0], "y": [0.0, 1.0, 2.0]})
    path = str(tmp_path_factory.mktemp("port_store") / "p.h5")
    LocalExpertOI(
        expert_loc_config={"source": eloc},
        data_config={"data_source": df, "obs_col": "z",
                     "coords_col": ["x", "y", "t"],
                     "local_select": [{"col": ["x", "y"], "comp": "<",
                                       "val": 8}]},
        model_config={"oi_model": "GPRModel",
                      "optim_kwargs": {"max_iter": 15}},
        pred_loc_config={"method": "from_dataframe", "df": ploc,
                         "max_dist": 5.0},
        device="cpu").run(store_path=path, verbose=False)
    return path


@pytest.mark.parametrize("path", ["port", "golden"])
def test_results_read_the_same_through_either_package(path, port_store):
    """A store written by the port (and the committed golden, written by the
    JAX package) reads back equal through both packages'
    get_results_from_h5file, merged on expert locations and not."""
    path = port_store if path == "port" else GOLDEN
    for merge in (True, False):
        got, got_cfg = get_results_from_h5file(
            path, merge_on_expert_locations=merge)
        want, want_cfg = jax_results(path, merge_on_expert_locations=merge)
        assert got_cfg == want_cfg and len(got_cfg) == 1
        assert sorted(got) == sorted(want)
        for k in want:
            pd.testing.assert_frame_equal(got[k], want[k])
    sel, _ = get_results_from_h5file(path, select_tables=["preds"])
    assert list(sel) == ["preds"]


def test_port_store_schema(port_store):
    dfs, cfg = jax_results(port_store, merge_on_expert_locations=False)
    assert sorted(dfs) == ["expert_locs", "kernel_variance", "lengthscales",
                           "likelihood_variance", "oi_config", "preds",
                           "run_details"]
    assert cfg[0]["model"]["optim_kwargs"] == {"max_iter": 15}
    rd = dfs["run_details"]
    assert len(rd) == 3 and (rd["device"] == "cpu:cpu").all()
    assert (rd["model"] == "gpsat_tpu_torch.models.exact_gpr.GPRModel").all()
    assert (rd["optimise_iterations"] <= 15).all()


# ---------------------------------------------------------------------------
# DataLoader, DataPrep, PredictionLocations against the JAX package
# ---------------------------------------------------------------------------

LOAD_CASES = {
    "where": dict(where=[{"col": "t", "comp": ">=", "val": 2}]),
    "row_select": dict(row_select=[{"col": "z", "comp": "<", "val": 0.5},
                                   {"col": "source", "comp": "==",
                                    "val": "A", "negate": True}]),
    "where_and_row_select": dict(
        where={"col": "date", "comp": ">=",
               "val": np.datetime64("2020-03-04")},
        row_select=[{"col": "x", "comp": ">", "val": -1}],
        col_select=["x", "y", "z"], reset_index=True),
    "col_funcs": dict(col_funcs={"r": {"func": "lambda x, y: x * x + y * y",
                                       "col_args": ["x", "y"]},
                                 "e": {"func": "np.exp", "col_args": "z"}},
                      row_select=[{"col": "r", "comp": "<", "val": 4.0}]),
}


@pytest.mark.parametrize("case", sorted(LOAD_CASES))
@pytest.mark.parametrize("source", ["frame", "store"])
def test_load_matches_jax(case, source, sample_df, tmp_path):
    kw = dict(LOAD_CASES[case])
    if source == "store":
        path = str(tmp_path / "d.h5")
        with ResultsStore(path) as s:
            s.append("data", sample_df)
        kw.update(source=path, table="data")
    else:
        kw.update(source=sample_df)
    got = DataLoader.load(**kw)
    want = JaxDataLoader.load(**kw)
    assert len(got) > 0
    pd.testing.assert_frame_equal(got, want)


@pytest.mark.parametrize("ref", [{"x": 0.5, "y": -0.5, "t": 2.0},
                                 {"x": 2.9, "y": 2.9, "t": 0.0}])
def test_local_data_select_matches_jax(sample_df, ref):
    local_select = [{"col": "t", "comp": "<=", "val": 1},
                    {"col": "t", "comp": ">=", "val": -1},
                    {"col": ["x", "y"], "comp": "<", "val": 1.5}]
    kdt = DataLoader.kdt_tree_list_for_local_select(sample_df, local_select)
    got = DataLoader.local_data_select(sample_df, pd.DataFrame([ref]),
                                       local_select, kdtree=kdt)
    want = JaxDataLoader.local_data_select(sample_df, ref, local_select)
    assert len(got) > 0
    pd.testing.assert_frame_equal(got, want)


def test_get_where_list_matches_jax():
    global_select = [{"col": "lat", "comp": ">=", "val": 60},
                     {"loc_col": "t", "src_col": "date", "func": "+"}]
    local_select = [{"col": "t", "comp": "<=", "val": 4},
                    {"col": "t", "comp": ">=", "val": -4}]
    ref = pd.DataFrame({"x": [1.0], "t": [18322.0]})
    got = DataLoader.get_where_list(global_select, local_select, ref)
    assert got == JaxDataLoader.get_where_list(global_select, local_select,
                                               ref)
    assert got[1] == {"col": "date", "comp": "<=", "val": 18326.0}


def test_generate_local_expert_locations_matches_jax():
    kw = dict(loc_dims={"x": np.arange(-2, 3.0), "y": np.arange(-1, 2.0),
                        "t": 5.0},
              row_select=[{"col": "x", "comp": "!=", "val": 0.0}],
              masks=[pd.DataFrame({"x": [-2.0, 1.0, 2.0]})], sort_by="y")
    pd.testing.assert_frame_equal(
        DataLoader.generate_local_expert_locations(**kw),
        JaxDataLoader.generate_local_expert_locations(**kw))


@pytest.mark.parametrize("kw", [
    dict(by_cols=["t"], val_col="z", grid_res=1.0, x_range=[-3, 3],
         y_range=[-3, 3]),
    dict(by_cols=["t", "source"], val_col="z", grid_res=0.5,
         x_range=[-3, 3], y_range=[-3, 3],
         bin_statistic=["mean", "count"]),
    dict(by_cols="source", val_col="z", grid_res=0.75, x_range=[-3, 3],
         y_range=[-3, 3], bin_2d=False,
         row_select=[{"col": "t", "comp": ">", "val": 0}]),
])
def test_bin_data_by_matches_jax(sample_df, kw):
    got = DataPrep.bin_data_by(df=sample_df, **kw)
    want = JaxDataPrep.bin_data_by(df=sample_df, **kw)
    assert got.dims == want.dims and got.data_vars == want.data_vars
    pd.testing.assert_frame_equal(got.to_dataframe(), want.to_dataframe())


@pytest.mark.parametrize("method, kw", [
    ("expert_loc", {}),
    ("shift_arrays", {"x": [-1.0, 0.0, 1.0], "y": [0.0, 2.0]}),
    ("from_dataframe", {"max_dist": 1.2}),
    ("from_dataframe", {}),
])
def test_prediction_locations_match_jax(method, kw):
    grid = pd.DataFrame(utils.grid_2d_flatten([-3, 3], [-3, 3],
                                              step_size=0.5),
                        columns=["x", "y"])
    if method == "from_dataframe":
        kw = {**kw, "df": grid}
    out = []
    for cls in (PredictionLocations, JaxPredictionLocations):
        pl = cls(method=method, coords_col=["x", "y", "t"], **kw)
        pl.expert_loc = pd.DataFrame({"x": [0.25], "y": [-0.5], "t": [3.0]})
        out.append(pl())
    assert out[0].shape[0] > 0
    np.testing.assert_array_equal(out[0], out[1])


# ---------------------------------------------------------------------------
# utils, config dataclasses, multihost
# ---------------------------------------------------------------------------

CONFIG_VALUES = [
    {"a": np.arange(3), ("b", "c"): np.float32(1.5), "d": [np.int64(2), None],
     "e": np.bool_(True), "f": np.datetime64("2020-01-01"),
     "g": pd.DataFrame({"u": [1, 2]}), "h": pd.Series({"v": 1.0}),
     "i": pd.DataFrame({"u": range(200)}), "j": print},
    [1, (2, 3), "x", 4.5],
]


@pytest.mark.parametrize("value", CONFIG_VALUES)
def test_json_serializable_matches_jax(value):
    got = utils.json_serializable(value)
    assert got == jax_utils.json_serializable(value)
    assert utils.nested_dict_literal_eval(json.loads(json.dumps(got))) == \
        jax_utils.nested_dict_literal_eval(json.loads(json.dumps(got)))


@pytest.mark.parametrize("func, kw", [
    ("np.sqrt", {"col_args": "r"}),
    ("lambda a, b: a - b", {"col_args": ["r", "s"]}),
    (">=", {"col_args": "r", "args": 1.0}),
    ("pd.to_datetime", {"args": ["2020-03-01"]}),
])
def test_config_func_matches_jax(func, kw):
    df = pd.DataFrame({"r": [0.5, 1.0, 4.0], "s": [1.0, 2.0, 3.0]})
    use_df = df if "col_args" in kw else None
    got = utils.config_func(func, df=use_df, **kw)
    want = jax_utils.config_func(func, df=use_df, **kw)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_array_helpers_match_jax():
    for args in (([-1, 1], [0, 2]), ([-1, 1], [0, 2], None, 0.5)):
        kw = {"step_size": 0.5} if len(args) == 2 else {}
        np.testing.assert_array_equal(
            utils.grid_2d_flatten(*args[:2], *args[2:], **kw),
            jax_utils.grid_2d_flatten(*args[:2], *args[2:], **kw))
    np.testing.assert_array_equal(utils.match([3, 1], [1, 2, 3]),
                                  jax_utils.match([3, 1], [1, 2, 3]))
    np.testing.assert_array_equal(
        utils.sparse_true_array((5, 4), grid_space=2),
        jax_utils.sparse_true_array((5, 4), grid_space=2))
    df = pd.DataFrame({"_dim_0": [0, 1, 1], "_dim_1": [1, 0, 1],
                       "v": [1.0, 2.0, 3.0]})
    np.testing.assert_array_equal(
        utils.dataframe_to_array(df, "v", idx_col=["_dim_0", "_dim_1"]),
        jax_utils.dataframe_to_array(df, "v", idx_col=["_dim_0", "_dim_1"]))
    row = pd.DataFrame({"x": [1.0], "t": [2.0]})
    assert utils.pandas_to_dict(row) == jax_utils.pandas_to_dict(row)
    assert utils.pandas_to_dict(row.iloc[0]) == {"x": 1.0, "t": 2.0}
    for v in (3, 2.5, [1, 2], pd.Series([1.0]), None):
        a, = utils.to_array(v)
        b, = jax_utils.to_array(v)
        np.testing.assert_array_equal(a, b)


def test_oi_config_identity_matches_jax(tmp_path):
    """get_previous_oi_config assigns the same ids in either package, and a
    store's config table written by one is matched by the other."""
    path = str(tmp_path / "c.h5")
    a, b = {"data": {"x": 1}}, {"data": {"x": 2}}
    assert utils.get_previous_oi_config(path, a)[2] == 1
    assert jax_utils.get_previous_oi_config(path, a)[2] == 1
    assert jax_utils.get_previous_oi_config(path, b)[2] == 2
    prev, _, cid = utils.get_previous_oi_config(path, b)
    assert cid == 2 and prev == b
    utils.check_prev_oi_config(prev, b)
    with pytest.raises(AssertionError):
        utils.check_prev_oi_config(a, b)
    utils.check_prev_oi_config(a, b, skip_valid_checks_on=["data"])


def test_experiment_config_matches_jax():
    with open(os.path.join(REPO, "configs",
                           "example_local_expert_oi.json")) as f:
        raw = json.load(f)
    got = ExperimentConfig.from_dict(raw)
    want = JaxExperimentConfig.from_dict(raw)
    assert got.to_dict() == want.to_dict()
    assert got.to_json(sort_keys=True) == want.to_json(sort_keys=True)


def test_partition_and_rank_paths_match_jax():
    df = pd.DataFrame({"x": np.arange(11.0)})
    for world in (1, 2, 3, 5):
        parts = [multihost.partition_experts(df, r, world)
                 for r in range(world)]
        for r, part in enumerate(parts):
            pd.testing.assert_frame_equal(
                part, jax_multihost.partition_experts(df, r, world))
        assert sorted(pd.concat(parts)["x"]) == list(df["x"])
        assert multihost.rank_store_paths("r/out.h5", world) == \
            jax_multihost.rank_store_paths("r/out.h5", world)
    assert multihost.rank_store_path("out.h5", 3, 8) == "out.r003of008.h5"


@pytest.mark.parametrize("env", [{}, {"GPSAT_PROCESS_ID": "2",
                                      "GPSAT_NUM_PROCESSES": "4"},
                                 {"SLURM_PROCID": "1", "SLURM_NTASKS": "3"}])
def test_process_info_matches_jax(monkeypatch, env):
    for k in ("GPSAT_PROCESS_ID", "GPSAT_NUM_PROCESSES", "SLURM_PROCID",
              "SLURM_NTASKS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert multihost.process_info() == jax_multihost.process_info()


def test_merge_result_stores_matches_jax(port_store, tmp_path):
    """Two rank stores merged by either package give the same store."""
    ranks = [str(tmp_path / f"r{i}.h5") for i in range(2)]
    for r in ranks:
        shutil.copy(port_store, r)
    merged = {}
    for name, mod in (("torch", multihost), ("jax", jax_multihost)):
        merged[name] = mod.merge_result_stores(ranks,
                                               str(tmp_path / f"{name}.h5"))
    got, _ = get_results_from_h5file(merged["torch"],
                                     merge_on_expert_locations=False)
    want, _ = jax_results(merged["jax"], merge_on_expert_locations=False)
    for k in want:
        pd.testing.assert_frame_equal(got[k], want[k])
    assert len(got["run_details"]) == 6


# ---------------------------------------------------------------------------
# execute_buckets and the config-file entry point
# ---------------------------------------------------------------------------

def ragged_experts(E=14, seed=0):
    """Per-expert raw arrays over three N levels (8, 16, 32) and P from 0 to
    9 (0: no prediction locations)."""
    rng = np.random.default_rng(seed)
    X_list, obs_list, pred_list = [], [], []
    for i in range(E):
        n = int(rng.integers(4, 30))
        X = rng.uniform(-50.0, 50.0, (n, 2))
        X_list.append(X)
        obs_list.append(np.sin(X[:, 0] / 20.0) + 0.1 * rng.standard_normal(n))
        p = int(rng.integers(0, 10))
        pred_list.append(rng.uniform(-50.0, 50.0, (p, 2)) if p else None)
    return X_list, obs_list, pred_list


def small_engine():
    return make_engine(GPRModel, {"coords_scale": [10.0, 10.0]},
                       {"lengthscales": {"low": [1e-3, 1e-3],
                                         "high": [50.0, 50.0]},
                        "likelihood_variance": {"low": 1e-4, "high": 1.0}},
                       coords_dim=2, optim_kwargs={"max_iter": 40},
                       device="cpu")


def test_make_engine_scales_the_lengthscale_bounds():
    eng = small_engine()
    np.testing.assert_array_equal(eng.bounds["lengthscales"][1], [5.0, 5.0])
    assert eng.dtype == torch.float64 and eng.device.type == "cpu"
    assert eng.param_names == \
        ["lengthscales", "kernel_variance", "likelihood_variance"]


def test_execute_buckets_equals_fit_predict_many_per_bucket():
    """execute_buckets on the CPU gives, per expert, exactly what
    assemble_bucket + engine.fit_predict_many give bucket by bucket."""
    X_list, obs_list, pred_list = ragged_experts()
    kw = dict(coords_scale=[[10.0, 10.0]], obs_scale=[[2.0]],
              obs_mean="local")
    calls = []
    out = execute_buckets(small_engine(), X_list, obs_list, pred_list,
                          on_bucket=lambda ids, *a: calls.append(ids), **kw)
    n_obs = [len(o) for o in obs_list]
    n_pred = [0 if p is None else len(p) for p in pred_list]
    buckets = make_buckets(n_obs, n_pred, batch_size=len(X_list))
    assert len(buckets) >= 3 and len({b["n_max"] for b in buckets}) == 3
    assert [b["n_max"] for b in out["buckets"]] == \
        [b["n_max"] for b in buckets]
    for bk, ids in zip(buckets, calls):
        np.testing.assert_array_equal(bk["indices"], ids)
        X, y, mask, Xs, f_bar, _, _ = assemble_bucket(
            bk, X_list, obs_list, pred_list,
            np.atleast_2d(kw["coords_scale"]), np.atleast_2d(kw["obs_scale"]),
            kw["obs_mean"])
        want = small_engine().fit_predict_many(X, y, mask, Xs=Xs)
        for name, v in want["params"].items():
            np.testing.assert_array_equal(out["params"][name][ids], v)
        for k in ("objective", "converged", "iterations"):
            np.testing.assert_array_equal(out[k][ids], want[k])
        np.testing.assert_array_equal(out["f_bar"][ids], f_bar)
        for bi, ei in enumerate(ids):
            P = n_pred[ei]
            assert out["n_pred"][ei] == P
            for k in ("f*", "f*_var", "y_var"):
                np.testing.assert_array_equal(out["preds"][k][ei, :P],
                                              want["preds"][k][bi, :P])
                assert np.isnan(out["preds"][k][ei, P:]).all()
    assert np.isfinite(out["objective"]).all()
    np.testing.assert_allclose(
        out["f_bar"], [np.mean(o) for o in obs_list], rtol=1e-14)


def test_execute_buckets_sgpr_inducing_points_by_level():
    """An SGPR level with fewer padded observations than M holds
    min(M, N) inducing points; the per-expert array is NaN beyond them."""
    from gpsat_tpu_torch.models.sgpr import SGPRModel
    X_list, obs_list, pred_list = ragged_experts(E=6, seed=1)
    eng = make_engine(SGPRModel, {"num_inducing_points": 12}, None,
                      coords_dim=2, optim_kwargs={"max_iter": 5},
                      device="cpu")
    out = execute_buckets(eng, X_list, obs_list, pred_list,
                          coords_scale=10.0)
    Z = out["params"]["inducing_points"]
    assert Z.shape == (6, 12, 2)
    for i, o in enumerate(obs_list):
        m = min(12, [8, 16, 32][int(np.searchsorted([8, 16, 32], len(o)))])
        assert np.isfinite(Z[i, :m]).all() and np.isnan(Z[i, m:]).all()
    assert eng.param_names == ["lengthscales", "kernel_variance",
                               "likelihood_variance", "inducing_points"]


def write_example_inputs(root):
    """The files configs/example_local_expert_oi.json reads, small: binned
    observations (x, y, t in days, z) in a results store, four expert
    locations and a 100 km prediction grid."""
    rng = np.random.default_rng(5)
    n = 250
    x = rng.uniform(-700 * KM, 700 * KM, n)
    y = rng.uniform(-700 * KM, 700 * KM, n)
    t0 = float(np.datetime64("2020-03-01").astype("datetime64[D]")
               .astype(float))
    t = t0 + rng.integers(0, 9, n).astype(float)
    z = (0.15 * np.sin(x / (300 * KM)) + 0.1 * np.cos(y / (400 * KM))
         + 0.05 * rng.standard_normal(n))
    os.makedirs(os.path.join(root, "results"))
    os.makedirs(os.path.join(root, "data", "example"))
    with ResultsStore(os.path.join(root, "results", "example_binned.h5")) as s:
        s.append("data", pd.DataFrame({"x": x, "y": y, "t": t, "z": z}))
    pd.DataFrame({"x": [-200 * KM, 200 * KM, -200 * KM, 200 * KM],
                  "y": [-200 * KM, -200 * KM, 200 * KM, 200 * KM],
                  "t": t0 + 4.0}).to_csv(
        os.path.join(root, "data", "example", "expert_locations.csv"),
        index=False)
    pd.DataFrame(utils.grid_2d_flatten([-500 * KM, 500 * KM],
                                       [-500 * KM, 500 * KM],
                                       step_size=100 * KM),
                 columns=["x", "y"]).to_csv(
        os.path.join(root, "data", "example", "prediction_locations.csv"),
        index=False)
    shutil.copy(os.path.join(REPO, "configs", "example_local_expert_oi.json"),
                os.path.join(root, "config.json"))


def test_experiment_config_file_runs_through_the_port(tmp_path, monkeypatch):
    """ExperimentConfig.from_json_file(...).run(device="cpu") on a copy of
    configs/example_local_expert_oi.json: string sources (a results store
    table, CSV files), the store at the config's path, the config stored as
    the JAX package's ExperimentConfig would build it."""
    write_example_inputs(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    exp = ExperimentConfig.from_json_file("config.json")
    exp.run(device="cpu")
    dfs, cfg = get_results_from_h5file("results/example_oi.h5")
    assert cfg[0]["data"] == JaxExperimentConfig.from_json_file(
        "config.json").data.to_dict()
    rd = dfs["run_details"]
    assert len(rd) == 4 and rd["optimise_success"].all()
    assert (rd["num_obs"] > 20).all()
    assert np.isfinite(dfs["preds"]["f*"]).all()
    # resume: the second run finds nothing left to do
    exp.run(device="cpu")
    assert len(get_results_from_h5file("results/example_oi.h5")[0]
               ["run_details"]) == 4


# ---------------------------------------------------------------------------
# the device half without pandas, h5py or jax
# ---------------------------------------------------------------------------

GUARD = textwrap.dedent("""
    import sys
    for name in ("pandas", "h5py", "jax"):
        sys.modules[name] = None          # any import of them now fails
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import gpsat_tpu_torch.local_experts as le
    from gpsat_tpu_torch.models.exact_gpr import GPRModel

    rng = np.random.default_rng(0)
    ns, ps = [5, 12, 20, 3], [4, 0, 7, 2]
    X = [rng.uniform(-5, 5, (n, 2)) for n in ns]
    obs = [np.sin(x[:, 0]) + 0.1 * rng.standard_normal(len(x)) for x in X]
    pred = [rng.uniform(-5, 5, (p, 2)) if p else None for p in ps]
    engine = le.make_engine(GPRModel, {"coords_scale": [2.0, 2.0]},
                            {"lengthscales": {"low": [1e-3] * 2,
                                              "high": [20.0] * 2}},
                            coords_dim=2, optim_kwargs={"max_iter": 30},
                            device="cpu")
    out = le.execute_buckets(engine, X, obs, pred, coords_scale=[2.0, 2.0],
                             obs_mean="local")
    assert engine.dtype == torch.float64
    assert np.isfinite(out["objective"]).all()
    for i, p in enumerate(ps):
        assert np.isfinite(out["preds"]["f*"][i, :p]).all()
    # the other model families, through the same function
    import importlib
    for m in ("ops.svgp", "ops.vff", "ops.asvgp", "models.svgp",
              "models.vff", "models.asvgp", "ops.ski", "ops.ski_structured",
              "ops.multioutput", "models.kiss_gpr", "models.multioutput"):
        importlib.import_module("gpsat_tpu_torch." + m)
    from gpsat_tpu_torch.models import get_model
    locs = np.array([x.mean(axis=0) for x in X])
    for name, init in (("SVGPModel", {"num_inducing_points": 4}),
                       ("VFFModel", {"num_inducing_features": 4,
                                     "domain_size": 12.0}),
                       ("ASVGPModel", {"num_inducing_features": 5,
                                       "domain_size": 12.0})):
        eng = le.make_engine(get_model(name),
                             dict(init, coords_scale=[2.0, 2.0]),
                             coords_dim=2, optim_kwargs={"max_iter": 20},
                             device="cpu")
        o = le.execute_buckets(eng, X, obs, pred, coords_scale=[2.0, 2.0],
                               obs_mean="local", expert_locs=locs)
        assert np.isfinite(o["objective"]).all(), name
        print("family", name, len(o["buckets"]))
    loaded = sorted(m for m, v in sys.modules.items() if v is not None and (
        m.split(".")[0] in ("pandas", "h5py", "jax", "jaxlib")
        or m == "gpsat_tpu" or m.startswith("gpsat_tpu.")))
    assert not loaded, loaded
    print("buckets", len(out["buckets"]), "experts", len(out["objective"]))
""")


def test_execute_buckets_runs_without_pandas_h5py_or_jax():
    """The card's machine has no pandas and no h5py, and the port uses no
    jax: importing gpsat_tpu_torch.local_experts and running execute_buckets
    (CPU, f64; GPRModel, then SVGPModel, VFFModel and ASVGPModel, whose
    modules are imported too, as are KISS-GP's and the multioutput models')
    must work with the three blocked, and load no module of the JAX
    package."""
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run([sys.executable, "-c", GUARD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "buckets 3 experts 4" in res.stdout
    for name in ("SVGPModel", "VFFModel", "ASVGPModel"):
        assert f"family {name} 3" in res.stdout


HOST_GUARD = textwrap.dedent("""
    import sys
    for name in ("pandas", "h5py", "matplotlib", "jax"):
        sys.modules[name] = None          # any import of them now fails
    import importlib
    import json
    import numpy as np
    import torch
    torch.set_num_threads(1)
    for m in ("postprocessing", "native", "native.build", "utils",
              "datetime_utils", "ncio", "read_and_store", "bin_data",
              "local_expert_oi", "satdata", "plot_utils"):
        importlib.import_module("gpsat_tpu_torch." + m)
    from gpsat_tpu_torch import native, utils
    from gpsat_tpu_torch import postprocessing
    from gpsat_tpu_torch.postprocessing import gaussian_2d_smooth, smooth_field

    with open("configs/example_read_and_store_raw_data.json") as f:
        cfg = json.load(f)
    names = [v["func"] for v in cfg["col_funcs"].values()
             if v["func"].startswith("gpsat_tpu.")]
    funcs = [utils._resolve_func(n) for n in names]
    assert funcs == [utils.WGS84toEASE2, utils.datetime_to_day_float], funcs

    assert native._load() is not None, "native library not loaded"
    rng = np.random.default_rng(0)
    x, y = rng.uniform(-5e5, 5e5, (2, 300))
    v = np.sin(x / 1e5)
    v[::9] = np.nan
    postprocessing.BLOCK_BYTES = 8 * len(x) * 64  # blocks of 64 rows
    got = gaussian_2d_smooth(x, y, x, y, 4e5, 4e5, v, device="cpu")
    want = native.gaussian_2d_weight(x, y, x, y, 4e5, 4e5, v)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    clamped = smooth_field(x, y, v, 4e5, 4e5, max=0.3, device="cpu")
    assert np.all(clamped <= 0.3)
    inside = native.max_dist_bool(np.stack([x, y], 1), [0.0, 0.0], 2e5)
    assert np.array_equal(inside, np.hypot(x, y) < 2e5)
    loaded = sorted(m for m, v in sys.modules.items() if v is not None and (
        m.split(".")[0] in ("pandas", "h5py", "matplotlib", "jax", "jaxlib")
        or m == "gpsat_tpu" or m.startswith("gpsat_tpu.")))
    assert not loaded, loaded
    print("resolved", names, "to", [f.__module__ for f in funcs])
""")


def test_host_modules_import_and_smooth_without_pandas_h5py_or_jax():
    """Every module of the data-preparation and post-processing slice
    imports with pandas, h5py, matplotlib and jax blocked; the config
    functions named under gpsat_tpu.utils resolve in gpsat_tpu_torch.utils;
    the smoother and the native helper run there, as on the card's machine,
    and no module of the JAX package is loaded."""
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run([sys.executable, "-c", HOST_GUARD], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "to ['gpsat_tpu_torch.utils', 'gpsat_tpu_torch.utils']" in \
        res.stdout
