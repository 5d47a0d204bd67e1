"""The port's pipeline entry point (gpsat_tpu_torch LocalExpertOI) against the
JAX package's on the same inputs, on the CPU in f64: the golden inputs of
tests/test_golden_regression.py, the committed golden store, the run
behaviours of tests/test_local_experts.py, and the SGPR branch.

Each scenario runs once per package in a module-scoped fixture, each package
into its own directory under the same relative store path, so the stored
oi_config of the two runs can be compared byte for byte.
"""

import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from gpsat_tpu.dataprepper import DataPrep as JaxDataPrep
from gpsat_tpu.local_experts import LocalExpertOI as JaxLocalExpertOI
from gpsat_tpu.local_experts import get_results_from_h5file as jax_results
from gpsat_tpu.utils import grid_2d_flatten as jax_grid_2d_flatten
from gpsat_tpu_torch.dataprepper import DataPrep
from gpsat_tpu_torch.local_experts import LocalExpertOI
from gpsat_tpu_torch.local_experts import get_results_from_h5file
from gpsat_tpu_torch.utils import grid_2d_flatten

# many small ops per L-BFGS iteration: one thread per test worker is faster
# than every worker's intra-op pool contending for the same cores
torch.set_num_threads(1)

KM = 1000.0
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_inline.h5")
STORE = "oi.h5"
PKGS = ("jax", "torch")
TABLES = ("preds", "run_details", "lengthscales", "kernel_variance",
          "likelihood_variance", "expert_locs")
KEY_COLS = ("x", "y", "t", "_dim_0", "_dim_1", "pred_loc_x", "pred_loc_y",
            "pred_loc_t")
# run_time is a wall time; model names the package's own class
SKIP_COLS = {"run_time", "model"}

# The golden inputs, run to convergence: the largest differences between the
# two packages' stores, measured on the CPU (PERF.md, section 6):
# f* 1.45e-6, f*_var 3.5e-9, y_var 6.8e-9, objective 7.5e-7, lengthscales
# 1.06e-3, kernel_variance 2.0e-5, likelihood_variance 6.6e-9, and 2 of the 4
# experts end 2 and 8 L-BFGS iterations apart. The trajectories agree to
# 2e-11 for 20 iterations and part from there by rounding alone, which the
# flat surface amplifies (one lengthscale at its upper bound, the time
# lengthscale without any gradient): see test_golden_slice_step_for_step.
# Tolerances: about seven times the measured differences.
CONVERGED_TOL = {"preds": 1e-5, "run_details": 1e-5, "lengthscales": 7e-3,
                 "kernel_variance": 2e-4, "likelihood_variance": 1e-7,
                 "expert_locs": 0.0}


def golden_inputs(pkg):
    """tests/test_golden_regression.py's inputs, built with the package's own
    DataPrep and grid helper."""
    dataprep, grid = {"jax": (JaxDataPrep, jax_grid_2d_flatten),
                      "torch": (DataPrep, grid_2d_flatten)}[pkg]
    rng = np.random.default_rng(1234)
    n = 2000
    x = rng.uniform(-400 * KM, 400 * KM, n)
    y = rng.uniform(-400 * KM, 400 * KM, n)
    z = (0.3 * np.sin(x / (150 * KM)) + 0.2 * np.cos(y / (200 * KM))
         + 0.05 * rng.standard_normal(n))
    df = pd.DataFrame({"x": x, "y": y, "z": z, "t": 0.0})
    bin_df = dataprep.bin_data_by(
        df=df, by_cols=["t"], val_col="z", grid_res=50 * KM,
        x_range=[-400 * KM, 400 * KM],
        y_range=[-400 * KM, 400 * KM]).to_dataframe().dropna().reset_index()
    eloc = pd.DataFrame(grid([-300 * KM, 300 * KM], [-300 * KM, 300 * KM],
                             step_size=300 * KM), columns=["x", "y"])
    eloc["t"] = 0.0
    ploc = pd.DataFrame(grid([-300 * KM, 300 * KM], [-300 * KM, 300 * KM],
                             step_size=100 * KM), columns=["x", "y"])
    return bin_df, eloc, ploc


def golden_config(pkg, model=None):
    bin_df, eloc, ploc = golden_inputs(pkg)
    model = model or {
        "oi_model": "GPRModel",
        "init_params": {"coords_scale": [50 * KM, 50 * KM, 1]},
        "constraints": {
            "lengthscales": {"low": [1e-08] * 3,
                             "high": [600 * KM, 600 * KM, 9]},
            "likelihood_variance": {"low": 1e-4, "high": 0.1}}}
    return dict(
        expert_loc_config={"source": eloc},
        data_config={"data_source": bin_df, "obs_col": "z",
                     "coords_col": ["x", "y", "t"],
                     "local_select": [
                         {"col": "t", "comp": "<=", "val": 4},
                         {"col": "t", "comp": ">=", "val": -4},
                         {"col": ["x", "y"], "comp": "<", "val": 250 * KM}]},
        model_config=model,
        pred_loc_config={"method": "from_dataframe", "df": ploc,
                         "max_dist": 200 * KM})


def make_oi(pkg, **config):
    if pkg == "jax":
        return JaxLocalExpertOI(**config)
    return LocalExpertOI(device="cpu", **config)


def run_oi(pkg, store, **config_and_run):
    run_kw = config_and_run.pop("run", {})
    oi = make_oi(pkg, **config_and_run)
    kw = {"store_path": store, "optimise": True,
          "check_config_compatible": False, "verbose": False, **run_kw}
    if pkg == "jax":
        kw["use_mesh"] = False
    oi.run(**kw)
    return oi


def read(pkg, path, **kw):
    reader = jax_results if pkg == "jax" else get_results_from_h5file
    return reader(path, merge_on_expert_locations=False, **kw)


def run_both(tmp_path_factory, name, config_fn, **run_kw):
    """Run a scenario in each package, each in its own directory with the
    store at the same relative path. Returns {pkg: store path}."""
    paths = {}
    for pkg in PKGS:
        d = tmp_path_factory.mktemp(f"{name}_{pkg}")
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(d)
            run_oi(pkg, STORE, run=run_kw, **config_fn(pkg))
        paths[pkg] = str(d / STORE)
    return paths


def sorted_table(df):
    keys = [c for c in KEY_COLS if c in df.columns]
    return df.sort_values(keys).reset_index(drop=True)


def assert_tables_close(got, want, tol, tables=TABLES, skip=SKIP_COLS):
    """Every column of every table: numbers within tol[table], other
    columns equal."""
    for table in tables:
        assert table in got and table in want, table
        g, w = sorted_table(got[table]), sorted_table(want[table])
        assert list(g.columns) == list(w.columns), table
        assert len(g) == len(w), f"{table}: {len(g)} rows, want {len(w)}"
        for col in w.columns:
            if col in skip:
                continue
            gv, wv = g[col].values, w[col].values
            if wv.dtype.kind in "fiu":
                np.testing.assert_allclose(
                    np.asarray(gv, float), np.asarray(wv, float), rtol=0,
                    atol=tol[table] if isinstance(tol, dict) else tol,
                    err_msg=f"{table}.{col}")
            else:
                assert (gv == wv).all(), f"{table}.{col}: values differ"


# ---------------------------------------------------------------------------
# the whole slice on the golden inputs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    return run_both(tmp_path_factory, "golden", golden_config)


@pytest.fixture(scope="module")
def golden_capped(tmp_path_factory):
    """The golden inputs stopped at 20 L-BFGS iterations an expert, before
    rounding parts the two packages' trajectories."""
    def config(pkg):
        cfg = golden_config(pkg)
        cfg["model_config"]["optim_kwargs"] = {"max_iter": 20}
        return cfg
    return run_both(tmp_path_factory, "capped", config)


def test_golden_inputs_are_the_same():
    for got, want in zip(golden_inputs("torch"), golden_inputs("jax")):
        pd.testing.assert_frame_equal(got, want)


def test_golden_slice_step_for_step(golden_capped):
    """20 L-BFGS iterations an expert: every table within 1e-9, the same
    iterations and flags, the same oi_config."""
    got, got_cfg = read("torch", golden_capped["torch"])
    want, want_cfg = read("jax", golden_capped["jax"])
    assert got_cfg == want_cfg
    assert (want["run_details"]["optimise_iterations"] == 20).all()
    assert_tables_close(got, want, 1e-9)


def test_golden_slice_matches_jax(golden):
    """Run to convergence: the stores agree within CONVERGED_TOL (the
    golden test's 1e-6 and 1e-3 for lengthscales do not hold: see
    CONVERGED_TOL), and the stored oi_config is the JAX package's."""
    got, got_cfg = read("torch", golden["torch"])
    want, want_cfg = read("jax", golden["jax"])
    assert got_cfg == want_cfg
    assert sorted(got) == sorted(want)
    assert want["run_details"]["optimise_success"].all()
    assert_tables_close(got, want, CONVERGED_TOL,
                        skip=SKIP_COLS | {"optimise_iterations"})
    iters = [sorted_table(d["run_details"])["optimise_iterations"].values
             for d in (got, want)]
    assert np.abs(iters[0] - iters[1]).max() <= 16, iters


def test_golden_oi_config_is_the_jax_packages_byte_for_byte(golden):
    from gpsat_tpu_torch.store import ResultsStore
    raw = {}
    for pkg, path in golden.items():
        with ResultsStore(path, mode="r") as store:
            raw[pkg] = list(store.select("oi_config")["config"].values)
    assert raw["torch"] == raw["jax"]


def test_replay_against_committed_golden(golden):
    """The port's single-device replay against tests/data/golden_inline.h5
    (the JAX package's, from an 8-device CPU mesh), read through the port's
    reader, at the tolerance measured for the port (CONVERGED_TOL)."""
    got, _ = read("torch", golden["torch"])
    want, want_cfg = read("torch", GOLDEN)
    assert want_cfg and want_cfg[0]["model"]["oi_model"] == "GPRModel"
    assert_tables_close(got, want, CONVERGED_TOL,
                        skip=SKIP_COLS | {"optimise_iterations", "device"})


# ---------------------------------------------------------------------------
# run behaviours, in each package (tests/test_local_experts.py:86-350)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_store_schema(golden, pkg):
    dfs, oi_config = read(pkg, golden[pkg])
    for t in ["preds", "run_details", "expert_locs", "lengthscales",
              "kernel_variance", "likelihood_variance", "oi_config"]:
        assert t in dfs, f"missing table: {t} (have: {list(dfs)})"
    assert oi_config[0]["data"]["coords_col"] == ["x", "y", "t"]
    assert oi_config[0]["run_kwargs"]["store_path"] == STORE
    rd = dfs["run_details"]
    assert len(rd) == 4
    assert (rd["device"] == "cpu:cpu").all()
    assert (rd["config_id"] == 1).all()
    assert set(rd.columns) == {"x", "y", "t", "num_obs", "run_time",
                               "optimise_iterations", "objective_value",
                               "parameters_optimised", "optimise_success",
                               "model", "device", "config_id"}
    preds = dfs["preds"]
    assert set(preds.columns) == {"x", "y", "t", "_dim_0", "f*", "f*_var",
                                  "y_var", "f_bar", "pred_loc_x",
                                  "pred_loc_y", "pred_loc_t"}
    assert (preds["f*_var"] >= 0).all()
    assert (preds["y_var"] >= preds["f*_var"]).all()
    assert set(dfs["lengthscales"]["_dim_0"]) == {0, 1, 2}


@pytest.mark.parametrize("pkg", PKGS)
def test_resume_skips_completed(golden, pkg, tmp_path, capsys):
    store = str(tmp_path / "resume.h5")
    shutil.copy(golden[pkg], store)
    run_oi(pkg, store, **golden_config(pkg))
    assert "no new expert locations to run" in capsys.readouterr().out
    dfs, cfg = read(pkg, store)
    assert len(dfs["run_details"]) == 4
    assert len(cfg) == 2    # the store path entered the config: a new id


@pytest.fixture(scope="module")
def reloaded(golden, tmp_path_factory):
    """optimise=False with load_params from each package's golden store, into
    a copy of that store (table_suffix _RELOAD)."""
    out = {}
    for pkg in PKGS:
        store = str(tmp_path_factory.mktemp(f"reload_{pkg}") / STORE)
        shutil.copy(golden[pkg], store)
        cfg = golden_config(pkg)
        cfg["model_config"]["load_params"] = {"file": store,
                                              "table_suffix": ""}
        run_oi(pkg, store, run={"optimise": False, "table_suffix": "_RELOAD"},
               **cfg)
        out[pkg] = store
    return out


@pytest.mark.parametrize("pkg", PKGS)
def test_load_params_repredict(reloaded, pkg):
    """Loaded parameters re-predict the original predictions."""
    dfs, _ = read(pkg, reloaded[pkg])
    assert "preds_RELOAD" in dfs and "run_details_RELOAD" in dfs
    # same file, same suffix rule as the reference: parameters are stored
    # again under the new suffix
    assert "lengthscales_RELOAD" in dfs
    assert not dfs["run_details_RELOAD"]["parameters_optimised"].any()
    a, b = sorted_table(dfs["preds"]), sorted_table(dfs["preds_RELOAD"])
    for k in ("f*", "f*_var", "y_var"):
        np.testing.assert_allclose(a[k].values, b[k].values, rtol=0,
                                   atol=1e-8, err_msg=k)


def test_load_params_repredict_matches_jax(reloaded):
    """The re-prediction stores agree as the converged runs they reload do;
    the objective there is the NLML at the loaded parameters."""
    got, _ = read("torch", reloaded["torch"], table_suffix="_RELOAD")
    want, _ = read("jax", reloaded["jax"], table_suffix="_RELOAD")
    tables = [t + "_RELOAD" for t in TABLES[:-1]]
    tol = {t + "_RELOAD": v for t, v in CONVERGED_TOL.items()}
    assert_tables_close(got, want, tol, tables=tables)


def small_config(pkg, eloc, pred_loc_config=None, seed=0, n=50):
    """tests/test_local_experts.py's small scenarios: n points, default
    GPRModel, one radius condition of 50."""
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({"x": rng.uniform(-10, 10, n),
                       "y": rng.uniform(-10, 10, n),
                       "z": rng.standard_normal(n), "t": 0.0})
    cfg = dict(expert_loc_config={"source": eloc},
               data_config={"data_source": df, "obs_col": "z",
                            "coords_col": ["x", "y", "t"],
                            "local_select": [{"col": ["x", "y"], "comp": "<",
                                              "val": 50}]},
               model_config={"oi_model": "GPRModel"})
    if pred_loc_config is not None:
        cfg["pred_loc_config"] = pred_loc_config
    return cfg


@pytest.fixture(scope="module")
def min_obs_runs(tmp_path_factory):
    eloc = pd.DataFrame({"x": [0.0, 1000.0], "y": [0.0, 1000.0], "t": 0.0})
    return run_both(tmp_path_factory, "min_obs", lambda pkg: small_config(
        pkg, eloc, {"method": "expert_loc"}))


@pytest.mark.parametrize("pkg", PKGS)
def test_min_obs_skip_recorded(min_obs_runs, pkg):
    dfs, _ = read(pkg, min_obs_runs[pkg])
    rd = dfs["run_details"].set_index("x")
    assert rd.loc[0.0, "num_obs"] == 50
    assert rd.loc[1000.0, "num_obs"] == 0
    assert not rd.loc[1000.0, "optimise_success"]
    assert np.isnan(rd.loc[1000.0, "objective_value"])
    assert rd.loc[1000.0, "device"] == ""
    assert len(dfs["preds"]) == 1


@pytest.fixture(scope="module")
def default_pred_runs(tmp_path_factory):
    eloc = pd.DataFrame({"x": [0.0, 5.0], "y": [0.0, -5.0], "t": 0.0})
    return run_both(tmp_path_factory, "default_pred",
                    lambda pkg: small_config(pkg, eloc, seed=1, n=60))


@pytest.mark.parametrize("pkg", PKGS)
def test_default_pred_loc_is_expert_loc(default_pred_runs, pkg):
    dfs, cfg = read(pkg, default_pred_runs[pkg])
    assert cfg[0]["pred_loc"] == {}
    preds = dfs["preds"].set_index("x")
    assert len(preds) == 2
    for x, y in ((0.0, 0.0), (5.0, -5.0)):
        assert preds.loc[x, "pred_loc_x"] == x
        assert preds.loc[x, "pred_loc_y"] == y
    assert dfs["run_details"]["optimise_success"].all()


@pytest.fixture(scope="module")
def zero_pred_runs(tmp_path_factory):
    eloc = pd.DataFrame({"x": [0.0, 8.0], "y": [0.0, 8.0], "t": 0.0})
    ploc = pd.DataFrame({"x": [0.0, 1.0], "y": [0.0, 1.0]})
    return run_both(tmp_path_factory, "zero_pred", lambda pkg: small_config(
        pkg, eloc, {"method": "from_dataframe", "df": ploc, "max_dist": 3.0},
        seed=2, n=60))


@pytest.mark.parametrize("pkg", PKGS)
def test_zero_pred_loc_recorded(zero_pred_runs, pkg, tmp_path):
    dfs, _ = read(pkg, zero_pred_runs[pkg])
    rd = dfs["run_details"].set_index("x")
    assert len(rd) == 2
    assert np.isnan(rd.loc[8.0, "objective_value"])
    assert not rd.loc[8.0, "optimise_success"]
    assert len(dfs["preds"]) == 2 and (dfs["preds"]["x"] == 0.0).all()
    # resume: nothing left to run
    store = str(tmp_path / "s.h5")
    shutil.copy(zero_pred_runs[pkg], store)
    eloc = pd.DataFrame({"x": [0.0, 8.0], "y": [0.0, 8.0], "t": 0.0})
    ploc = pd.DataFrame({"x": [0.0, 1.0], "y": [0.0, 1.0]})
    run_oi(pkg, store, **small_config(
        pkg, eloc, {"method": "from_dataframe", "df": ploc, "max_dist": 3.0},
        seed=2, n=60))
    assert len(read(pkg, store)[0]["run_details"]) == 2


@pytest.mark.parametrize("scenario", ["min_obs", "default_pred", "zero_pred"])
def test_small_scenarios_match_jax(scenario, min_obs_runs, default_pred_runs,
                                   zero_pred_runs):
    """The skip records equal, and the runs agree loosely: 50-60 standard
    normal observations leave a flat likelihood, where the two packages'
    trajectories part by rounding (measured on the CPU: objective up to
    rel 5.5e-5, predictions up to 5.1e-4, lengthscales up to 126 apart), so
    objective rtol 5e-4 and predictions atol 5e-3."""
    paths = {"min_obs": min_obs_runs, "default_pred": default_pred_runs,
             "zero_pred": zero_pred_runs}[scenario]
    (got, got_cfg), (want, want_cfg) = (read(p, paths[p])
                                        for p in ("torch", "jax"))
    assert got_cfg == want_cfg
    assert_tables_close(got, want, {"preds": 5e-3, "run_details": 0.0,
                                    "expert_locs": 0.0},
                        tables=("preds", "run_details", "expert_locs"),
                        skip=SKIP_COLS | {"optimise_iterations",
                                          "objective_value"})
    a, b = (sorted_table(d["run_details"])["objective_value"].values
            for d in (got, want))
    np.testing.assert_allclose(a, b, rtol=5e-4)


# ---------------------------------------------------------------------------
# the SGPR branch
# ---------------------------------------------------------------------------

SGPR_MODEL = {
    "oi_model": "SGPRModel",
    "init_params": {"coords_scale": [50 * KM, 50 * KM, 1],
                    "num_inducing_points": 24},
    "constraints": {
        "lengthscales": {"low": [1e-08] * 3, "high": [250 * KM, 250 * KM, 5]},
        "likelihood_variance": {"low": 1e-4, "high": 0.1}}}


@pytest.fixture(scope="module")
def sgpr_golden(tmp_path_factory):
    return run_both(tmp_path_factory, "sgpr", lambda pkg: golden_config(
        pkg, model={k: dict(v) if isinstance(v, dict) else v
                    for k, v in SGPR_MODEL.items()}))


def test_sgpr_slice_matches_jax(sgpr_golden):
    """SGPRModel through both pipelines at M=24 (80 observations an expert):
    the same seeded inducing points, and the converged runs, lengthscales
    bounded at 5, at the port's SGPR parity tolerances
    (tests/test_torch_sgpr_engine.py::test_pool_sweep_converges_to_the_jax_optima):
    ELBO rtol 1e-4, parameters atol 1e-2, predictions atol 1e-3."""
    got, got_cfg = read("torch", sgpr_golden["torch"])
    want, want_cfg = read("jax", sgpr_golden["jax"])
    assert got_cfg == want_cfg
    assert "inducing_points" in got and "inducing_points" in want
    assert want["run_details"]["optimise_success"].all()
    assert got["run_details"]["optimise_success"].all()
    assert_tables_close(got, want, 0.0, tables=("inducing_points",
                                                 "expert_locs"))
    assert len(got["inducing_points"]) == 4 * 24 * 3
    assert_tables_close(got, want, {"preds": 1e-3, "lengthscales": 1e-2,
                                    "kernel_variance": 1e-2,
                                    "likelihood_variance": 1e-2,
                                    "run_details": 0.0},
                        tables=TABLES[:-1],
                        skip=SKIP_COLS | {"optimise_iterations",
                                          "objective_value"})
    a, b = (sorted_table(d["run_details"])["objective_value"].values
            for d in (got, want))
    np.testing.assert_allclose(a, b, rtol=1e-4)


@pytest.fixture(scope="module")
def sgpr_trained_z(tmp_path_factory):
    """SGPRModel with trainable inducing points (stopped at 20 L-BFGS
    iterations), then in each package a load_params re-predict of its own
    store with optimise=False and another inducing seed (table_suffix
    _RELOAD)."""
    def config(pkg, seed=42):
        model = {k: dict(v) if isinstance(v, dict) else v
                 for k, v in SGPR_MODEL.items()}
        model["init_params"]["inducing_seed"] = seed
        model["optim_kwargs"] = {"max_iter": 20,
                                 "train_inducing_points": True}
        return golden_config(pkg, model=model)
    stores = run_both(tmp_path_factory, "sgpr_trained_z", config)
    for pkg, store in stores.items():
        cfg = config(pkg, seed=99)
        cfg["model_config"]["load_params"] = {"file": store,
                                              "table_suffix": ""}
        run_oi(pkg, store, run={"optimise": False, "table_suffix": "_RELOAD"},
               **cfg)
    return stores


def test_sgpr_load_params_reloads_trained_inducing_points(sgpr_trained_z):
    """load_params restores an SGPR expert's stored inducing points: the
    re-predict with another inducing seed reproduces the original
    predictions (the trained Z differs from either seed's selection), in
    the port as in the JAX package, and the two packages' re-predictions
    agree as their first runs do (measured 1.2e-13 apart, held at 1e-10)."""
    got, _ = read("torch", sgpr_trained_z["torch"])
    want, _ = read("jax", sgpr_trained_z["jax"])
    for dfs in (got, want):
        assert not dfs["run_details_RELOAD"]["parameters_optimised"].any()
        a, b = sorted_table(dfs["preds"]), sorted_table(dfs["preds_RELOAD"])
        for k in ("f*", "f*_var", "y_var"):
            np.testing.assert_allclose(b[k].values, a[k].values, rtol=0,
                                       atol=1e-10, err_msg=k)
    g, w = (sorted_table(d["preds_RELOAD"]) for d in (got, want))
    for k in ("f*", "f*_var", "y_var"):
        np.testing.assert_allclose(g[k].values, w[k].values, rtol=0,
                                   atol=1e-10, err_msg=k)


# ---------------------------------------------------------------------------
# the device of the entry points
# ---------------------------------------------------------------------------

def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """Without a card, LocalExpertOI and ExperimentConfig.run raise unless
    given device="cpu"; the device never enters the stored config."""
    from gpsat_tpu_torch.config_dataclasses import ExperimentConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = golden_config("torch")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalExpertOI(**cfg)
    exp = ExperimentConfig.from_dict({
        "data": cfg["data_config"], "model": cfg["model_config"],
        "locations": cfg["expert_loc_config"],
        "pred_loc": cfg["pred_loc_config"],
        "run_kwargs": {"store_path": str(tmp_path / "e.h5")}})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        exp.run()
    oi = LocalExpertOI(device="cpu", **cfg)
    assert oi.device == torch.device("cpu")
    assert "device" not in repr(oi.config)
