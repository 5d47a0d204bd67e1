"""The port's SVGP family (gpsat_tpu_torch ops/svgp.py, BatchedSVGP,
SVGPModel, the SVGP pipeline) against the JAX package on the same numpy
inputs, on the CPU in f64.

Tolerances: the ops at 1e-10. The engine's Adam trajectories (50-300 steps)
equal the JAX engine's to rounding: the largest difference measured is
4e-11 (inducing points with train_z); the tests hold 1e-9, and the same
iterations and stopping flags exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gpsat_tpu.local_experts import LocalExpertOI as JaxLocalExpertOI
from gpsat_tpu.local_experts import get_results_from_h5file as jax_results
from gpsat_tpu.models.batched import BatchedSVGP as JaxSVGP
from gpsat_tpu.models.svgp import SVGPModel as JaxSVGPModel
from gpsat_tpu.ops import svgp as jax_svgp
from gpsat_tpu_torch.local_experts import LocalExpertOI
from gpsat_tpu_torch.local_experts import get_results_from_h5file
from gpsat_tpu_torch.models.batched import (BatchedSVGP, _epoch_order,
                                            _epoch_window)
from gpsat_tpu_torch.models.svgp import SVGPModel
from gpsat_tpu_torch.ops import svgp as svgp_math
from gpsat_tpu_torch.weights import params_from_jax, svgp_state_from_jax

# many small ops per Adam step: one thread per test worker is faster than
# every worker's intra-op pool contending for the same cores
torch.set_num_threads(1)

NAMES = ("lengthscales", "kernel_variance", "likelihood_variance")
OPS_TOL = 1e-10
TRAJ_TOL = 1e-9


def T(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def state(B=4, N=40, M=10, D=2, P=7, seed=0):
    """Random padded experts: expert 1 has masked data rows, expert 2 padded
    inducing rows; a random variational state and hyperparameters."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (B, N, D))
    y = rng.standard_normal((B, N))
    mask = np.ones((B, N), bool)
    mask[1, 30:] = False
    Z = X[:, :M].copy()
    zmask = np.ones((B, M), bool)
    zmask[2, 7:] = False
    Z[~zmask] = 0.0
    qm = 0.3 * rng.standard_normal((B, M))
    qs = np.tril(0.2 * rng.standard_normal((B, M, M))) + np.eye(M)
    params = {"lengthscales": rng.uniform(0.5, 2, (B, D)),
              "kernel_variance": rng.uniform(0.5, 2, B),
              "likelihood_variance": rng.uniform(0.05, 0.3, B)}
    Xs = rng.uniform(-2, 2, (B, P, D))
    scale = rng.uniform(1.0, 3.0, B)
    return X, y, mask, Z, zmask, qm, qs, params, Xs, scale


def jax_params(params, i):
    return {k: jnp.asarray(v[i]) for k, v in params.items()}


@pytest.mark.parametrize("kernel", ["Matern32", "Matern52", "RBF"])
def test_ops_match_jax(kernel):
    """elbo (minibatch scale per expert), natgrad_step and predict on masked
    data rows and padded inducing rows, expert by expert, at 1e-10."""
    X, y, mask, Z, zmask, qm, qs, params, Xs, scale = state()
    tp = params_from_jax(params, device="cpu")
    tqm, tqs, tZ, tzm = svgp_state_from_jax(qm, qs, Z, zmask, device="cpu")
    elbo = svgp_math.elbo(tp, tqm, tqs, T(X), T(y), T(mask, torch.bool), tZ,
                          tzm, kernel=kernel, scale=T(scale))
    m_new, L_new = svgp_math.natgrad_step(
        tp, tqm, tqs, T(X), T(y), T(mask, torch.bool), tZ, tzm, 0.3,
        kernel=kernel, scale=T(scale))
    pr = svgp_math.predict(tp, tqm, tqs, tZ, tzm, T(Xs), kernel=kernel)
    for i in range(len(X)):
        p = jax_params(params, i)
        want = jax_svgp.elbo(p, qm[i], qs[i], X[i], y[i], mask[i], Z[i],
                             zmask[i], kernel=kernel, scale=scale[i])
        np.testing.assert_allclose(float(elbo[i]), float(want), rtol=OPS_TOL)
        wm, wL = jax_svgp.natgrad_step(p, qm[i], qs[i], X[i], y[i], mask[i],
                                       Z[i], zmask[i], 0.3, kernel=kernel,
                                       scale=scale[i])
        np.testing.assert_allclose(m_new[i].numpy(), wm, atol=OPS_TOL)
        np.testing.assert_allclose(L_new[i].numpy(), wL, atol=OPS_TOL)
        wp = jax_svgp.predict(p, qm[i], qs[i], Z[i], zmask[i], Xs[i],
                              kernel=kernel)
        for k in wp:
            np.testing.assert_allclose(pr[k][i].numpy(), wp[k], atol=OPS_TOL,
                                       err_msg=k)
    # padded inducing rows stay at the prior
    assert torch.all(m_new[2, 7:] == 0)
    np.testing.assert_array_equal(
        svgp_math.make_q_sqrt(tqs, tzm)[2, 7:, 7:].numpy(), np.eye(3))


def test_elbo_gradients_match_jax():
    """Gradients of the ELBO in every argument the engine trains
    (hyperparameters, q_mu, q_sqrt_raw, Z) against jax.grad, at 1e-10."""
    X, y, mask, Z, zmask, qm, qs, params, Xs, scale = state(B=3)
    leaves = {**{k: T(v).requires_grad_(True) for k, v in params.items()},
              "qm": T(qm).requires_grad_(True),
              "qs": T(qs).requires_grad_(True),
              "Z": T(Z).requires_grad_(True)}
    e = svgp_math.elbo({k: leaves[k] for k in NAMES}, leaves["qm"],
                       leaves["qs"], T(X), T(y), T(mask, torch.bool),
                       leaves["Z"], T(zmask, torch.bool), scale=T(scale))
    grads = dict(zip(leaves, torch.autograd.grad(e.sum(),
                                                 list(leaves.values()))))
    def f(p, qmi, qsi, Zi, Xi, yi, mi, zmi, si):
        return jax_svgp.elbo(p, qmi, qsi, Xi, yi, mi, Zi, zmi, scale=si)
    gp, gqm, gqs, gZ = jax.jit(jax.vmap(jax.grad(f, argnums=(0, 1, 2, 3))))(
        {k: jnp.asarray(v) for k, v in params.items()}, qm, qs, Z, X, y, mask,
        zmask, scale)
    for k in NAMES:
        np.testing.assert_allclose(grads[k].numpy(), gp[k], rtol=OPS_TOL,
                                   atol=OPS_TOL, err_msg=k)
    for k, w in (("qm", gqm), ("qs", gqs), ("Z", gZ)):
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=OPS_TOL,
                                   atol=OPS_TOL, err_msg=k)


def workload(B=4, N=60, D=2, P=9, seed=3):
    """A smooth field plus noise, de-meaned, one ragged expert."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, (B, N, D))
    y = np.sin(X[..., 0]) + 0.3 * np.cos(X[..., 1]) \
        + 0.05 * rng.standard_normal((B, N))
    mask = np.ones((B, N), bool)
    mask[1, 45:] = False
    y = np.where(mask, y - (y * mask).sum(1, keepdims=True)
                 / mask.sum(1, keepdims=True), 0.0)
    return X, y, mask, rng.uniform(-3, 3, (B, P, D))


ENGINE_CASES = {
    "adam": {"max_iter": 50},
    "natgrad": {"max_iter": 50, "natural_gradients": True, "gamma": 0.3},
    "train_z": {"max_iter": 50, "train_inducing_points": True},
    "minibatch": {"max_iter": 60, "minibatch_size": 16,
                  "natural_gradients": True, "gamma": 0.5},
    "early_stop": {"max_iter": 400, "check_every": 5, "persistence": 20,
                   "learning_rate": 0.5},
}


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_engine_matches_jax_step_for_step(case):
    """BatchedSVGP (B=4, N=60 with a ragged expert, M=12) against the JAX
    engine from the same seeded inducing points: every output within
    TRAJ_TOL, the same iterations and converged flags. `early_stop` stops on
    the plateau rule before max_iter, at the same iteration. The port's ops
    at the JAX engine's final state give its stored ELBO."""
    X, y, mask, Xs = workload()
    opts = {"learning_rate": 5e-2, **ENGINE_CASES[case]}
    kw = dict(coords_dim=2, num_inducing_points=12)
    want = JaxSVGP(optim_kwargs=dict(opts), **kw).fit_predict(X, y, mask, Xs)
    got = BatchedSVGP(optim_kwargs=dict(opts), device="cpu", **kw) \
        .fit_predict(X, y, mask, Xs)
    for k in ("iterations", "converged", "inducing_mask"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if case == "early_stop":
        assert got["converged"].all() and got["iterations"][0] < 400
    np.testing.assert_allclose(got["objective"], want["objective"],
                               rtol=TRAJ_TOL)
    assert set(got["params"]) == set(want["params"])
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], v, atol=TRAJ_TOL,
                                   err_msg=k)
    for k, v in want["preds"].items():
        np.testing.assert_allclose(got["preds"][k], v, atol=TRAJ_TOL,
                                   err_msg=k)
    p = want["params"]
    qm, qs, Z, zm = svgp_state_from_jax(
        p["inducing_mean"], p["inducing_chol"], p["inducing_points"],
        want["inducing_mask"], device="cpu")
    elbo = svgp_math.elbo(
        params_from_jax({k: p[k] for k in NAMES}, device="cpu"), qm, qs,
        T(X), T(y), T(mask, torch.bool), Z, zm)
    np.testing.assert_allclose(elbo.numpy(), want["objective"], rtol=1e-12)


def test_reshuffle_windows_are_valid_permutations():
    """The reshuffled minibatch (its draws are torch's, not jax.random's):
    each epoch orders every expert's valid rows first, as a permutation of
    them, each window is all-valid, ragged experts too, and two epochs
    differ."""
    B, N, mb = 3, 20, 6
    mask = torch.ones(B, N, dtype=torch.bool)
    mask[1, 13:] = False
    mask[2, 5:] = False
    orders = [_epoch_order(mask, 7, e) for e in range(3)]
    for order in orders:
        for b in range(B):
            nv = int(mask[b].sum())
            assert sorted(order[b, :nv].tolist()) == list(range(nv))
        for start in range(0, N, 3):
            idx = _epoch_window(order, mask, start, mb)
            assert idx.shape == (B, mb)
            assert torch.take_along_dim(mask, idx, dim=1).all()
    assert not torch.equal(orders[0], orders[1])
    assert torch.equal(orders[0], _epoch_order(mask, 7, 0))


def test_reshuffle_converges_to_fixed_cycle():
    """As tests/test_svgp.py::test_minibatch_reshuffle_converges_to_fixed_
    cycle pins for the JAX engine: at convergence the reshuffled and the
    fixed-cycle schedules reach the same full-data ELBO within the
    minibatch noise (atol 1 nat), on a ragged expert too."""
    X, y, mask, _ = workload(B=2, N=64, seed=70)
    mask[1, 50:] = False
    opt = {"max_iter": 2000, "early_stop": False, "natural_gradients": True,
           "gamma": 0.5}
    kw = dict(coords_dim=2, num_inducing_points=12, minibatch_size=16,
              device="cpu")
    fix = BatchedSVGP(optim_kwargs=dict(opt), **kw).fit_predict(
        X, y, mask, predict=False)
    eng = BatchedSVGP(optim_kwargs=dict(opt, minibatch_reshuffle=True), **kw)
    assert eng.minibatch_reshuffle
    shuf = eng.fit_predict(X, y, mask, predict=False)
    assert np.isfinite(shuf["objective"]).all()
    np.testing.assert_allclose(shuf["objective"], fix["objective"], atol=1.0)


@pytest.mark.parametrize("natural_gradients", [False, True])
def test_svgp_model_matches_jax(natural_gradients):
    """SVGPModel (60 Adam steps, with and without natural gradients) from the
    same start as the JAX package's: parameters, variational state,
    predictions and objective within TRAJ_TOL."""
    X, y, _, Xs = workload(B=2, N=50)
    kw = dict(coords=X[0], obs=y[0], num_inducing_points=10)
    opt = dict(natural_gradients=natural_gradients, gamma=0.3,
               learning_rate=5e-2, max_iter=60)
    models = [JaxSVGPModel(**kw), SVGPModel(device="cpu", **kw)]
    for m in models:
        m.set_parameter_constraints(
            {"lengthscales": {"low": [0.01] * 2, "high": [20.0] * 2}},
            move_within_tol=True, tol=1e-2)
        m.optimise_parameters(**opt)
    want, got = (m.get_parameters() for m in models)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=TRAJ_TOL, err_msg=k)
    pw, pg = (m.predict(Xs[0]) for m in models)
    for k in pw:
        np.testing.assert_allclose(pg[k], pw[k], atol=TRAJ_TOL, err_msg=k)
    np.testing.assert_allclose(models[1].get_objective_function_value(),
                               models[0].get_objective_function_value(),
                               rtol=TRAJ_TOL)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def svgp_config(seed=5, max_iter=300, M=24, inducing_seed=42):
    """tests/test_svgp.py's orchestrated SVGP run: one expert, 300 points,
    M inducing points."""
    rng = np.random.default_rng(seed)
    n = 300
    df = pd.DataFrame({"x": rng.uniform(-50, 50, n),
                       "y": rng.uniform(-50, 50, n), "t": 0.0})
    df["z"] = np.sin(df["x"] / 20) + 0.05 * rng.standard_normal(n)
    eloc = pd.DataFrame({"x": [0.0, 10.0], "y": [0.0, -10.0], "t": [0.0, 0.0]})
    return dict(
        expert_loc_config={"source": eloc},
        data_config={"data_source": df, "obs_col": "z",
                     "coords_col": ["x", "y", "t"],
                     "local_select": [{"col": ["x", "y"], "comp": "<",
                                       "val": 60.0}]},
        model_config={"oi_model": "SVGPModel",
                      "init_params": {"coords_scale": [20, 20, 1],
                                      "num_inducing_points": M,
                                      "inducing_seed": inducing_seed},
                      "optim_kwargs": {"max_iter": max_iter}},
        pred_loc_config={"method": "expert_loc"})


def run_in(path, pkg, config, **run_kw):
    os.makedirs(path, exist_ok=True)
    store = os.path.join(path, "svgp.h5")
    oi = JaxLocalExpertOI(**config) if pkg == "jax" else \
        LocalExpertOI(device="cpu", **config)
    kw = {"store_path": store, "optimise": True,
          "check_config_compatible": False, "verbose": False, **run_kw}
    if pkg == "jax":
        kw["use_mesh"] = False
    oi.run(**kw)
    return store


@pytest.fixture(scope="module")
def svgp_stores(tmp_path_factory):
    base = tmp_path_factory.mktemp("svgp_pipeline")
    return {pkg: run_in(str(base / pkg), pkg, svgp_config())
            for pkg in ("jax", "torch")}


def key_sorted(df):
    keys = [c for c in ("x", "y", "t", "_dim_0", "_dim_1") if c in df.columns]
    return df.sort_values(keys).reset_index(drop=True)


# the two stores' largest differences (300 Adam steps, the same seeded Z):
# measured 1.0e-14 (inducing_chol), the inducing points equal; held at
# TRAJ_TOL
STORE_TOL = {"preds": TRAJ_TOL, "lengthscales": TRAJ_TOL,
             "kernel_variance": TRAJ_TOL, "likelihood_variance": TRAJ_TOL,
             "inducing_points": 0.0, "inducing_mean": TRAJ_TOL,
             "inducing_chol": TRAJ_TOL}


def test_pipeline_store_matches_jax(svgp_stores):
    """LocalExpertOI with SVGPModel writes the JAX package's store: every
    table, the variational ones (inducing_mean, inducing_chol) included."""
    got, _ = get_results_from_h5file(svgp_stores["torch"],
                                     merge_on_expert_locations=False)
    want, _ = jax_results(svgp_stores["jax"], merge_on_expert_locations=False)
    for table, tol in STORE_TOL.items():
        g, w = key_sorted(got[table]), key_sorted(want[table])
        assert list(g.columns) == list(w.columns), table
        assert len(g) == len(w) > 0, table
        for col in w.columns:
            if w[col].dtype.kind == "f":
                np.testing.assert_allclose(g[col].values, w[col].values,
                                           rtol=0, atol=tol,
                                           err_msg=f"{table}.{col}")
    assert len(got["inducing_chol"]) == 2 * 24 * 24
    g, w = (key_sorted(d["run_details"]) for d in (got, want))
    np.testing.assert_array_equal(g["optimise_iterations"],
                                  w["optimise_iterations"])
    np.testing.assert_allclose(g["objective_value"], w["objective_value"],
                               rtol=TRAJ_TOL)


def test_load_params_repredict_variational(svgp_stores, tmp_path):
    """load_params restores the whole variational state (Z, q_mu, q_sqrt):
    a reload with optimise=False and another inducing seed reproduces the
    original predictions (after tests/test_svgp.py::
    test_svgp_load_params_repredict_variational)."""
    store = str(tmp_path / "svgp.h5")
    with open(svgp_stores["torch"], "rb") as f, open(store, "wb") as g:
        g.write(f.read())
    cfg = svgp_config(inducing_seed=99)
    cfg["model_config"]["load_params"] = {"file": store, "table_suffix": ""}
    LocalExpertOI(device="cpu", **cfg).run(
        store_path=store, optimise=False, table_suffix="_RELOAD",
        check_config_compatible=False, verbose=False)
    dfs, _ = get_results_from_h5file(store, merge_on_expert_locations=False)
    a, b = key_sorted(dfs["preds"]), key_sorted(dfs["preds_RELOAD"])
    for k in ("f*", "f*_var", "y_var"):
        np.testing.assert_allclose(b[k].values, a[k].values, rtol=0,
                                   atol=1e-10, err_msg=k)
    assert not dfs["run_details_RELOAD"]["parameters_optimised"].any()
