"""The port's VFF and ASVGP families (gpsat_tpu_torch ops/vff.py,
ops/asvgp.py, BatchedVFF, BatchedASVGP, VFFModel, ASVGPModel, the VFF
pipeline) against the JAX package on the same numpy inputs, on the CPU in
f64; and the model names of get_model and make_engine.

Tolerances: the ops at 1e-10. The engines' L-BFGS runs (pool and chunked,
up to 100 iterations) equal the JAX engines' to rounding, with the same
iterations and converged flags: objectives within 1e-9 (relative); along
the flat directions of the bound the hyperparameters part by up to 1.9e-8
(relative) and the predictions by 5.5e-9, held at 1e-7 and 2e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gpsat_tpu.local_experts import LocalExpertOI as JaxLocalExpertOI
from gpsat_tpu.local_experts import get_results_from_h5file as jax_results
from gpsat_tpu.models import get_model as jax_get_model
from gpsat_tpu.models.batched import BatchedASVGP as JaxASVGP
from gpsat_tpu.models.batched import BatchedVFF as JaxVFF
from gpsat_tpu.ops import asvgp as jax_asvgp
from gpsat_tpu.ops import vff as jax_vff
from gpsat_tpu_torch import local_experts as le
from gpsat_tpu_torch.local_experts import LocalExpertOI
from gpsat_tpu_torch.local_experts import get_results_from_h5file
from gpsat_tpu_torch.models import batched, get_model
from gpsat_tpu_torch.ops import asvgp as asvgp_math
from gpsat_tpu_torch.ops import vff as vff_math
from gpsat_tpu_torch.weights import params_from_jax, vff_domains_from_jax

# many small ops per L-BFGS iteration: one thread per test worker is faster
# than every worker's intra-op pool contending for the same cores
torch.set_num_threads(1)

NAMES = ("lengthscales", "kernel_variance", "likelihood_variance")
KERNELS = ("Matern12", "Matern32", "Matern52")
OPS_TOL = 1e-10
RUN_TOL = 1e-9
PARAM_RTOL = 1e-7
PRED_ATOL = 2e-8
# family: (JAX ops, port ops, features per dimension of the D=2 tests)
FAMILIES = {"vff": (jax_vff, vff_math, (5, 4)),
            "asvgp": (jax_asvgp, asvgp_math, (7, 6))}


def T(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def state(B=3, N=40, D=2, P=7, seed=0):
    """Random experts (expert 1 with masked rows, some of them outside the
    box) with per-dimension variances, their boxes and prediction points."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (B, N, D))
    y = rng.standard_normal((B, N))
    mask = np.ones((B, N), bool)
    mask[1, 30:] = False
    X[1, 35:] = 5.0
    params = {"lengthscales": rng.uniform(0.5, 2, (B, D)),
              "kernel_variance": rng.uniform(0.5, 2, (B, D)),
              "likelihood_variance": rng.uniform(0.05, 0.3, B)}
    a = X[:, :30].min(axis=1) - 0.1
    b = X[:, :30].max(axis=1) + 0.1
    return X, y, mask, params, a, b, rng.uniform(-2.5, 2.5, (B, P, D))


def jax_params(params, i):
    return {k: jnp.asarray(v[i]) for k, v in params.items()}


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("kernel", KERNELS)
def test_kuu_kuf_match_jax(family, kernel):
    """Per-dimension Kuu and Kuf (points inside and outside the box),
    batched over experts, against the JAX functions expert by expert."""
    jm, tm, ms = FAMILIES[family]
    X, _, _, params, a, b, _ = state()
    m = ms[0]
    ls, kv = params["lengthscales"][:, 0], params["kernel_variance"][:, 0]
    ta, tb = vff_domains_from_jax(a[:, 0], b[:, 0], device="cpu")
    kuu = tm.kuu_dense(kernel, T(ls), T(kv), ta, tb, m, jitter=1e-6)
    x = np.concatenate([X[:, :, 0], a[:, :1] - 0.7, b[:, :1] + 0.4], axis=1)
    if family == "vff":
        kuf = tm.kuf(kernel, T(ls), T(x), ta, tb, m)
    else:
        kuf = tm.kuf(kernel, T(x), ta, tb, m)
    for i in range(len(X)):
        want = jm.kuu_dense(kernel, ls[i], kv[i], a[i, 0], b[i, 0], m,
                            jitter=1e-6)
        np.testing.assert_allclose(kuu[i].numpy(), want, rtol=OPS_TOL,
                                   atol=OPS_TOL)
        want = jm.kuf(kernel, ls[i], x[i], a[i, 0], b[i, 0], m) \
            if family == "vff" else jm.kuf(kernel, x[i], a[i, 0], b[i, 0], m)
        np.testing.assert_allclose(kuf[i].numpy(), want, rtol=OPS_TOL,
                                   atol=OPS_TOL)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("kernel", KERNELS)
def test_elbo_and_predict_match_jax(family, kernel):
    """The collapsed bound and the posterior of masked padded experts (D=2,
    Kronecker features) against the JAX functions expert by expert."""
    jm, tm, ms = FAMILIES[family]
    X, y, mask, params, a, b, Xs = state()
    tp = params_from_jax(params, device="cpu")
    ta, tb = vff_domains_from_jax(a, b, device="cpu")
    elbo = tm.elbo(tp, T(X), T(y), T(mask, torch.bool), ta, tb, ms, kernel)
    pr = tm.predict(tp, T(X), T(y), T(mask, torch.bool), T(Xs), ta, tb, ms,
                    kernel)
    for i in range(len(X)):
        p = jax_params(params, i)
        want = jm.elbo(p, X[i], y[i], mask[i], a[i], b[i], ms, kernel)
        np.testing.assert_allclose(float(elbo[i]), float(want), rtol=OPS_TOL)
        wp = jm.predict(p, X[i], y[i], mask[i], Xs[i], a[i], b[i], ms, kernel)
        for k in wp:
            np.testing.assert_allclose(pr[k][i].numpy(), wp[k], rtol=OPS_TOL,
                                       atol=OPS_TOL, err_msg=k)


@pytest.mark.parametrize("family", FAMILIES)
def test_elbo_gradients_match_jax(family):
    """Gradients of the bound in the hyperparameters (per-dimension
    lengthscales and variances) against jax.grad."""
    jm, tm, ms = FAMILIES[family]
    X, y, mask, params, a, b, _ = state()
    leaves = {k: T(v).requires_grad_(True) for k, v in params.items()}
    e = tm.elbo(leaves, T(X), T(y), T(mask, torch.bool), T(a), T(b), ms)
    grads = dict(zip(leaves, torch.autograd.grad(e.sum(),
                                                 list(leaves.values()))))
    g = jax.jit(jax.vmap(jax.grad(lambda p, *args: jm.elbo(p, *args, ms))))(
        {k: jnp.asarray(v) for k, v in params.items()}, X, y, mask, a, b)
    for k in NAMES:
        np.testing.assert_allclose(grads[k].numpy(), g[k], rtol=OPS_TOL,
                                   atol=OPS_TOL, err_msg=k)


@pytest.mark.parametrize("family", FAMILIES)
def test_f32_stays_f32(family):
    """f32 inputs give f32 everywhere (the JAX package pins the same after
    its f64-leak fixes, tests/test_vff.py::test_vff_f32_stays_f32 and
    tests/test_asvgp.py::test_asvgp_f32_stays_f32): the ops, and an engine
    built with dtype float32."""
    _, tm, ms = FAMILIES[family]
    X, y, mask, params, a, b, Xs = state()
    f32 = torch.float32
    tp = {k: T(v, f32) for k, v in params.items()}
    args = (T(X, f32), T(y, f32), T(mask, torch.bool))
    assert tm.elbo(tp, *args, T(a, f32), T(b, f32), ms).dtype == f32
    pr = tm.predict(tp, *args, T(Xs, f32), T(a, f32), T(b, f32), ms)
    assert all(v.dtype == f32 for v in pr.values())
    assert tm.kuu_dense("Matern32", T(1.0, f32), T(1.0, f32), T(0.0, f32),
                        T(6.0, f32), ms[0]).dtype == f32
    engine = (batched.BatchedVFF if family == "vff" else
              batched.BatchedASVGP)(coords_dim=2, num_inducing_features=ms[0],
                                    dtype="float32", device="cpu",
                                    optim_kwargs={"max_iter": 5})
    out = engine.fit_predict(X, y, mask, Xs)
    assert out["objective"].dtype == np.float32
    assert all(v.dtype == np.float32 for v in out["params"].values())
    assert all(v.dtype == np.float32 for v in out["preds"].values())


def workload(B=5, N=60, D=2, P=9, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, (B, N, D))
    y = np.sin(X[..., 0]) + 0.3 * np.cos(X[..., 1]) \
        + 0.05 * rng.standard_normal((B, N))
    mask = np.ones((B, N), bool)
    mask[1, 45:] = False
    y = np.where(mask, y - (y * mask).sum(1, keepdims=True)
                 / mask.sum(1, keepdims=True), 0.0)
    return X, y, mask, rng.uniform(-3, 3, (B, P, D))


ENGINES = {"vff": (JaxVFF, batched.BatchedVFF, 5),
           "asvgp": (JaxASVGP, batched.BatchedASVGP, 6)}


@pytest.mark.parametrize("path", ["pool", "chunked"])
@pytest.mark.parametrize("family", ENGINES)
def test_engine_matches_jax(family, path):
    """BatchedVFF / BatchedASVGP against the JAX engines through the L-BFGS
    pool (2 slots for 5 experts) and through the chunked path, with boxes of
    +-4 about given expert locations: every output within RUN_TOL, the same
    iterations and converged flags."""
    J, Tcls, m = ENGINES[family]
    X, y, mask, Xs = workload()
    kw = dict(coords_dim=2, num_inducing_features=m, domain_size=4.0,
              optim_kwargs={"max_iter": 100})
    el = 0.9 * X.mean(axis=1)
    engines = [J(**kw), Tcls(device="cpu", **kw)]
    engines[0]._expert_locs_scaled = el
    slots = 2 if path == "pool" else None
    want = engines[0].fit_predict_many(X, y, mask, Xs, slots=slots)
    got = engines[1].fit_predict_many(X, y, mask, Xs, slots=slots,
                                      expert_locs=el)
    pool_iters = [getattr(e, "_last_pool_iterations", 0) for e in engines]
    assert pool_iters[1] == pool_iters[0]
    assert (pool_iters[1] > 0) == (path == "pool")
    for k in ("iterations", "converged"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["converged"].all()
    np.testing.assert_allclose(got["objective"], want["objective"],
                               rtol=RUN_TOL)
    for part, rtol, atol in (("params", PARAM_RTOL, RUN_TOL),
                             ("preds", RUN_TOL, PRED_ATOL)):
        assert set(got[part]) == set(want[part])
        for k, v in want[part].items():
            np.testing.assert_allclose(got[part][k], v, rtol=rtol, atol=atol,
                                       err_msg=k)


def test_f32_asvgp_runs_to_the_bounds_on_the_bench_vff_inputs():
    """The first four experts of the bench `vff` workload (N=1000, D=2)
    through BatchedASVGP at m=19 with the bench configuration. In f32 the
    L-BFGS of either package stops some experts with every lengthscale on
    its bound of 50 and the noise on its bound of 1e-5, where the ELBO it
    reports is off the f64 bound at the same parameters by more than 100 %
    (measured on the CPU: the JAX engine three of the four, the port's two;
    the port's f32 engine inherits the fault and does not add it). The f64
    engine ends every expert inside the bounds, its ELBO equal to the f64
    evaluation to 1e-10. This is why the card's smoke test holds that cell
    in f64."""
    from gpsat_tpu_torch.profile_sweep import (_bench_common, bench_vff_engine,
                                               workload)
    X, y, mask, Xs = workload(128, 1000, 400, 2)
    X, y, mask, Xs = X[:4], y[:4], mask[:4], Xs[:4, :4]
    a, b = T(X.min(axis=1) - 1e-8), T(X.max(axis=1) + 1e-8)

    def run(engine):
        """(at the bounds [E], relative ELBO gap to f64 [E])."""
        out = engine.fit_predict_many(X, y, mask, Xs=Xs, slots=2)
        prm = {k: T(out["params"][k]) for k in NAMES}
        ref = asvgp_math.elbo(prm, T(X), T(y), T(mask, torch.bool), a, b,
                              (19, 19), kernel="Matern32",
                              jitter=1e-6).numpy()
        ls = np.asarray(out["params"]["lengthscales"])
        lv = np.asarray(out["params"]["likelihood_variance"])
        at_bounds = (np.abs(ls / 50.0 - 1) < 1e-5).all(axis=1) & \
            (np.abs(lv / 1e-5 - 1) < 1e-5)
        return at_bounds, np.abs(np.asarray(out["objective"]) / ref - 1)

    # bench.py's vff configuration, as bench_vff_engine sets it
    common = _bench_common(2)
    common["constraints"]["lengthscales"]["low"] = [0.05] * 2
    for engine in (JaxASVGP(num_inducing_features=[19, 19],
                            dtype=jnp.float32, **common),
                   bench_vff_engine(2, 19, engine=batched.BatchedASVGP,
                                    device="cpu", dtype=torch.float32)):
        at_bounds, gap = run(engine)
        assert at_bounds.any(), type(engine).__module__
        assert (gap[at_bounds] > 1.0).all(), type(engine).__module__
    at_bounds, gap = run(bench_vff_engine(2, 19, engine=batched.BatchedASVGP,
                                          device="cpu", dtype=torch.float64))
    assert not at_bounds.any()
    assert gap.max() < 1e-10


@pytest.mark.parametrize("name", ["VFFModel", "ASVGPModel"])
def test_model_matches_jax(name):
    """VFFModel / ASVGPModel (25 L-BFGS iterations by autograd, constrained
    lengthscales) from the same start as the JAX package's: parameters,
    predictions and objective within RUN_TOL. (Run to convergence, the two
    part by rounding where a lengthscale rests on its bound.)"""
    X, y, _, Xs = workload(B=2, N=80)
    kw = dict(coords=X[0], obs=y[0], num_inducing_features=6,
              coords_scale=[2.0, 2.0], domain_size=6.0,
              expert_loc=[0.5, -0.5])
    models = [jax_get_model(name)(**kw), get_model(name)(device="cpu", **kw)]
    for mdl in models:
        mdl.set_parameter_constraints(
            {"lengthscales": {"low": [0.05] * 2, "high": [20.0] * 2}},
            move_within_tol=True, tol=1e-2)
        mdl.optimise_parameters(max_iter=15)
    np.testing.assert_allclose(models[1].a, models[0].a, rtol=1e-15)
    want, got = (mdl.get_parameters() for mdl in models)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RUN_TOL, err_msg=k)
    pw, pg = (mdl.predict(Xs[0]) for mdl in models)
    for k in pw:
        np.testing.assert_allclose(pg[k], pw[k], atol=RUN_TOL, err_msg=k)
    np.testing.assert_allclose(models[1].get_objective_function_value(),
                               models[0].get_objective_function_value(),
                               rtol=RUN_TOL)


def test_execute_buckets_hands_vff_its_expert_locations():
    """execute_buckets gives each level its scaled expert locations: the
    boxes are expert_loc +- domain_size over coords_scale, not the data's
    centroid, and the run equals fit_predict_many given the locations."""
    rng = np.random.default_rng(2)
    locs = np.array([[0.0, 0.0], [3.0, -2.0], [-4.0, 1.0]])
    X_list = [c + rng.uniform(-1.5, 1.5, (n, 2))
              for c, n in zip(locs, (40, 41, 37))]
    obs = [np.sin(x[:, 0]) + 0.05 * rng.standard_normal(len(x))
           for x in X_list]
    pred = [c + rng.uniform(-1, 1, (5, 2)) for c in locs]
    engine = le.make_engine(get_model("VFFModel"),
                            {"coords_scale": [0.5, 0.5],
                             "num_inducing_features": 5, "domain_size": 2.0},
                            coords_dim=2, optim_kwargs={"max_iter": 50},
                            device="cpu")
    out = le.execute_buckets(engine, X_list, obs, pred,
                             coords_scale=[0.5, 0.5], expert_locs=locs)
    assert len(out["buckets"]) == 1 and np.isfinite(out["objective"]).all()
    np.testing.assert_array_equal(engine._a, locs / 0.5 - 4.0)
    np.testing.assert_array_equal(engine._b, locs / 0.5 + 4.0)
    bk = le.make_buckets([len(o) for o in obs], [5] * 3, batch_size=3)[0]
    X, y, mask, Xs, _, _, el = le.assemble_bucket(
        bk, X_list, obs, pred, np.full((1, 2), 0.5), np.ones((1, 1)),
        expert_locs=locs)
    np.testing.assert_array_equal(el, locs / 0.5)
    direct = engine.fit_predict_many(X, y, mask, Xs, expert_locs=el)
    np.testing.assert_array_equal(out["objective"], direct["objective"])
    np.testing.assert_array_equal(out["preds"]["f*"],
                                  direct["preds"]["f*"][:, :5])


def vff_config(model="VFFModel"):
    """Two experts of 50 km boxes (domain_size) on scattered observations,
    stopped at 25 L-BFGS iterations: beyond them, on the flat surface along
    a lengthscale at its bound, the two packages' trajectories part by
    rounding (ASVGP: 95 and 170 iterations to ELBOs 1.3e-5 apart)."""
    rng = np.random.default_rng(8)
    n = 400
    df = pd.DataFrame({"x": rng.uniform(-60, 60, n),
                       "y": rng.uniform(-60, 60, n)})
    df["z"] = np.sin(df["x"] / 20) + 0.05 * rng.standard_normal(n)
    eloc = pd.DataFrame({"x": [0.0, 15.0], "y": [0.0, -10.0]})
    return dict(
        expert_loc_config={"source": eloc},
        data_config={"data_source": df, "obs_col": "z",
                     "coords_col": ["x", "y"],
                     "local_select": [{"col": ["x", "y"], "comp": "<",
                                       "val": 35.0}]},
        model_config={"oi_model": model,
                      "init_params": {"coords_scale": [10, 10],
                                      "num_inducing_features": 6,
                                      "domain_size": 50.0},
                      "constraints": {"lengthscales": {"low": [0.5, 0.5],
                                                       "high": [80.0, 80.0]}},
                      "optim_kwargs": {"max_iter": 25}},
        pred_loc_config={"method": "expert_loc"})


@pytest.mark.parametrize("model", ["VFFModel", "ASVGPModel"])
def test_pipeline_store_matches_jax(model, tmp_path):
    """LocalExpertOI with VFFModel / ASVGPModel and domain_size writes the
    JAX package's store: the boxes centre on the expert locations in both
    (50 km boxes beyond the 35 km selection radius), and every table agrees
    within RUN_TOL."""
    stores = {}
    for pkg in ("jax", "torch"):
        store = str(tmp_path / f"{pkg}.h5")
        if pkg == "jax":
            JaxLocalExpertOI(**vff_config(model)).run(
                store_path=store, check_config_compatible=False,
                verbose=False, use_mesh=False)
        else:
            LocalExpertOI(device="cpu", **vff_config(model)).run(
                store_path=store, check_config_compatible=False,
                verbose=False)
        stores[pkg] = store
    got, _ = get_results_from_h5file(stores["torch"],
                                     merge_on_expert_locations=False)
    want, _ = jax_results(stores["jax"], merge_on_expert_locations=False)
    for table in ("preds", "run_details", "lengthscales", "kernel_variance",
                  "likelihood_variance"):
        keys = [c for c in ("x", "y", "_dim_0") if c in want[table].columns]
        g = got[table].sort_values(keys).reset_index(drop=True)
        w = want[table].sort_values(keys).reset_index(drop=True)
        assert len(g) == len(w) > 0, table
        for col in w.columns:
            if w[col].dtype.kind == "f" and col != "run_time":
                np.testing.assert_allclose(g[col].values, w[col].values,
                                           rtol=RUN_TOL, atol=RUN_TOL,
                                           err_msg=f"{table}.{col}")
    np.testing.assert_array_equal(
        got["run_details"]["optimise_iterations"].values,
        want["run_details"]["optimise_iterations"].values)
    assert len(got["kernel_variance"]) == 2 * 2     # per-dimension variances


JAX_NAMES = ("GPRModel", "KISSGPModel", "SGPRModel", "SVGPModel", "VFFModel",
             "ASVGPModel", "MultioutputGPRModel", "MultioutputSVGPModel",
             "GPflowGPRModel", "GPflowSGPRModel", "GPflowSVGPModel",
             "GPflowVFFModel", "GPflowASVGPModel", "PurePythonGPR",
             "sklearnGPRModel", "GPyTorchGPRModel", "GPyTorchKISSGPModel")
ENGINE_OF = {"GPRModel": "BatchedGPR", "SGPRModel": "BatchedSGPR",
             "SVGPModel": "BatchedSVGP", "VFFModel": "BatchedVFF",
             "ASVGPModel": "BatchedASVGP", "KISSGPModel": "BatchedGPR",
             "MultioutputGPRModel": "BatchedGPR",
             "MultioutputSVGPModel": "BatchedSVGP"}


@pytest.mark.parametrize("name", JAX_NAMES)
def test_get_model_and_make_engine(name):
    """Every name of the JAX package's get_model: the port's class of the
    same name (aliases included) and make_engine's engine for it, as the JAX
    pipeline picks (gpsat_tpu/local_experts.py:572-582): the KISS-GP and
    multioutput models by the name fallback (BatchedGPR, BatchedGPR and
    BatchedSVGP). A subclass of the port's model takes its parent's
    engine."""
    want = jax_get_model(name).__name__
    cls = get_model(name)
    assert cls.__name__ == want
    init = {"num_inducing_features": 4} \
        if want in ("VFFModel", "ASVGPModel") else {}
    engine = le.make_engine(cls, init, coords_dim=2, device="cpu")
    assert type(engine).__name__ == ENGINE_OF[want]
    sub = type("Custom" + want, (cls,), {})
    assert type(le.make_engine(sub, init, coords_dim=2, device="cpu")) \
        is type(engine)
