"""The port's per-expert models (gpsat_tpu_torch GPRModel, SGPRModel,
get_model) against the JAX classes on the same numpy inputs, in f64 on the
CPU, both started from the same state through
weights.model_state_from_jax."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from gpsat_tpu.models import get_model as jax_get_model
from gpsat_tpu_torch.models import get_model
from gpsat_tpu_torch.models.base import BaseGPRModel
from gpsat_tpu_torch.models.exact_gpr import GPRModel
from gpsat_tpu_torch.models.sgpr import SGPRModel, select_inducing
from gpsat_tpu_torch.weights import model_state_from_jax

HYPER = ("lengthscales", "kernel_variance", "likelihood_variance")
CONSTRAINTS = {"lengthscales": {"low": [0.01, 0.01], "high": [20.0, 20.0]},
               "likelihood_variance": {"low": 1e-5, "high": 1.0}}

torch.set_num_threads(1)


def make_data(N=80, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-4, 4, (N, 2))
    y = (0.4 * np.sin(X[:, 0] * 0.8) + 0.3 * np.cos(X[:, 1] * 0.6)
         + 0.05 * rng.standard_normal(N) + 2.0)
    return X, y, rng.uniform(-4, 4, (9, 2))


def make_pair(name, N=80, seed=0, **extra):
    """(JAX model, port's model on the CPU) on the same data, with scaled
    coordinates and observations and a local mean."""
    X, y, Xs = make_data(N, seed)
    kw = dict(coords=X, obs=y, coords_scale=[2.0, 1.0], obs_mean="local",
              obs_scale=0.5, **extra)
    return jax_get_model(name)(**kw), get_model(name)(device="cpu", **kw), Xs


def jax_bounds(jm):
    return {n: (np.asarray(jm.transforms[n].low),
                np.asarray(jm.transforms[n].high))
            for n in HYPER if hasattr(jm.transforms[n], "low")}


def carry_state(jm, tm):
    """Put the port's model into the JAX model's state."""
    params, cons = model_state_from_jax(jm.get_parameters(), jax_bounds(jm))
    tm.set_parameter_constraints(cons, move_within_tol=False)
    tm.set_parameters(**params)


def assert_same_parameters(tm, jm, rtol):
    got, want = tm.get_parameters(), jm.get_parameters()
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


@pytest.mark.parametrize("name", ["GPRModel", "SGPRModel"])
def test_constructor_scaling_and_demeaning(name):
    """Coordinates divided by coords_scale, observations de-meaned then
    divided by obs_scale, data-driven initial variances: equal to the JAX
    model's to the last bit; f64 on the CPU."""
    extra = {"num_inducing_points": 30} if name == "SGPRModel" else {}
    jm, tm, _ = make_pair(name, **extra)
    assert isinstance(tm, BaseGPRModel)
    assert tm.dtype == torch.float64 and tm.device.type == "cpu"
    assert tm.gpu_name is None and isinstance(tm.cpu_name, str)
    np.testing.assert_array_equal(tm.coords, jm.coords)
    np.testing.assert_array_equal(tm.obs, jm.obs)
    np.testing.assert_array_equal(tm.obs_mean, jm.obs_mean)
    np.testing.assert_array_equal(tm.coords_scale, jm.coords_scale)
    assert tm.param_names == jm.param_names
    assert_same_parameters(tm, jm, rtol=0)
    assert tm.coords_col == jm.coords_col and tm.obs_col == jm.obs_col


def test_explicit_initial_values_and_smoothness():
    X, y, _ = make_data(30)
    kw = dict(coords=X, obs=y, kernel_kwargs={"lengthscales": 2.5,
                                              "variance": 0.7,
                                              "smoothness": 2.5},
              noise_variance=0.02)
    jm, tm = jax_get_model("GPRModel")(**kw), GPRModel(device="cpu", **kw)
    assert tm.kernel == jm.kernel == "Matern52"
    assert_same_parameters(tm, jm, rtol=0)
    tm.set_lengthscales(3.0)
    np.testing.assert_array_equal(tm.get_lengthscales(), [3.0, 3.0])
    with pytest.raises(AssertionError, match="not in param_names"):
        tm.set_parameters(inducing_points=np.zeros((2, 2)))
    with pytest.raises(AssertionError, match="not in available kernels"):
        GPRModel(coords=X, obs=y, kernel="Periodic", device="cpu")


@pytest.mark.parametrize("name", ["GPRModel", "SGPRModel"])
def test_constraints_with_move_within_tol(name):
    """Sigmoid bounds (scaled by coords_scale on request), values outside
    them moved inside by tol, the 0-d bounds of scalar parameters: the same
    values and bounds as the JAX model."""
    extra = {"num_inducing_points": 30} if name == "SGPRModel" else {}
    jm, tm, _ = make_pair(name, **extra)
    cons = {"lengthscales": {"low": [0.5, 0.5], "high": [0.9, 4.0],
                             "scale": True},
            "kernel_variance": {"low": 1e-3, "high": 0.05},
            "likelihood_variance": {"low": 0.2, "high": 1.0}}
    if name == "SGPRModel":
        cons["inducing_points"] = {}
    for m in (jm, tm):
        m.set_parameter_constraints(cons, move_within_tol=True, tol=1e-2)
    assert_same_parameters(tm, jm, rtol=0)
    assert tm.get_likelihood_variance() == pytest.approx(0.21)
    for n, (low, high) in jax_bounds(jm).items():
        np.testing.assert_array_equal(tm.transforms[n].low.numpy(), low)
        np.testing.assert_array_equal(tm.transforms[n].high.numpy(), high)
        assert tm.transforms[n].low.dtype == torch.float64
    assert tm.transforms["kernel_variance"].low.ndim == 0
    assert tm.transforms["lengthscales"].low.shape == (2,)


@pytest.mark.parametrize("name", ["GPRModel", "SGPRModel"])
def test_objective_value_matches_jax(name):
    """NLML for GPRModel, the positive ELBO for SGPRModel: rtol 1e-9, at the
    initial state and at a state carried over by model_state_from_jax."""
    extra = {"num_inducing_points": 30} if name == "SGPRModel" else {}
    jm, tm, _ = make_pair(name, **extra)
    np.testing.assert_allclose(tm.get_objective_function_value(),
                               jm.get_objective_function_value(), rtol=1e-9)
    jm.set_parameter_constraints(CONSTRAINTS, move_within_tol=True, tol=1e-2)
    jm.set_parameters(lengthscales=[1.3, 0.7], kernel_variance=0.4,
                      likelihood_variance=0.03)
    if name == "SGPRModel":
        jm.set_inducing_points(jm.get_inducing_points()[::-1] + 0.01)
    carry_state(jm, tm)
    assert_same_parameters(tm, jm, rtol=0)
    got = tm.get_objective_function_value()
    assert isinstance(got, float)
    np.testing.assert_allclose(got, jm.get_objective_function_value(),
                               rtol=1e-9)
    if name == "SGPRModel":
        assert got < 0 < GPRModel(coords=tm.coords, obs=tm.obs,
                                  device="cpu").get_objective_function_value()


@pytest.mark.parametrize("name", ["GPRModel", "SGPRModel"])
def test_optimise_parameters_matches_jax(name):
    """L-BFGS from the same state on a case that converges (exact GPR in
    under 60 steps; SGPR, whose second lengthscale runs to its bound, in
    under 150 with the bound at 5, where the optimum is a point): the same
    `converged`, parameters rtol 1e-4, objective rtol 1e-7; then with a fixed
    parameter, which stays where it was."""
    extra = {"num_inducing_points": 30} if name == "SGPRModel" else {}
    steps, ls_high = (150, 5.0) if name == "SGPRModel" else (60, 20.0)
    jm, tm, _ = make_pair(name, **extra)
    cons = {**CONSTRAINTS, "lengthscales": {"low": [0.01, 0.01],
                                            "high": [ls_high, ls_high]}}
    jm.set_parameter_constraints(cons, move_within_tol=True, tol=1e-2)
    carry_state(jm, tm)
    want = jm.optimise_parameters(max_iter=steps)
    got = tm.optimise_parameters(max_iter=steps)
    assert got is True and want is True
    assert tm._last_opt_success is True
    assert_same_parameters(tm, jm, rtol=1e-4)
    np.testing.assert_allclose(tm.get_objective_function_value(),
                               jm.get_objective_function_value(), rtol=1e-7)

    for m in (jm, tm):
        m.set_parameters(lengthscales=[1.0, 1.0], kernel_variance=0.3)
    assert tm.optimise_parameters(
        max_iter=steps, fixed_params=["kernel_variance"]) == \
        jm.optimise_parameters(max_iter=steps,
                               fixed_params=["kernel_variance"])
    assert tm.get_kernel_variance() == 0.3
    assert_same_parameters(tm, jm, rtol=1e-4)
    assert tm.optimise_parameters(fixed_params=list(HYPER)) is True


@pytest.mark.parametrize("name", ["GPRModel", "SGPRModel"])
def test_predict_matches_jax(name):
    """At equal parameters: f*, f*_var, y_var (and for GPRModel f*_cov,
    y_cov with full_cov) rtol 1e-6 atol 1e-12; f_bar the local mean; a single
    point given as a 1-d array; apply_scale=False."""
    extra = {"num_inducing_points": 30} if name == "SGPRModel" else {}
    jm, tm, Xs = make_pair(name, **extra)
    jm.set_parameters(lengthscales=[1.3, 0.7], kernel_variance=0.4,
                      likelihood_variance=0.03)
    carry_state(jm, tm)
    kw = {"full_cov": True} if name == "GPRModel" else {}
    got, want = tm.predict(Xs, **kw), jm.predict(Xs, **kw)
    assert set(got) == set(want)
    if name == "GPRModel":
        assert got["f*_cov"].shape == (9, 9)
    for k in want:
        assert got[k].dtype == np.float64 and got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-12,
                                   err_msg=k)
    np.testing.assert_allclose(got["f_bar"], np.full(9, tm.obs_mean[0, 0]))
    one, jone = tm.predict(Xs[0]), jm.predict(Xs[0])
    np.testing.assert_allclose(one["f*"], jone["f*"], rtol=1e-6)
    np.testing.assert_allclose(one["f*"], got["f*"][:1], rtol=1e-12)
    raw = tm.predict(Xs / tm.coords_scale, apply_scale=False)
    np.testing.assert_allclose(raw["f*"], got["f*"], rtol=1e-12)


def test_sgpr_train_inducing_points():
    """A few L-BFGS steps with the inducing locations in the optimised
    vector (autograd through ops/sgpr.neg_elbo): the same `converged`, Z
    atol 1e-6, hyperparameters rtol 1e-5, ELBO rtol 1e-7; Z moved."""
    jm, tm, _ = make_pair("SGPRModel", N=60, num_inducing_points=12)
    jm.set_parameter_constraints(CONSTRAINTS, move_within_tol=True, tol=1e-2)
    carry_state(jm, tm)
    Z0 = tm.get_inducing_points()
    np.testing.assert_array_equal(Z0, jm.get_inducing_points())
    want = jm.optimise_parameters(train_inducing_points=True, max_iter=3)
    got = tm.optimise_parameters(train_inducing_points=True, max_iter=3)
    assert got == want
    assert np.abs(tm.get_inducing_points() - Z0).max() > 1e-4
    np.testing.assert_allclose(tm.get_inducing_points(),
                               jm.get_inducing_points(), atol=1e-6)
    for k in HYPER:
        np.testing.assert_allclose(tm.get_parameters(k)[k],
                                   jm.get_parameters(k)[k], rtol=1e-5)
    np.testing.assert_allclose(tm.get_objective_function_value(),
                               jm.get_objective_function_value(), rtol=1e-7)


def test_select_inducing_draws_the_jax_subset():
    from gpsat_tpu.models.sgpr import select_inducing as jax_select
    X, _, _ = make_data(50)
    np.testing.assert_array_equal(select_inducing(X, 20, seed=7),
                                  jax_select(X, 20, seed=7))
    np.testing.assert_array_equal(select_inducing(X, 80), X)
    tm = SGPRModel(coords=X, obs=X[:, 0], num_inducing_points=20,
                   inducing_seed=7, device="cpu")
    np.testing.assert_array_equal(tm.get_inducing_points(),
                                  select_inducing(X, 20, seed=7))
    assert tm.jitter == 1e-6


def test_f32_model_keeps_f32_tensors():
    """dtype=float32 on the CPU: np.float64 hyperparameters and f64 bounds do
    not promote the optimisation; results agree with the f64 model to f32
    tolerance (rtol 1e-3 on predictions)."""
    X, y, Xs = make_data(60)
    kw = dict(coords=X, obs=y, obs_mean="local")
    m32 = GPRModel(device="cpu", dtype="float32", **kw)
    m64 = GPRModel(device="cpu", **kw)
    for m in (m32, m64):
        m.set_parameter_constraints(CONSTRAINTS, move_within_tol=True,
                                    tol=1e-2)
    assert m32.dtype == torch.float32
    assert m32.transforms["lengthscales"].low.dtype == torch.float32
    assert all(v.dtype == torch.float32 for v in m32._param_dict().values())
    assert m32.optimise_parameters(max_iter=60) in (True, False)
    m64.set_parameters(**m32.get_parameters())
    np.testing.assert_allclose(m32.predict(Xs)["f*"], m64.predict(Xs)["f*"],
                               rtol=1e-3, atol=1e-4)


def test_dataframe_constructor_and_prediction():
    """The DataFrame path (pandas only here, in the test): the same model as
    from arrays, predictions from a DataFrame of coordinates."""
    pd = pytest.importorskip("pandas")
    X, y, Xs = make_data(40)
    df = pd.DataFrame({"x": X[:, 0], "y": X[:, 1], "z": y})
    a = GPRModel(data=df, coords_col=["x", "y"], obs_col="z", device="cpu")
    b = GPRModel(coords=X, obs=y, device="cpu")
    np.testing.assert_array_equal(a.coords, b.coords)
    np.testing.assert_array_equal(a.obs, b.obs)
    assert a.coords_col == ["x", "y"] and a.obs_col == ["z"]
    got = a.predict(pd.DataFrame({"y": Xs[:, 1], "x": Xs[:, 0]}))
    np.testing.assert_allclose(got["f*"], b.predict(Xs)["f*"], rtol=1e-12)


@pytest.mark.parametrize("name,cls", [
    ("GPRModel", GPRModel), ("SGPRModel", SGPRModel),
    ("GPflowGPRModel", GPRModel), ("GPflowSGPRModel", SGPRModel),
    ("PurePythonGPR", GPRModel), ("sklearnGPRModel", GPRModel),
    ("GPyTorchGPRModel", GPRModel)])
def test_get_model_names_and_aliases(name, cls):
    assert get_model(name) is cls
    assert jax_get_model(name).__name__ == cls.__name__


@pytest.mark.parametrize("name", ["SVGPModel", "GPflowVFFModel", "ASVGPModel",
                                  "KISSGPModel", "MultioutputGPRModel"])
def test_get_model_names_the_slice_of_an_unported_family(name):
    """Every family of the JAX package is ported: the families of slices 7a
    (SVGP, VFF, ASVGP) and 7b (KISS-GP, the multioutput models) resolve to
    the port's class of the JAX package's name, in the port's package; an
    unknown name raises, listing the available ones."""
    want = jax_get_model(name).__name__       # the JAX package has it
    cls = get_model(name)
    assert cls.__name__ == want
    assert cls.__module__.startswith("gpsat_tpu_torch.models.")
    with pytest.raises(NotImplementedError, match="available"):
        get_model("NoSuchModel")


def test_models_need_a_card_unless_asked_for_the_cpu():
    X, y, _ = make_data(10)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GPRModel(coords=X, obs=y)


def test_importing_the_models_pulls_in_no_jax_and_no_pandas():
    code = ("import sys; import gpsat_tpu_torch.models.base, "
            "gpsat_tpu_torch.models.sgpr; "
            "bad = [m for m in ('jax', 'gpsat_tpu', 'pandas', 'h5py') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
