"""Parity of the PyTorch port's building blocks (gpsat_tpu_torch) with the JAX
package on the same numpy inputs, on the CPU: kernels, bijectors, packing,
ops/gpr (f64), the scheduler and the weight carry-over helpers."""

import pathlib
import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from gpsat_tpu.ops import gpr as jgpr
from gpsat_tpu.ops import kernels as jkernels
from gpsat_tpu.ops import packing as jpacking
from gpsat_tpu.ops import transforms as jtransforms
from gpsat_tpu.parallel import scheduler as jscheduler
from gpsat_tpu_torch import resolve_device
from gpsat_tpu_torch.ops import gpr as tgpr
from gpsat_tpu_torch.ops import kernels as tkernels
from gpsat_tpu_torch.ops import packing as tpacking
from gpsat_tpu_torch.ops import transforms as ttransforms
from gpsat_tpu_torch.parallel import scheduler as tscheduler
from gpsat_tpu_torch.weights import params_from_jax, unconstrained_from_jax

REPO = pathlib.Path(__file__).resolve().parents[1]


def _t(a):
    return torch.as_tensor(np.array(a))


def make_case(B=4, N=30, D=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-4, 4, (B, N, D))
    y = rng.standard_normal((B, N))
    mask = np.ones((B, N), bool)
    mask[0, 20:] = False
    mask[2, 5:] = False
    params = {"lengthscales": rng.uniform(0.5, 3, (B, D)),
              "kernel_variance": rng.uniform(0.5, 2, B),
              "likelihood_variance": rng.uniform(0.01, 0.2, B)}
    return X, y, mask, params


def test_port_imports_nothing_of_jax():
    """The port and chip_smoke.py never import jax, optax or gpsat_tpu."""
    bad = re.compile(r"^\s*(import|from)\s+(jax|optax|gpsat_tpu)(\.|\s|$)",
                     re.M)
    files = sorted((REPO / "gpsat_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        hits = bad.findall(path.read_text())
        assert not hits, f"{path} imports {hits}"


def test_resolve_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", jkernels.KERNEL_NAMES)
def test_kernel_fn_matches_jax(name):
    rng = np.random.default_rng(1)
    X1 = rng.uniform(-3, 3, (2, 7, 3))
    X2 = rng.uniform(-3, 3, (2, 5, 3))
    ls = rng.uniform(0.5, 2, (2, 3))
    var = rng.uniform(0.5, 2, 2)
    want = np.asarray(jkernels.kernel_fn(name)(X1, X2, ls, var))
    got = tkernels.kernel_fn(name)(_t(X1), _t(X2), _t(ls), _t(var)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def test_kernel_helpers_match_jax():
    for nu in (0.5, 1.5, 2.5):
        assert tkernels.kernel_from_smoothness(nu) == \
            jkernels.kernel_from_smoothness(nu)
    with pytest.warns(UserWarning):
        assert tkernels.kernel_from_smoothness(1.4) == "Matern32"
    X = np.zeros((3, 6, 2))
    var = np.array([0.5, 1.0, 2.0])
    np.testing.assert_array_equal(
        tkernels.kernel_diag("RBF", _t(X), 1.0, _t(var)).numpy(),
        np.asarray(jkernels.kernel_diag("RBF", X, 1.0, var)))
    with pytest.raises(NotImplementedError):
        tkernels.kernel_fn("Periodic")


# ---------------------------------------------------------------------------
# bijectors and packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["identity", "exp", "softplus", "sigmoid"])
def test_bijectors_match_jax_and_round_trip(kind):
    kw = {"low": 0.01, "high": 50.0} if kind == "sigmoid" else {}
    jb = jtransforms.get_bijector(kind, **kw)
    tb = ttransforms.get_bijector(kind, **kw)
    u = np.linspace(-6.0, 6.0, 25)
    # XLA's f64 logistic differs from torch.sigmoid by ~1e-9 relative
    np.testing.assert_allclose(tb.forward(_t(u)).numpy(),
                               np.asarray(jb.forward(u)), rtol=1e-8)
    v = np.asarray(jb.forward(u))
    back = tb.inverse(_t(v)).numpy()
    np.testing.assert_allclose(back, np.asarray(jb.inverse(v)), rtol=1e-9,
                               atol=1e-10)
    np.testing.assert_allclose(back, u, rtol=1e-7, atol=1e-8)


def test_batched_sigmoid_and_softplus_edges():
    """Per-expert bounds (the engine's batched bijectors) and Softplus's
    inverse branches."""
    low = np.array([[0.01, 0.1], [1.0, 2.0]])
    high = np.array([[50.0, 5.0], [3.0, 9.0]])
    sig = ttransforms.Sigmoid(_t(low), _t(high))
    u = np.array([[-1.0, 0.5], [2.0, -3.0]])
    want = np.asarray(jtransforms.Sigmoid(low, high).forward(u))
    np.testing.assert_allclose(sig.forward(_t(u)).numpy(), want, rtol=1e-8)
    gathered = sig.map_tensors(lambda a: a[[1]])
    np.testing.assert_allclose(gathered.forward(_t(u[[1]])).numpy(),
                               want[[1]], rtol=1e-8)
    v = np.array([-1.0, 0.0, 1e-12, 1e-3, 30.0, 800.0])
    np.testing.assert_allclose(
        ttransforms.Softplus().inverse(_t(v)).numpy(),
        np.asarray(jtransforms.Softplus().inverse(v)), rtol=1e-12)


def test_pack_unpack_round_trip():
    d = 3
    entries = [("lengthscales", (d,)), ("kernel_variance", ()),
               ("likelihood_variance", ())]
    tspec, jspec = tpacking.ParamSpec(entries), jpacking.ParamSpec(entries)
    assert (tspec.sizes, tspec.offsets, tspec.total) == \
        (jspec.sizes, jspec.offsets, jspec.total)
    rng = np.random.default_rng(2)
    params = {"lengthscales": rng.standard_normal((5, d)),
              "kernel_variance": rng.standard_normal(5),
              "likelihood_variance": rng.standard_normal(5)}
    vec = tpacking.pack({k: _t(v) for k, v in params.items()}, tspec,
                        batch_shape=(5,))
    want = np.stack([np.asarray(jpacking.pack(
        {k: v[i] for k, v in params.items()}, jspec)) for i in range(5)])
    np.testing.assert_array_equal(vec.numpy(), want)
    back = tpacking.unpack(vec, tspec)
    for k, v in params.items():
        np.testing.assert_array_equal(back[k].numpy(), v)


# ---------------------------------------------------------------------------
# ops/gpr in f64
# ---------------------------------------------------------------------------

def _jax_params(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("kernel", ["Matern32", "Matern12", "RBF"])
def test_nlml_and_predict_match_jax(kernel):
    X, y, mask, params = make_case()
    Xs = np.random.default_rng(3).uniform(-4, 4, (4, 9, 3))
    want = np.asarray(jax.vmap(
        lambda p, x, yy, mm: jgpr.nlml(p, x, yy, mm, kernel, 1e-6))(
        _jax_params(params), X, y, jnp.asarray(mask)))
    tp = {k: _t(v) for k, v in params.items()}
    got = tgpr.nlml(tp, _t(X), _t(y), _t(mask), kernel, 1e-6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10)
    wp = jax.vmap(lambda p, x, yy, mm, xs: jgpr.predict(
        p, x, yy, mm, xs, kernel, 1e-6))(
        _jax_params(params), X, y, jnp.asarray(mask), Xs)
    gp = tgpr.predict(tp, _t(X), _t(y), _t(mask), _t(Xs), kernel, 1e-6)
    for k in ("f*", "f*_var", "y_var"):
        np.testing.assert_allclose(gp[k].numpy(), np.asarray(wp[k]),
                                   rtol=1e-9, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("kernel", ["Matern32", "Matern52", "RBF"])
def test_nlml_fused_value_and_grad_match_jax(kernel):
    """nlml_fused (closed-form backward as a torch.autograd.Function)
    against jax.value_and_grad of the JAX custom_vjp, f64, rtol 1e-8."""
    X, y, mask, params = make_case(seed=4)
    maskf = mask.astype(float)
    fun = jax.vmap(jax.value_and_grad(
        lambda p, x, yy, mm: jgpr.nlml_fused(p, x, yy, mm, kernel, 1e-6),
        argnums=(0, 1, 2, 3)))
    want_v, (want_p, want_x, want_y, want_m) = fun(
        _jax_params(params), X, y, maskf)
    tp = {k: _t(v).requires_grad_(True) for k, v in params.items()}
    tx, ty, tm = (_t(a).requires_grad_(True) for a in (X, y, maskf))
    val = tgpr.nlml_fused(tp, tx, ty, tm, kernel, 1e-6)
    grads = torch.autograd.grad(val.sum(), [*tp.values(), tx, ty, tm])
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(want_v),
                               rtol=1e-8)
    for k, g in zip(tp, grads[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_p[k]),
                                   rtol=1e-8, atol=1e-10, err_msg=k)
    for name, g, w in (("X", grads[3], want_x), ("y", grads[4], want_y),
                       ("mask", grads[5], want_m)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8,
                                   atol=1e-10, err_msg=name)


def test_cholesky_of_non_pd_is_nan():
    X, y, mask, params = make_case(B=3, seed=5)
    params["likelihood_variance"] = np.array([-5.0, 0.1, 0.1])
    val = tgpr.nlml_fused({k: _t(v) for k, v in params.items()}, _t(X),
                          _t(y), _t(mask.astype(float)), "Matern32", 0.0)
    assert np.isnan(val[0].item())
    assert torch.isfinite(val[1:]).all()


# ---------------------------------------------------------------------------
# scheduler and weight carry-over
# ---------------------------------------------------------------------------

def test_scheduler_matches_jax():
    rng = np.random.default_rng(6)
    n_obs = rng.integers(3, 3000, 57)
    n_pred = rng.integers(0, 600, 57)
    for n in (1, 8, 9, 1000, 200000):
        assert tscheduler.bucket_level(n) == jscheduler.bucket_level(n)
    for kw in ({"batch_size": 7}, {"batch_size": 10, "multiple_of": 4}, {}):
        got = tscheduler.make_buckets(n_obs, n_pred, **kw)
        want = jscheduler.make_buckets(n_obs, n_pred, **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["indices"], w["indices"])
            assert (g["n_max"], g["p_max"], g["batch_pad"]) == \
                (w["n_max"], w["p_max"], w["batch_pad"])
    assert tscheduler.auto_batch_size(400, 400, device="cpu") == \
        jscheduler.auto_batch_size(400, 400, budget_elems=2**26)


def test_weights_from_jax():
    _, _, _, params = make_case()
    got = params_from_jax(_jax_params(params), device="cpu")
    for k, v in params.items():
        assert got[k].dtype == torch.float64
        np.testing.assert_array_equal(got[k].numpy(), v)
    u = unconstrained_from_jax(jnp.ones((4, 5)), dtype=torch.float32,
                               device="cpu")
    assert u.shape == (4, 5) and u.dtype == torch.float32
