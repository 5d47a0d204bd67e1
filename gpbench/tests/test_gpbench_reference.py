"""The plain reference against the program's plain paths, in float64 at a
tiny size, and the inducing-point recipe against the program's."""

import numpy as np
import pytest
import torch

from gpbench.reference import gp
from gpbench.reference.inducing import inducing_rows
from gpsat_tpu_torch.ops import gpr as port_gpr
from gpsat_tpu_torch.ops import sgpr as port_sgpr

F64 = torch.float64


def expert(n, p, seed):
    rng = np.random.default_rng(seed)
    X = torch.tensor(rng.uniform(-3, 3, (n, 3)), dtype=F64)
    y = torch.tensor(np.sin(X[:, 0].numpy()) + 0.1 * rng.standard_normal(n),
                     dtype=F64)
    Xs = torch.tensor(rng.uniform(-3, 3, (p, 3)), dtype=F64)
    theta = {"lengthscales": torch.tensor([1.3, 0.7, 2.0], dtype=F64),
             "kernel_variance": torch.tensor(0.4, dtype=F64),
             "likelihood_variance": torch.tensor(0.02, dtype=F64)}
    return X, y, Xs, theta


def test_gpr_against_the_programs_plain_path():
    X, y, Xs, th = expert(40, 9, 0)
    mask = torch.ones(40, dtype=torch.bool)
    want = port_gpr.nlml(th, X, y, mask)
    assert float(gp.gpr_nlml(th, X, y)) == pytest.approx(float(want),
                                                         rel=1e-10)
    got, ref = gp.gpr_predict(th, X, y, Xs), \
        port_gpr.predict(th, X, y, mask, Xs)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   rtol=1e-9, atol=1e-12)


def test_sgpr_against_the_programs_plain_path():
    X, y, Xs, th = expert(60, 9, 1)
    Z = X[:15]
    mask = torch.ones(60, dtype=torch.bool)
    zmask = torch.ones(15, dtype=torch.bool)
    want = port_sgpr.elbo(th, X, y, mask, Z, zmask, jitter=1e-6)
    assert float(gp.sgpr_elbo(th, X, y, Z, 1e-6)) == \
        pytest.approx(float(want), rel=1e-10)
    got = gp.sgpr_predict(th, X, y, Z, Xs, 1e-6)
    ref = port_sgpr.predict(th, X, y, mask, Z, zmask, Xs, jitter=1e-6)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   rtol=1e-8, atol=1e-11)


def test_smoother_against_the_programs():
    from gpsat_tpu_torch.postprocessing import smooth_field
    rng = np.random.default_rng(2)
    x, y = rng.uniform(-2e6, 2e6, (2, 300))
    v = rng.uniform(0, 1, 300)
    want = smooth_field(x, y, v, 4e5, 4e5, max=0.5, device="cpu")
    got = gp.smooth(*(torch.tensor(a, dtype=F64) for a in (x, y, v)),
                    4e5, 4e5, 0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_inducing_rows_against_the_programs_selection():
    from gpsat_tpu_torch.models.batched import BatchedSGPR
    from gpsat_tpu_torch.parallel.scheduler import make_buckets
    rng = np.random.default_rng(3)
    n_obs = rng.integers(5, 60, 30)
    n_pred = np.full(30, 7)
    M = 20
    rows = inducing_rows(n_obs, n_pred, M, seed=42)
    eng = BatchedSGPR(3, num_inducing_points=M, device="cpu")
    for bk in make_buckets(n_obs, n_pred, batch_size=30):
        ids = bk["indices"]
        N = bk["n_max"]
        X = np.zeros((len(ids), N, 3))
        mask = np.zeros((len(ids), N), bool)
        for b, e in enumerate(ids):
            X[b, :n_obs[e], 0] = np.arange(n_obs[e])
            mask[b, :n_obs[e]] = True
        Z, zmask = eng._build_inducing(X, mask)
        for b, e in enumerate(ids):
            np.testing.assert_array_equal(Z[b, zmask[b], 0], rows[e])
