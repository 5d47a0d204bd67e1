"""The production IS2 SGPR configuration (gpbench/configs/sgpr_is2_full.json:
SGPRModel, Matern32, coords_scale [50 km, 50 km, 1 d], its constraints, Kuu
jitter 1e-6, inducing points a seeded subset) through the port against the
benchmark's plain float64 reference (gpbench/reference/gp.py), on the CPU.

Inputs: the benchmark generator's day inputs for the configuration at two
seeds, cut to three experts of 200-400 observations each, every eighth
prediction point and 32 inducing points, at seeded random hyperparameters.
The engine in float64 runs the CPU's path (ops/sgpr, autograd) and is held
at float64 tolerances; route hybrid's plain path (ops/cuda_sgpr with the
plain cholinv, the path the card runs with the cholinv kernel) computes in
float32 by construction and is held at float32 tolerances. Imports no JAX.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from gpbench import generator
from gpbench.reference import gp
from gpbench.reference.inducing import inducing_rows
from gpsat_tpu_torch.local_experts import execute_buckets, make_engine
from gpsat_tpu_torch.models import get_model
from gpsat_tpu_torch.ops import cuda_gpr, cuda_sgpr
from gpsat_tpu_torch.ops import sgpr as sgpr_math

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "gpbench", "configs", "sgpr_is2_full.json")) as f:
    CFG = json.load(f)
SCALE = np.asarray(CFG["model"]["init_params"]["coords_scale"], float)
JITTER = CFG["defaults"]["jitter"]
KERNEL = CFG["defaults"]["kernel"]
M = 32
SEEDS = (2 ** 31 + 4099, 11)
NAMES = ("lengthscales", "kernel_variance", "likelihood_variance")


@pytest.fixture(autouse=True)
def _threads():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@functools.lru_cache(maxsize=None)
def cut_day(seed):
    """(X_list, obs_list, pred_list, params) of three experts of the first
    target day, raw units; params in the engine's (scaled) units."""
    dep = CFG["deployment"]
    assert dep["expert_stride"] == 1 and not CFG["reduced"]
    inp = generator.day_inputs(generator.observations(seed, dep), dep,
                               dep["target_days"][0])
    assert len(inp["obs_list"]) == CFG["computes_to"]["experts_per_day"]
    rng = np.random.default_rng([seed, 19])
    X_list, obs_list, pred_list = [], [], []
    for e in rng.choice(len(inp["obs_list"]), 3, replace=False):
        rows = np.sort(rng.choice(len(inp["obs_list"][e]),
                                  int(rng.integers(200, 400)), replace=False))
        X_list.append(inp["X_list"][e][rows])
        obs_list.append(inp["obs_list"][e][rows])
        pred_list.append(inp["pred_list"][e][::8])
    params = {"lengthscales": np.stack([rng.uniform(2.0, 15.0, 3),
                                        rng.uniform(2.0, 15.0, 3),
                                        rng.uniform(1.0, 20.0, 3)], 1),
              "kernel_variance": rng.uniform(0.005, 0.05, 3),
              "likelihood_variance": rng.uniform(1e-3, 1e-2, 3)}
    return X_list, obs_list, pred_list, params


def engine(dtype):
    m = CFG["model"]
    init = dict(m["init_params"], num_inducing_points=M, dtype=dtype)
    return make_engine(get_model(m["oi_model"]), init, m["constraints"],
                       coords_dim=3, device="cpu")


def experts(seed):
    """Per expert: (X, y, Xs, Z) scaled as the reference takes them, Z the
    rows the reference's recipe derives, and its theta in float64."""
    X_list, obs_list, pred_list, params = cut_day(seed)
    rows = inducing_rows([len(o) for o in obs_list],
                         [len(p) for p in pred_list], M,
                         CFG["defaults"]["inducing_seed"])
    for e in range(len(obs_list)):
        X = X_list[e] / SCALE
        theta = {n: torch.as_tensor(params[n][e], dtype=torch.float64)
                 for n in NAMES}
        yield (torch.as_tensor(X), torch.as_tensor(obs_list[e]),
               torch.as_tensor(pred_list[e] / SCALE),
               torch.as_tensor(X[rows[e]]), theta)


def reference_vg(theta, X, y, Z):
    """The reference's negative ELBO and its gradient in the raw
    hyperparameters, float64."""
    th = {n: v.clone().requires_grad_(True) for n, v in theta.items()}
    val = -gp.sgpr_elbo(th, X, y, Z, JITTER)
    grads = torch.autograd.grad(val, [th[n] for n in NAMES])
    return float(val.detach()), dict(zip(NAMES, grads))


def batch_of_one(theta, X, y, Z, dtype):
    params = {n: v.to(dtype).reshape(1, -1) if n == "lengthscales"
              else v.to(dtype).reshape(1) for n, v in theta.items()}
    ones = torch.ones(1, len(y), dtype=dtype)
    return (params, X[None].to(dtype), y[None].to(dtype), ones,
            Z[None].to(dtype), torch.ones(1, len(Z), dtype=dtype))


@pytest.mark.parametrize("seed", SEEDS)
def test_the_f64_engine_matches_the_reference(seed):
    """execute_buckets with optimise=False at the given hyperparameters: the
    inducing points the reference re-derives, the ELBO to 1e-10 relative,
    the posterior to 1e-10 of the observations' scale; the port's objective
    and its autograd gradient to 1e-9 relative."""
    X_list, obs_list, pred_list, params = cut_day(seed)
    out = execute_buckets(engine("float64"), X_list, obs_list, pred_list,
                          coords_scale=SCALE, overrides=params,
                          optimise=False)
    for e, (X, y, Xs, Z, theta) in enumerate(experts(seed)):
        np.testing.assert_array_equal(
            out["params"]["inducing_points"][e][:len(Z)], Z.numpy())
        for n in NAMES:
            np.testing.assert_allclose(
                np.ravel(out["params"][n][e]), np.ravel(params[n][e]),
                rtol=1e-12, err_msg=n)
        want = float(gp.sgpr_elbo(theta, X, y, Z, JITTER))
        np.testing.assert_allclose(out["objective"][e], want, rtol=1e-10)
        ref = gp.sgpr_predict(theta, X, y, Z, Xs, JITTER)
        P = int(out["n_pred"][e])
        assert P == len(Xs)
        for k, v in ref.items():
            np.testing.assert_allclose(out["preds"][k][e, :P], v.numpy(),
                                       rtol=0, atol=1e-10, err_msg=k)

        val, grads = reference_vg(theta, X, y, Z)
        p, Xb, yb, mask, Zb, zmask = batch_of_one(theta, X, y, Z,
                                                  torch.float64)
        p = {n: v.requires_grad_(True) for n, v in p.items()}
        got = sgpr_math.neg_elbo(p, Xb, yb, mask.bool(), Zb, zmask.bool(),
                                 kernel=KERNEL, jitter=JITTER)[0]
        np.testing.assert_allclose(float(got.detach()), val, rtol=1e-10)
        g = torch.autograd.grad(got, [p[n] for n in NAMES])
        for n, gn in zip(NAMES, g):
            np.testing.assert_allclose(gn.reshape(-1).numpy(),
                                       grads[n].reshape(-1).numpy(),
                                       rtol=1e-9, atol=1e-9 * abs(val),
                                       err_msg=n)


@pytest.mark.parametrize("seed", SEEDS)
def test_route_hybrid_plain_path_matches_the_reference(seed, monkeypatch):
    """Route hybrid's value and raw-parameter gradient
    (cuda_sgpr.sgpr_vg_batched) and the fused posterior the engine predicts
    with (cuda_sgpr.sgpr_predict_batched, through execute_buckets on the
    forced kernel path), float32, against the float64 reference. Limits from
    float32 (measured on these inputs: 4.1e-6, 3.8e-6 and 6.7e-7): the value
    to 1e-5 relative (a sum of n-sized terms that cancel to it), each
    gradient to 5e-5 of the largest, the posterior to 1e-5, a ten-thousandth
    of the observations' spread."""
    monkeypatch.setattr(cuda_gpr, "_FORCE_KERNEL_PATH", True)
    X_list, obs_list, pred_list, params = cut_day(seed)
    out = execute_buckets(engine("float32"), X_list, obs_list, pred_list,
                          coords_scale=SCALE, overrides=params,
                          optimise=False)
    for e, (X, y, Xs, Z, theta) in enumerate(experts(seed)):
        val, grads = reference_vg(theta, X, y, Z)
        got, g = cuda_sgpr.sgpr_vg_batched(
            *batch_of_one(theta, X, y, Z, torch.float32), KERNEL, JITTER,
            route="hybrid")
        np.testing.assert_allclose(float(got[0]), val, rtol=1e-5)
        scale = max(float(grads[n].abs().max()) for n in NAMES)
        for n in NAMES:
            np.testing.assert_allclose(
                g[n].double().reshape(-1).numpy(),
                grads[n].reshape(-1).numpy(), rtol=0, atol=5e-5 * scale,
                err_msg=n)
        ref = gp.sgpr_predict(theta, X, y, Z, Xs, JITTER)
        P = int(out["n_pred"][e])
        for k, v in ref.items():
            np.testing.assert_allclose(out["preds"][k][e, :P], v.numpy(),
                                       rtol=0, atol=1e-5, err_msg=k)
