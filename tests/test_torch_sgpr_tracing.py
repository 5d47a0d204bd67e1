"""The recorder's SGPR spans and counter on the CPU: `sgpr.vg` around every
ops/cuda_sgpr.sgpr_vg_batched call, `sgpr.predict` around every
sgpr_predict_batched call with its one read through tracing.host, and
`cholinv_mats`, the matrices ops/cuda_cholinv.cholinv_batched factors."""

from collections import Counter

import numpy as np
import pytest
import torch

from gpsat_tpu_torch import tracing
from gpsat_tpu_torch.local_experts import execute_buckets, make_engine
from gpsat_tpu_torch.models.sgpr import SGPRModel
from gpsat_tpu_torch.ops import cuda_gpr, cuda_sgpr
from gpsat_tpu_torch.ops.cuda_cholinv import cholinv_batched
from gpsat_tpu_torch.parallel import scheduler

B, N, M, D, P = 3, 40, 12, 3, 7


@pytest.fixture(autouse=True)
def _empty():
    tracing.clear()
    yield
    tracing.clear()


def by_name(records, name):
    return [r for r in records if r["name"] == name]


def inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    X = torch.rand(B, N, D, generator=g) * 4.0
    y = torch.sin(X[..., 0]) + 0.1 * torch.randn(B, N, generator=g)
    mask = torch.ones(B, N)
    mask[0, N - 5:] = 0.0
    Z = X[:, :M].clone()
    zmask = torch.ones(B, M)
    Xs = torch.rand(B, P, D, generator=g) * 4.0
    params = {"lengthscales": torch.full((B, D), 1.5),
              "kernel_variance": torch.full((B,), 0.8),
              "likelihood_variance": torch.full((B,), 0.05)}
    return params, X, y, mask, Z, zmask, Xs


@pytest.mark.parametrize("route", cuda_sgpr.ROUTES)
def test_sgpr_vg_is_one_span_a_call_with_its_attributes(route):
    params, X, y, mask, Z, zmask, _ = inputs()
    with tracing.enable():
        for _ in range(2):
            cuda_sgpr.sgpr_vg_batched(params, X, y, mask, Z, zmask,
                                      "Matern32", 1e-6, route=route)
    spans = by_name(tracing.snapshot(), "sgpr.vg")
    assert len(spans) == 2
    for s in spans:
        assert s["attrs"] == {"route": route, "experts": B, "n": N, "m": M}
        assert s["parent"] is None and s["t0"] <= s["t1"]
    # the hybrid and stream routes factor Kuu and B through cholinv_batched
    # (two [B, M_pad, M_pad] batches a call); the mega route's plain
    # version factors its own
    want = {"hybrid": 2 * B, "stream": 2 * B, "mega": None}[route]
    assert spans[0]["counts"].get("cholinv_mats") == want


def test_cholinv_mats_counts_the_matrices_factored():
    g = torch.Generator().manual_seed(1)
    with tracing.enable():
        for b in (1, 4, 2):
            A = torch.randn(b, 8, 8, generator=g, dtype=torch.float64)
            cholinv_batched(A @ A.mT + 8.0 * torch.eye(8))
        with tracing.span("outer"):
            cholinv_batched(torch.eye(8).expand(5, 8, 8))
    recs = tracing.snapshot()
    loose = [r["counts"]["cholinv_mats"] for r in recs if r["name"] is None]
    assert loose == [1, 4, 2]
    assert by_name(recs, "outer")[0]["counts"] == {"cholinv_mats": 5}


def test_sgpr_predict_is_one_span_and_one_host_read_a_call(monkeypatch):
    """The failed-expert check reads through tracing.host; a CPU tensor
    never leaves a device, so the read is counted here by a host() that
    counts every call (on the card, tests/test_torch_cuda.py)."""
    calls = []

    def host(t):
        calls.append(t)
        tracing.count("host_reads")
        return t
    monkeypatch.setattr(tracing, "host", host)
    params, X, y, mask, Z, zmask, Xs = inputs()
    with tracing.enable():
        for _ in range(3):
            out = cuda_sgpr.sgpr_predict_batched(params, X, y, mask, Z,
                                                 zmask, Xs, "Matern32", 1e-6)
    assert out["f*"].shape == (B, P)
    spans = by_name(tracing.snapshot(), "sgpr.predict")
    assert [s["attrs"] for s in spans] == \
        [{"experts": B, "n": N, "m": M, "p": P}] * 3
    assert [s["counts"] for s in spans] == \
        [{"host_reads": 1, "cholinv_mats": 2 * B}] * 3
    assert len(calls) == 3 and all(c.dtype == torch.bool for c in calls)


def test_nothing_is_recorded_with_the_recorder_off():
    params, X, y, mask, Z, zmask, Xs = inputs()
    assert not tracing.enabled()
    cuda_sgpr.sgpr_vg_batched(params, X, y, mask, Z, zmask, "Matern32", 1e-6)
    cuda_sgpr.sgpr_predict_batched(params, X, y, mask, Z, zmask, Xs,
                                   "Matern32", 1e-6)
    cholinv_batched(torch.eye(4).expand(2, 4, 4))
    assert tracing.snapshot() == []


def test_the_pools_evaluations_are_sgpr_vg_spans_inside_its_issue(
        monkeypatch):
    """execute_buckets on an SGPR engine on the kernel path (its plain
    versions on the CPU), two slots so every level runs the pool: each
    sgpr.vg span is a pool's first evaluation or sits in an lbfgs.issue
    span, each pool iteration issues at least one, the fill predicts in
    sgpr.predict spans, and every cholinv_mats count lies in one of the
    two."""
    monkeypatch.setattr(cuda_gpr, "_FORCE_KERNEL_PATH", True)
    monkeypatch.setattr(scheduler, "auto_batch_size", lambda *a, **k: 2)
    rng = np.random.default_rng(5)
    X_list, obs_list, pred_list = [], [], []
    for _ in range(6):
        n = int(rng.integers(20, 60))
        X = rng.uniform(0.0, 40.0, (n, 2))
        X_list.append(X)
        obs_list.append(np.sin(X[:, 0] / 8.0) + 0.1 * rng.standard_normal(n))
        pred_list.append(rng.uniform(0.0, 40.0, (4, 2)))
    eng = make_engine(SGPRModel, {"coords_scale": [10.0, 10.0],
                                  "num_inducing_points": 8,
                                  "dtype": "float32"},
                      {"lengthscales": {"low": [1e-2, 1e-2],
                                        "high": [20.0, 20.0]},
                       "likelihood_variance": {"low": 1e-4, "high": 1.0}},
                      coords_dim=2, optim_kwargs={"max_iter": 15},
                      device="cpu")
    with tracing.enable():
        out = execute_buckets(eng, X_list, obs_list, pred_list,
                              coords_scale=[[10.0, 10.0]])
    recs = tracing.snapshot()
    by_id = {r["id"]: r for r in recs}

    def parents(name):
        return Counter(by_id[r["parent"]]["name"] for r in by_name(recs, name))
    pool_iters = sum(b["pool_iterations"] for b in out["buckets"])
    vg = parents("sgpr.vg")
    # a pool's first evaluation, then its iterations' line searches
    assert set(vg) == {"engine.pool", "lbfgs.issue"}
    assert vg["lbfgs.issue"] >= pool_iters > 0
    assert all(s["attrs"]["route"] == "hybrid" and s["attrs"]["m"] == 8
               for s in by_name(recs, "sgpr.vg"))
    assert set(parents("sgpr.predict")) == {"fill.issue"}
    counted = {r["name"] for r in recs if r["counts"].get("cholinv_mats")}
    assert counted == {"sgpr.vg", "sgpr.predict"}
