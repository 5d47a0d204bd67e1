"""The port's expert mesh (gpsat_tpu_torch.parallel.mesh, the mesh L-BFGS
pool, the engines and LocalExpertOI.run under a mesh) against the JAX
package's on its 8-device CPU mesh (tests/conftest.py), and against the
port's own one-device runs, on the CPU in f64. The port's mesh is eight
shards of the CPU, get_mesh(devices=["cpu"] * 8)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gpsat_tpu.local_experts import LocalExpertOI as JaxLocalExpertOI
from gpsat_tpu.models import batched as jbatched
from gpsat_tpu.models.exact_gpr import make_gpr_objective as jax_objective
from gpsat_tpu.ops import lbfgs as jlbfgs
from gpsat_tpu.ops.transforms import Sigmoid as JaxSigmoid
from gpsat_tpu.ops.transforms import Softplus as JaxSoftplus
from gpsat_tpu.parallel import mesh as jmesh
from gpsat_tpu_torch import local_experts
from gpsat_tpu_torch.models import batched as tbatched
from gpsat_tpu_torch.models.exact_gpr import make_gpr_objective
from gpsat_tpu_torch.ops import lbfgs as tlbfgs
from gpsat_tpu_torch.ops.transforms import Sigmoid, Softplus
from gpsat_tpu_torch.parallel import mesh as tmesh
from test_torch_engine import (_collapse_case, assert_same_sweep,
                               engine_kwargs, workload)
from test_torch_local_experts import (STORE, assert_tables_close,
                                      golden_config, read)

# many small ops per L-BFGS iteration: one thread per test worker is faster
# than every worker's intra-op pool contending for the same cores
torch.set_num_threads(1)

NAMES = ("lengthscales", "kernel_variance", "likelihood_variance")
N_DEV = 8


def cpu_mesh(n=N_DEV):
    return tmesh.get_mesh(devices=["cpu"] * n)


# ---------------------------------------------------------------------------
# mesh helpers
# ---------------------------------------------------------------------------

def test_pad_to_multiple_matches_jax():
    for n in range(0, 40):
        for m in (1, 2, 3, 8):
            assert tmesh.pad_to_multiple(n, m) == jmesh.pad_to_multiple(n, m)


def test_get_mesh(monkeypatch):
    mesh = cpu_mesh()
    assert mesh.size == N_DEV and mesh.axis_names == ("experts",)
    assert all(d == torch.device("cpu") for d in mesh.devices)
    assert mesh.stream(0) is None
    # n_devices picks among the cards; with devices given it is not used
    assert tmesh.get_mesh(n_devices=2, devices=["cpu"] * 3).size == 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.get_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.get_mesh(devices=["cuda:0", "cuda:0"])


def test_shard_experts_blocks_match_jax():
    """Each shard's block of every leaf (arrays, a bool mask, the tensors of
    Bijectors) equals the JAX package's addressable shard on the device of
    the same mesh position; 0-d leaves go whole to every shard."""
    E, D = 16, 3
    rng = np.random.default_rng(0)
    X = rng.standard_normal((E, 5, D))
    mask = rng.uniform(size=(E, 5)) < 0.7
    lo, hi = rng.uniform(0, 1, (E, D)), rng.uniform(2, 3, (E, D))
    shift = rng.uniform(size=E)
    jt = jmesh.shard_experts(
        (jnp.asarray(X), jnp.asarray(mask),
         {"ls": JaxSigmoid(jnp.asarray(lo), jnp.asarray(hi)),
          "kv": JaxSoftplus(jnp.asarray(shift))}), jmesh.get_mesh())
    t = torch.as_tensor
    parts = tmesh.shard_experts(
        (X, t(mask), {"ls": Sigmoid(t(lo), t(hi)), "kv": Softplus(t(shift)),
                      "scale": torch.tensor(2.5)}), cpu_mesh())
    assert len(parts) == N_DEV
    jleaves = (jt[0], jt[1], jt[2]["ls"].low, jt[2]["ls"].high,
               jt[2]["kv"].shift)

    def tleaves(p):
        return (p[0], p[1], p[2]["ls"].low, p[2]["ls"].high,
                p[2]["kv"].shift)
    for j, leaf in enumerate(jleaves):
        shards = sorted(leaf.addressable_shards, key=lambda s: s.device.id)
        assert len(shards) == N_DEV
        for k, part in enumerate(parts):
            got = tleaves(part)[j]
            assert isinstance(got, torch.Tensor)
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(shards[k].data))
    for part in parts:
        assert part[1].dtype == torch.bool and part[0].dtype == torch.float64
        assert float(part[2]["scale"]) == 2.5
    with pytest.raises(ValueError, match="multiple"):
        tmesh.shard_experts(np.zeros((E + 1, 2)), cpu_mesh())


# ---------------------------------------------------------------------------
# the mesh L-BFGS pool
# ---------------------------------------------------------------------------

def pool_case(E=21, N=30, D=3, seed=3):
    """E GPR NLML problems (E not a mesh multiple) in both packages' args."""
    X, y, mask, _ = workload(E, N, 1, D, seed)
    lo, hi = np.full((E, D), 0.01), np.full((E, D), 50.0)
    jargs = (jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask),
             {"lengthscales": JaxSigmoid(jnp.asarray(lo), jnp.asarray(hi)),
              "kernel_variance": JaxSoftplus(jnp.zeros(E)),
              "likelihood_variance": JaxSigmoid(jnp.full(E, 1e-5),
                                                jnp.full(E, 1.0))}, {})
    t = torch.as_tensor
    targs = (t(X), t(y), t(mask),
             {"lengthscales": Sigmoid(t(lo), t(hi)),
              "kernel_variance": Softplus(torch.zeros(E, dtype=torch.float64)),
              "likelihood_variance": Sigmoid(t(np.full(E, 1e-5)),
                                             t(np.full(E, 1.0)))}, {})
    u0 = np.random.default_rng(seed).standard_normal((E, D + 2)) * 0.3
    return u0, jargs, targs


POOL_OPTS = dict(max_iter=250, gtol=1e-5, ftol=1e-9, max_linesearch_steps=12,
                 recovery_steps=12)
# The two packages' f64 trajectories part by rounding alone, which these
# flat surfaces amplify (see tests/test_torch_local_experts.py,
# CONVERGED_TOL): on these 21 experts, in the one-device pools of both
# packages as in their mesh pools, x agrees to 1.6e-11 after 10 accepted
# steps, 6.1e-10 after 15 and 7.6e-7 after 20, and at the full budget two
# experts end 3 and 4 steps apart. Held against the JAX package at 1e-10,
# each expert stops at 10 steps; the engines below, at assert_same_sweep's
# 1e-6, at 20.
STEP_FOR_STEP = dict(POOL_OPTS, max_iter=10)


def test_mesh_pool_matches_jax_and_the_one_device_pool():
    """E=21 over 8 shards (padded to 24: 3 experts a shard) with 2 slots a
    shard, so slots refill: against the JAX package's mesh pool (10 steps an
    expert), the same iterations, converged and pool iterations, x and f at
    1e-10; against the port's one-device pool at the full budget, every
    field bit for bit."""
    u0, jargs, targs = pool_case()
    jobj, _ = jax_objective("Matern32", NAMES, 3)
    tobj, _ = make_gpr_objective("Matern32", NAMES, 3)
    want = jlbfgs.batched_lbfgs_pool(jobj, jnp.asarray(u0), jargs, slots=2,
                                     mesh=jmesh.get_mesh(), **STEP_FOR_STEP)
    got = tlbfgs.batched_lbfgs_pool(tobj, torch.as_tensor(u0), targs,
                                    slots=2, mesh=cpu_mesh(), **STEP_FOR_STEP)
    assert len(got.shard_pool_iterations) == N_DEV
    assert got.pool_iterations == max(got.shard_pool_iterations) == \
        int(want.pool_iterations)
    for k in ("iterations", "converged"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("x", "fun"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-10, atol=1e-10, err_msg=k)

    got = tlbfgs.batched_lbfgs_pool(tobj, torch.as_tensor(u0), targs,
                                    slots=2, mesh=cpu_mesh(), **POOL_OPTS)
    one = tlbfgs.batched_lbfgs_pool(tobj, torch.as_tensor(u0), targs,
                                    slots=2, **POOL_OPTS)
    assert got.converged.all()
    for k in ("x", "fun", "iterations", "converged"):
        assert torch.equal(got[k], one[k]), k


def test_mesh_pool_slot_width_per_shard():
    """A shard's pool is min(slots, E_pad / n) wide (slots above the experts
    of a shard give every expert a slot from the start: no refill), and a
    one-shard mesh is the one-device pool."""
    u0, _, targs = pool_case(E=10)
    tobj, _ = make_gpr_objective("Matern32", NAMES, 3)
    one = tlbfgs.batched_lbfgs_pool(tobj, torch.as_tensor(u0), targs,
                                    slots=10, **POOL_OPTS)
    for n in (1, 3):
        got = tlbfgs.batched_lbfgs_pool(tobj, torch.as_tensor(u0), targs,
                                        slots=64, mesh=cpu_mesh(n),
                                        **POOL_OPTS)
        for k in ("x", "fun", "iterations", "converged"):
            assert torch.equal(got[k], one[k]), (n, k)
        assert ("shard_pool_iterations" in got) == (n > 1)


# ---------------------------------------------------------------------------
# the engines under the mesh
# ---------------------------------------------------------------------------

def sgpr_kwargs(max_iter=25):
    return dict(coords_dim=3, kernel="Matern32", num_inducing_points=16,
                constraints={"lengthscales": {"low": [0.01] * 3,
                                              "high": [50.0] * 3},
                             "likelihood_variance": {"low": 1e-5,
                                                     "high": 1.0}},
                optim_kwargs={"max_iter": max_iter, "gtol": 1e-5,
                              "ftol": 1e-9}, jitter=1e-6)


def vff_workload(E, N=40, D=2, P=6, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, (E, N, D))
    y = np.sin(X[..., 0]) + 0.3 * np.cos(X[..., 1]) \
        + 0.05 * rng.standard_normal((E, N))
    mask = np.ones((E, N), bool)
    mask[1, 30:] = False
    y = np.where(mask, y - (y * mask).sum(1, keepdims=True)
                 / mask.sum(1, keepdims=True), 0.0)
    return X, y, mask, rng.uniform(-3, 3, (E, P, D))


def gpr_kwargs(max_iter):
    kw = engine_kwargs()
    kw["optim_kwargs"] = dict(kw["optim_kwargs"], max_iter=max_iter)
    return kw


# (engine, kwargs, E, slots, workload): E=20 with 2 slots a shard runs the
# pool (E > 2 x 8); E=16 runs the chunked path, its one chunk of 16 split
# over the 8 shards. GPR stops at 20 steps an expert (STEP_FOR_STEP); its
# one-device comparison below runs the full budget.
ENGINES = {
    "gpr_pool": ("BatchedGPR", gpr_kwargs(20), 20, 2, "gpr"),
    "gpr_chunked": ("BatchedGPR", gpr_kwargs(20), 16, 2, "gpr"),
    "sgpr_pool": ("BatchedSGPR", sgpr_kwargs(), 20, 2, "gpr"),
    "sgpr_chunked": ("BatchedSGPR", sgpr_kwargs(), 16, 2, "gpr"),
    "vff_pool": ("BatchedVFF", dict(coords_dim=2, num_inducing_features=5,
                                    domain_size=4.0,
                                    optim_kwargs={"max_iter": 100}),
                 20, 2, "vff"),
    "svgp_chunked": ("BatchedSVGP", dict(
        coords_dim=2, num_inducing_points=8,
        optim_kwargs={"max_iter": 40, "natural_gradients": True,
                      "gamma": 0.3, "learning_rate": 5e-2}), 16, None, "vff"),
}


@pytest.mark.parametrize("case", ENGINES)
def test_engine_under_mesh_matches_jax(case):
    """fit_predict_many(mesh=...) of each family against the JAX engine's
    under its 8-device mesh (assert_same_sweep: iterations and converged
    equal, objective rtol 1e-6, predictions atol 1e-6; the SGPR inducing
    points equal), and against the port's one-device run of the same
    experts bit for bit (GPR at its full budget)."""
    name, kw, E, slots, wl = ENGINES[case]
    if wl == "gpr":
        X, y, mask, Xs = workload(E, 40, 6, seed=1)
        el = None
    else:
        X, y, mask, Xs = vff_workload(E)
        el = 0.9 * X.mean(axis=1)
    jeng = getattr(jbatched, name)(dtype=jnp.float64, **kw)
    jeng._expert_locs_scaled = el
    want = jeng.fit_predict_many(X, y, mask, Xs=Xs, slots=slots,
                                 mesh=jmesh.get_mesh())
    teng = getattr(tbatched, name)(device="cpu", **kw)
    got = teng.fit_predict_many(X, y, mask, Xs=Xs, slots=slots,
                                expert_locs=el, mesh=cpu_mesh())
    assert_same_sweep(got, want)
    if "inducing_mask" in want:
        np.testing.assert_array_equal(got["inducing_mask"],
                                      want["inducing_mask"])
        np.testing.assert_array_equal(got["params"]["inducing_points"],
                                      want["params"]["inducing_points"])
    pooled = case.endswith("pool")
    assert (getattr(teng, "_last_pool_iterations", 0) > 0) == pooled
    if pooled:
        assert len(teng._last_shard_pool_iterations) == N_DEV
        assert teng._last_pool_iterations == jeng._last_pool_iterations
    if name == "BatchedGPR":
        kw = engine_kwargs()
        got = getattr(tbatched, name)(device="cpu", **kw).fit_predict_many(
            X, y, mask, Xs=Xs, slots=slots, mesh=cpu_mesh())
    one = getattr(tbatched, name)(device="cpu", **kw).fit_predict_many(
        X, y, mask, Xs=Xs, slots=None if slots is None else slots * N_DEV,
        expert_locs=el)
    for k in ("objective", "converged", "iterations"):
        np.testing.assert_array_equal(got[k], one[k], err_msg=k)
    for part in ("params", "preds"):
        for k, v in one[part].items():
            np.testing.assert_array_equal(got[part][k], v, err_msg=k)


def test_collapse_restart_under_mesh_equals_fit_predict():
    """Two experts collapse (kernel variance -> 0); the restart of the
    failed subset runs through the mesh pool and each expert ends as in
    fit_predict's whole-bucket restart (the test of the one-device pool
    restart, tests/test_torch_engine.py). The JAX pool's restart cannot
    serve as the reference: it writes into read-only views of its
    results."""
    X, y, mask, Xs = _collapse_case()
    eng = tbatched.BatchedGPR(device="cpu", **engine_kwargs())
    whole = eng.fit_predict(X, y, mask, Xs=Xs)
    calls = []
    optimize = eng._pool_optimize

    def spy(*a, **k):
        calls.append(k.get("mesh"))
        return optimize(*a, **k)
    eng._pool_optimize = spy
    mesh = cpu_mesh(2)
    pooled = eng.fit_predict_many(X, y, mask, Xs=Xs, slots=3, mesh=mesh)
    assert calls == [mesh, mesh]          # the sweep, then the restart
    assert_same_sweep(pooled, whole, obj_rtol=1e-12, pred_atol=1e-12)


def test_mesh_on_another_device_type_raises():
    X, y, mask, Xs = workload(4, 20, 3)
    eng = tbatched.BatchedGPR(device="cpu", **engine_kwargs())
    mesh = cpu_mesh(2)
    mesh.devices = (torch.device("meta"),) * 2
    with pytest.raises(ValueError, match="device type"):
        eng.fit_predict_many(X, y, mask, Xs=Xs, mesh=mesh)


# ---------------------------------------------------------------------------
# LocalExpertOI.run(use_mesh=True)
# ---------------------------------------------------------------------------

def test_device_count_of_a_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert local_experts._device_count(torch.device("cuda")) == 8
    assert local_experts._device_count(torch.device("cpu")) == 1


def test_run_use_mesh_matches_jax_store(tmp_path, monkeypatch):
    """The golden inputs of tests/test_torch_local_experts.py at 20 L-BFGS
    iterations an expert: the port's run with use_mesh (its device count
    patched to 8, its mesh the 8-shard CPU one) against the JAX package's
    run under its 8-device mesh, every table within 1e-9; without
    use_mesh, no mesh is taken."""
    meshes = []

    def get_mesh():
        meshes.append(cpu_mesh())
        return meshes[-1]
    monkeypatch.setattr(local_experts, "_device_count", lambda device: 8)
    monkeypatch.setattr(local_experts, "get_mesh", get_mesh)
    taken = []
    execute = local_experts.execute_buckets

    def spy(*a, **k):
        taken.append(k.get("mesh"))
        return execute(*a, **k)
    monkeypatch.setattr(local_experts, "execute_buckets", spy)

    paths = {}
    for pkg in ("jax", "torch"):
        cfg = golden_config(pkg)
        cfg["model_config"]["optim_kwargs"] = {"max_iter": 20}
        d = tmp_path / pkg
        d.mkdir()
        monkeypatch.chdir(d)
        if pkg == "jax":
            oi = JaxLocalExpertOI(**cfg)
        else:
            oi = local_experts.LocalExpertOI(device="cpu", **cfg)
        oi.run(store_path=STORE, optimise=True, check_config_compatible=False,
               verbose=False, use_mesh=True)
        paths[pkg] = str(d / STORE)
    assert len(meshes) == 1 and taken == meshes
    got, got_cfg = read("torch", paths["torch"])
    want, want_cfg = read("jax", paths["jax"])
    assert got_cfg == want_cfg
    assert (want["run_details"]["optimise_iterations"] == 20).all()
    assert_tables_close(got, want, 1e-9)

    cfg = golden_config("torch")
    cfg["model_config"]["optim_kwargs"] = {"max_iter": 2}
    local_experts.LocalExpertOI(device="cpu", **cfg).run(
        store_path=str(tmp_path / "no_mesh.h5"), optimise=True,
        check_config_compatible=False, verbose=False, use_mesh=False)
    assert taken[-1] is None and len(meshes) == 1
