#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (gpsat_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. build the CUDA kernels from gpsat_tpu_torch/csrc with nvcc (sm_90a);
  2. hold each kernel against its plain PyTorch version on the card and time
     both with CUDA events: the exact-GPR kernels (value+gradient, value
     only, prediction) on the bench `gpr` recipe (E=64, N=400, P=400, D=3,
     Matern32 and RBF) and at the batch widths the main path gives them; the
     SGPR kernels (cholinv, stream1, stream2, the one-launch value+gradient
     of route "mega") on the bench `sgpr` recipe (N=2000, M=500 padded to
     512, D=3, Matern32 and RBF) at B=64 and at the main path's widths, and
     at those widths route mega's own gv_* kernels by torch.profiler beside
     the same four products as torch.matmul;
  3. drive BatchedGPR.fit_predict_many on the bench `gpr` workload (E=512,
     N=400, P=400, D=3, f32): convergence, finite predictions, agreement with
     an f64 torch.linalg evaluation on all experts, both kernels launched;
     then the bulk NLML evaluation (make_gpr_value_fun) of all 512 experts
     at the optimum the sweep found, in one launch of the value kernel, bit
     for bit the vg kernel's value there;
  4. drive BatchedSGPR.fit_predict_many on the bench `sgpr` workload (E=128,
     N=2000, P=400, M=500, 48 slots, f32) once per route ("hybrid",
     "stream", "mega"): the same checks, the launches of each route's
     kernels, and agreement of the routes' objectives;
  5. the per-expert models GPRModel (one bench `gpr` expert, N=400) and
     SGPRModel (one bench `sgpr` expert, N=2000, M=500) on the card:
     constraints, optimise_parameters, predict, objective value, against
     the same models run on the CPU in f64 from the same start;
  6. the pipeline's device half, local_experts.execute_buckets (what
     LocalExpertOI.run runs between its host gather and its store; the
     card's machine has no pandas or h5py for the rest), at the full-Arctic
     50 km north star: 10 201 experts over several padded N levels, GPRModel
     as configs/example_local_expert_oi.json configures it, f32: launches,
     convergence, every expert against f64 at the fitted parameters (f*,
     f*_var and y_var each at its own tolerance), the kernels against their
     plain versions on the largest level's arrays, RMSE against the truth
     field, one level bit for bit against a direct fit_predict_many, 16
     experts against the same run on the CPU in f64; then 96 experts
     through SGPRModel (M=500, route "mega"), each against f64;
  7. the smoothed re-predict (run_examples.sh step 6) of phase 6's fit:
     the five hyperparameter fields of all 10 201 experts smoothed on the
     card in f64 with configs/example_postprocessing.json's settings
     (postprocessing.smooth_field), each held against the native C++ host
     smoother; then execute_buckets with the smoothed parameters and
     optimise=False: the predict kernel on every level and no vg kernel,
     every expert at 0 iterations and against f64 at the smoothed
     parameters, RMSE against the truth field;
  8. the other model families, which run no kernel of the port (torch ops
     and autograd): the bench `svgp` workload (E=128, N=1000, P=400, D=3,
     M=128, Adam lr 5e-2, one chunk of 128) through BatchedSVGP, the bench
     `vff` workload (E=128, N=1000, P=400, D=2, 361 features, 76 slots)
     through BatchedVFF (m=10) and BatchedASVGP (m=19; in f64, see
     phase_family_bench), cold and warm, every expert's ELBO and
     predictions against f64 at its fitted state; then SVGPModel, VFFModel
     and ASVGPModel through make_engine(get_model(...)) and execute_buckets
     on phase 6's 96 SGPR experts (VFF and ASVGP in boxes about the expert
     locations), each against f64, converged (VFF, ASVGP) and RMSE against
     the truth field; then one expert of each per-expert model on the card
     against its f64 CPU run;
  9. KISS-GP and the multioutput models, which run no kernel of the port
     either: KISSGPModel dense on phase 6's largest expert (x, y, t, the
     automatic grid) and structured on the 20 000 raw along-track points
     nearest the centre expert (x, y; grid 141^2, 30 Adam steps, predictions
     at 400 points), MultioutputGPRModel and MultioutputSVGPModel (linear
     and nonlinear) on a two-instrument fusion of the largest expert, each
     against f64 at the card's state (the fits also against f64 fits on the
     card from the same start, the structured one with the same probes);
     make_engine's engine for each new name;
 10. the expert mesh (every card, or two shards of cuda:0 on their own
     streams): phase 6's GPR and SGPR runs again through
     execute_buckets(mesh=...), each shard's pool iterations, every expert
     against phase 6's one-device run bit for bit (an expert that differs
     is counted and held against f64), a torch.profiler trace in which the
     shards' streams run at once; phase 7's fields through the sharded and
     the tiled smoothers against its dense result; entry_points.
     dryrun_multichip over the mesh; batched_lbfgs(engine="optax") on 8
     bench gpr experts against the custom engine's optimum;
 11. the application drivers (gpsat_tpu_torch.examples) on the card: the
     sea-ice driver's device half from its numpy cores (SGPRModel, M=300,
     route "hybrid", 50 km coords_scale, the driver's constraints) at its
     default 400 km expert spacing and at 50 km, each fit and its smoothed
     re-predict with every expert against f64 at its parameters, four
     experts against the CPU's f64 run, and the merged RMSE against the
     truth; then numerical_stability_check.main on the card (the vg and
     predict kernels in its f32 cases, each jittered f32 case against f64).
The line before the last is a JSON object with one entry per kernel (its
launches in phases 3-4, in phase 6's GPR and SGPR runs, in phase 7, in
phase 10's runs and in phase 11); the last line is {"ok": true, "device":
{...}}. Imports nothing of JAX or gpsat_tpu.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

E_MAIN, E_CMP, N, P, D = 512, 64, 400, 400, 3
E_SGPR, N_SGPR, M_SGPR = 128, 2000, 500     # the bench `sgpr` workload
REPS = 5                    # timed launches per kernel, after one warm-up
# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
_FP32_FLOPS = 67e12
_HBM_BYTES_PER_S = 3.35e12
# cholinv on Kuu: largest accepted max|W^T Kuu W - I| (f64 evaluation of the
# f32 W); see compare_sgpr_kernels
RES_TOL = 0.5


def vg_flops(N, D):
    """Useful flops of one NLML value+gradient evaluation (bench.py
    analytic_flops, exact-GPR per-eval term)."""
    return N ** 3 + N * N * (3 * D + 12 + 3 * (D + 2))


def value_flops(N, D):
    """Useful flops of one NLML value: the factor alone (N^3 / 3) and the
    kernel-matrix build of vg_flops."""
    return N ** 3 / 3.0 + N * N * (3 * D + 12)


def predict_flops(N, P, D):
    """Useful flops of one expert's posterior prediction (bench.py
    analytic_flops, exact-GPR per-prediction term)."""
    return N ** 3 / 3.0 + 2.0 * N * N * P + N * P * (3 * D + 12)


def bound_ms(flops, nbytes):
    t_ops = flops / _FP32_FLOPS
    t_bytes = nbytes / _HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                        else "bytes")


def require(cond, msg):
    """Fail the run (not an assert: it must hold under python -O too)."""
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn):
    """Warm mean milliseconds per call of fn() by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def check_close(name, got, want, rtol, atol):
    got = got.double().cpu().numpy()
    want = want.double().cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)
    return float(np.max(np.abs(got - want)))


def kernel_inputs(workload, E, seed):
    """f32 inputs on the card: the bench workload recipe with fixed random
    hyperparameters near the fitted ones and one partly padded expert."""
    X, y, mask, Xs = workload(E, N, P, D, seed=seed)
    mask = mask.astype(np.float32)
    mask[0, 300:] = 0.0
    rng = np.random.default_rng(seed + 1)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device="cuda")
    params = {"lengthscales": t(rng.uniform(0.5, 2.0, (E, D))),
              "kernel_variance": t(rng.uniform(0.05, 0.5, E)),
              "likelihood_variance": t(rng.uniform(0.01, 0.1, E))}
    return params, t(X), t(y), t(mask), t(Xs)


def check_vg_lanes_f64(cuda_gpr, kernel, inputs, ratio=2.0):
    """The vg kernel's lanes (value, d/dlog lengthscales, d/dlog
    kernel_variance, d/dlikelihood_variance) and its plain version's, both
    f32, against the plain version in f64 on the same packed inputs. At
    fitted parameters (noise near its lower bound, long lengthscales) f32
    rounding alone moves a gradient of the plain version by more than
    compare_kernels' 2e-3, so the kernel's largest error in each lane is
    held to `ratio` times the plain version's, plus that 2e-3. Returns the
    kernel's largest abs error."""
    params, X, y, m, _ = inputs
    D = X.shape[2]
    xt, yt, p, _, _ = cuda_gpr._pack(params, X, y, m, 1e-6)
    ref = cuda_gpr._vg_lanes_plain(xt.double(), yt.double(), p.double(),
                                   kernel, D)
    got = cuda_gpr._vg_launch(xt, yt, p, kernel, D).double()
    plain = cuda_gpr._vg_lanes_plain(xt, yt, p, kernel, D).double()
    worst = 0.0
    for name, ix in (("value", [0]), ("d/dlog lengthscales", [1, 2, 3][:D]),
                     ("d/dlog kernel_variance", [6]),
                     ("d/dlikelihood_variance", [7])):
        ek = float((got[:, ix] - ref[:, ix]).abs().max())
        ep = float((plain[:, ix] - ref[:, ix]).abs().max())
        print(f"  vg {kernel} {name} against f64: kernel max_abs_err "
              f"{ek:.3e}, plain {ep:.3e}, largest |f64| "
              f"{float(ref[:, ix].abs().max()):.3e}")
        require(ek <= ratio * ep + 2e-3, f"vg {kernel} {name}: kernel off "
                f"f64 by {ek:.3e}, more than {ratio} x the plain version's "
                f"{ep:.3e} + 2e-3")
        worst = max(worst, ek)
    return worst


def compare_kernels(cuda_gpr, kernel, inputs, vg_grads="plain"):
    """Max abs errors (vg, value, predict) of each wrapper against its plain
    version; fails beyond the tolerances of tests/test_pallas_gpr.py (the
    value kernel: the vg value's rtol 2e-5 atol 1e-3, against its plain
    version), where the value kernel is not the vg kernel's value bit for
    bit (one factor, one finishing sum), or where a second launch does not
    repeat the first bit for bit. vg_grads="f64" holds the vg gradients by
    check_vg_lanes_f64 instead of against the plain f32 gradients."""
    params, X, y, m, Xs = inputs
    val, g = cuda_gpr.nlml_vg_batched(params, X, y, m, kernel, 1e-6)
    pval, pg = cuda_gpr.nlml_vg_batched_plain(params, X, y, m, kernel, 1e-6)
    err = check_close(f"vg {kernel} value", val, pval, 2e-5, 1e-3)
    if vg_grads == "f64":
        err = max(err, check_vg_lanes_f64(cuda_gpr, kernel, inputs))
    else:
        for k in g:
            err = max(err, check_close(f"vg {kernel} d/d{k}", g[k], pg[k],
                                       2e-3, 2e-3))
    again, ag = cuda_gpr.nlml_vg_batched(params, X, y, m, kernel, 1e-6)
    require(torch.equal(val, again) and all(torch.equal(g[k], ag[k])
                                            for k in g),
            "vg does not repeat bit for bit")
    vonly = cuda_gpr.nlml_value_batched(params, X, y, m, kernel, 1e-6)
    verr = check_close(
        f"value {kernel}", vonly,
        cuda_gpr.nlml_value_batched_plain(params, X, y, m, kernel, 1e-6),
        2e-5, 1e-3)
    check_close(f"value {kernel} against the vg kernel's", vonly, val, 2e-5,
                1e-3)
    require(torch.equal(vonly, val),
            f"value {kernel}: not the vg kernel's value bit for bit")
    require(torch.equal(vonly, cuda_gpr.nlml_value_batched(
        params, X, y, m, kernel, 1e-6)), "value does not repeat bit for bit")
    pr = cuda_gpr.posterior_predict_batched(params, X, y, m, Xs, kernel, 1e-6)
    ppr = cuda_gpr.posterior_predict_batched_plain(params, X, y, m, Xs,
                                                   kernel, 1e-6)
    perr = max(check_close(f"predict {kernel} {k}", pr[k], ppr[k], 1e-3,
                           1e-4) for k in pr)
    again = cuda_gpr.posterior_predict_batched(params, X, y, m, Xs, kernel,
                                               1e-6)
    require(all(torch.equal(pr[k], again[k]) for k in pr),
            "predict does not repeat bit for bit")
    return {"vg": err, "value": verr, "predict": perr}


def check_value_non_pd(cuda_gpr, inputs):
    """One expert with a negative noise: NaN from the value kernel and from
    its plain version for that expert, finite values for the others."""
    params, X, y, m, _ = inputs
    params = {**params, "likelihood_variance":
              params["likelihood_variance"].clone()}
    params["likelihood_variance"][1] = -5.0
    got = cuda_gpr.nlml_value_batched(params, X, y, m, "Matern32", 0.0)
    want = cuda_gpr.nlml_value_batched_plain(params, X, y, m, "Matern32", 0.0)
    for name, v in (("kernel", got), ("plain", want)):
        require(bool(torch.isnan(v[1])), f"value {name}: non-PD is not NaN")
        keep = torch.ones_like(v, dtype=torch.bool)
        keep[1] = False
        require(bool(torch.isfinite(v[keep]).all()),
                f"value {name}: NaN spread to other experts")


def time_kernels(cuda_gpr, kernel, inputs):
    """{kernel: (ms, plain ms, (bound ms, bound_by))} on the packed inputs
    (bytes: inputs read once, outputs written once), and the f32 rounding of
    the vg kernel and its plain version against an f64 evaluation of the
    plain code (NLML value and gradient lanes)."""
    params, X, y, m, Xs = inputs
    E = X.shape[0]
    xt, yt, p, _, _ = cuda_gpr._pack(params, X, y, m, 1e-6)
    xs = cuda_gpr._pack_xs(Xs)
    times = {
        "vg": (cuda_ms(lambda: cuda_gpr._vg_launch(xt, yt, p, kernel, D)),
               cuda_ms(lambda: cuda_gpr._vg_lanes_plain(xt, yt, p, kernel, D)),
               bound_ms(E * vg_flops(N, D), nbytes(xt, yt, p) + E * 8 * 4)),
        "value": (
            cuda_ms(lambda: cuda_gpr._value_launch(xt, yt, p, kernel, D)),
            cuda_ms(lambda: cuda_gpr._value_plain(xt, yt, p, kernel, D)),
            bound_ms(E * value_flops(N, D), nbytes(xt, yt, p) + E * 4)),
        "predict": (
            cuda_ms(lambda: cuda_gpr._predict_launch(xt, yt, p, xs, kernel, D)),
            cuda_ms(lambda: cuda_gpr._predict_plain(xt, yt, p, xs, kernel, D)),
            bound_ms(E * predict_flops(N, P, D),
                     nbytes(xt, yt, p, xs) + 2 * E * xs.shape[2] * 4))}
    ref = cuda_gpr._vg_lanes_plain(xt.double(), yt.double(), p.double(),
                                   kernel, D)
    lanes = [0, *range(1, 1 + D), 6, 7]
    rel = {name: float(torch.max(torch.abs(o[:, lanes] - ref[:, lanes])
                                 / (torch.abs(ref[:, lanes]) + 1e-3)))
           for name, o in (
               ("kernel", cuda_gpr._vg_launch(xt, yt, p, kernel, D)),
               ("plain", cuda_gpr._vg_lanes_plain(xt, yt, p, kernel, D)))}
    return times, rel


def phase_kernels(cuda_gpr, workload, widths):
    """Each kernel against its plain version at the same f32 inputs: E=64
    for Matern32 and RBF, then Matern32 at the batch widths the main path
    gives each kernel (vg: the pool's slots; value: all experts; predict:
    the fill chunk)."""
    errs = {"vg": 0.0, "value": 0.0, "predict": 0.0}
    for kernel in ("Matern32", "RBF"):
        inputs = kernel_inputs(workload, E_CMP, seed=1)
        err = compare_kernels(cuda_gpr, kernel, inputs)
        if kernel == "Matern32":
            check_value_non_pd(cuda_gpr, inputs)
        times, rel = time_kernels(cuda_gpr, kernel, inputs)
        for key in errs:
            errs[key] = max(errs[key], err[key])
            ms, plain_ms, (b_ms, _) = times[key]
            print(f"kernel {key} {kernel} E={E_CMP}: max_abs_err "
                  f"{err[key]:.3e} kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
                  f"bound {b_ms:.4f} ms")
        print(f"  vg {kernel} f32 vs f64 max rel err: {rel}")

    rows = {}
    for key, E in widths.items():
        inputs = kernel_inputs(workload, E, seed=3)
        err = compare_kernels(cuda_gpr, "Matern32", inputs)[key]
        times, _ = time_kernels(cuda_gpr, "Matern32", inputs)
        ms, plain_ms, (b_ms, b_by) = times[key]
        print(f"kernel {key} Matern32 at the main path's width E={E}: "
              f"max_abs_err {err:.3e} kernel {ms:.3f} ms plain "
              f"{plain_ms:.3f} ms bound {b_ms:.4f} ms ({b_by})")
        rows[key] = {"max_abs_err": max(err, errs[key]), "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None}
    return rows


def phase_main(cuda_gpr, workload, bench_gpr_engine, slots):
    """BatchedGPR.fit_predict_many on the bench gpr workload."""
    from gpsat_tpu_torch.ops import gpr as gpr_math

    X, y, mask, Xs = workload(E_MAIN, N, P, D)
    engine = bench_gpr_engine(D)
    require(engine.device.type == "cuda" and engine.dtype == torch.float32,
            f"engine on {engine.device} in {engine.dtype}")

    cuda_gpr.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.fit_predict_many(X, y, mask, Xs=Xs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"nlml_vg": cuda_gpr.nlml_vg_batched.launches,
                "posterior_predict": cuda_gpr.posterior_predict_batched.launches}

    conv = float(np.mean(out["converged"]))
    print(f"main path: E={E_MAIN} N={N} P={P} D={D} slots={slots} "
          f"pool_iters={engine._last_pool_iterations} "
          f"converged={conv:.4f} wall={wall:.3f} s "
          f"experts/s={E_MAIN / wall:.2f} launches={launches}")
    for k in ("f*", "f*_var", "y_var"):
        require(out["preds"][k].shape == (E_MAIN, P),
                f"{k} shape {out['preds'][k].shape}")
        require(np.isfinite(out["preds"][k]).all(), f"non-finite {k}")
    require(np.isfinite(out["objective"]).all(), "non-finite objective")
    require(conv >= 0.99, f"converged fraction {conv} < 0.99")
    require(launches["nlml_vg"] > 0 and launches["posterior_predict"] > 0,
            f"a kernel of the main path was not launched: {launches}")

    # predictions against an f64 torch.linalg evaluation at the fitted
    # parameters, on every expert (64 at a time on the card)
    err, worst = 0.0, None
    for s in range(0, E_MAIN, 64):
        part = slice(s, s + 64)

        def t(a, dtype=torch.float64):
            return torch.tensor(a[part], dtype=dtype, device="cuda")
        ref = gpr_math.predict({k: t(v) for k, v in out["params"].items()},
                               t(X), t(y), t(mask, torch.bool), t(Xs),
                               kernel="Matern32")
        for k in ("f*", "f*_var"):
            e = np.abs(out["preds"][k][part] - ref[k].cpu().numpy())
            if float(e.max()) > err:
                err = float(e.max())
                i, j = np.unravel_index(int(np.argmax(e)), e.shape)
                worst = (k, s + int(i), int(j))
    print(f"main path predictions vs f64 reference (all {E_MAIN} experts): "
          f"max_abs_err {err:.3e} at {worst[0]} of expert {worst[1]}, "
          f"point {worst[2]}")
    require(err < 1e-2, f"main-path predictions disagree with f64: {err}")
    launches["nlml_value"] = phase_bulk_nlml(cuda_gpr, engine, out, X, y,
                                             mask)
    return launches


def phase_bulk_nlml(cuda_gpr, engine, out, X, y, mask):
    """make_gpr_value_fun on every expert of the sweep at the optimum it
    found, in one launch of the value kernel, and the vg kernel's value at
    the same u: each against ops/gpr.nlml in f64 on all experts at rtol 1e-3
    atol 2e-2, and the two against each other at rtol 2e-5 atol 1e-3 (the
    value tolerance of tests/test_pallas_gpr.py) and bit for bit. At the
    optimum the fitted noise is ~1e-3 of the signal variance, and any f32
    factorisation of an N=400 matrix of that conditioning is off f64 by up
    to ~4e-4 of the value (torch.linalg's in f32 too, printed beside them):
    two f32 kernels agree closer than that only where they share one
    factorisation, as the value and vg kernels do (cholinv's bordered
    schedule and one finishing sum)."""
    from gpsat_tpu_torch.models.exact_gpr import (make_gpr_value_fun,
                                                  make_gpr_vg_fun)
    from gpsat_tpu_torch.ops import gpr as gpr_math
    E = X.shape[0]
    u = engine._unconstrained(out["params"], E)
    args = (u, engine._tensor(X), engine._tensor(y),
            engine._tensor(mask, torch.bool), engine._batched_bijectors(E),
            {})
    value_fun = make_gpr_value_fun(engine.kernel, engine.free_names, D)
    cuda_gpr.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    val = value_fun(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cuda_gpr.nlml_value_batched.launches
    require(launches == 1 and cuda_gpr.nlml_vg_batched.launches == 0,
            f"bulk NLML launches: {cuda_gpr.launch_counts()}")
    require(val.shape == (E,) and bool(torch.isfinite(val).all()),
            "bulk NLML: non-finite or misshapen values")
    vg_val, _ = make_gpr_vg_fun(engine.kernel, engine.free_names, D)(*args)

    def t(a, dtype):
        return torch.tensor(a, dtype=dtype, device="cuda")
    ref, lib32 = [], []
    for s in range(0, E, 64):
        part = slice(s, s + 64)
        prm = {k: t(v[part], torch.float64) for k, v in out["params"].items()}
        ref.append(gpr_math.nlml(prm, t(X[part], torch.float64),
                                 t(y[part], torch.float64),
                                 t(mask[part], torch.bool),
                                 kernel=engine.kernel))
        lib32.append(cuda_gpr.nlml_value_batched_plain(
            {k: v.float() for k, v in prm.items()}, t(X[part], torch.float32),
            t(y[part], torch.float32), t(mask[part], torch.float32),
            engine.kernel, 0.0))
    ref, lib32 = torch.cat(ref), torch.cat(lib32)
    err64 = check_close("bulk NLML against f64 nlml", val, ref, 1e-3, 2e-2)
    errvg = check_close("the vg kernel's value against f64 nlml", vg_val, ref,
                        1e-3, 2e-2)
    err = check_close("bulk NLML against the vg kernel's value", val, vg_val,
                      2e-5, 1e-3)
    require(torch.equal(val, vg_val),
            "bulk NLML: the value kernel and the vg kernel's value differ")

    def rel(a):
        r = ((a.double() - ref).abs() / ref.abs()).cpu()
        return f"max {float(r.max()):.3e} median {float(r.median()):.3e}"
    print(f"bulk NLML: E={E} in one launch, wall={wall * 1e3:.3f} ms; vs f64 "
          f"nlml (|value| up to {float(ref.abs().max()):.1f}) max_abs_err "
          f"{err64:.3e}, rel {rel(val)}; the vg kernel's value vs f64 "
          f"max_abs_err {errvg:.3e}, rel {rel(vg_val)}; torch.linalg f32 vs "
          f"f64 rel {rel(lib32)}; bulk vs the vg kernel's value max_abs_err "
          f"{err:.3e}")
    return launches



# ---------------------------------------------------------------------------
# SGPR kernels and sweep
# ---------------------------------------------------------------------------

def sgpr_kernel_inputs(workload, engine, E, kernel, seed):
    """Packed f32 inputs of the SGPR kernels on the card: the bench `sgpr`
    recipe with the engine's inducing points, fixed random hyperparameters
    and one expert with short data and inducing masks. RBF gets 0.15 of the
    lengthscales: with 500 inducing points at U(0.5, 2) its Kuu is not
    positive definite in f32 (for cuSOLVER as for the kernel)."""
    from gpsat_tpu_torch.ops import cuda_sgpr
    X, y, mask, _ = workload(E, N_SGPR, 1, D, seed=seed)
    mask = mask.copy()
    mask[0, 1500:] = False
    Z, zmask = engine._build_inducing(X, mask)
    zmask[0, 300:] = False
    Z[0, 300:] = 0.0
    rng = np.random.default_rng(seed + 1)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device="cuda")
    ls = rng.uniform(0.5, 2.0, (E, D)) * (0.15 if kernel == "RBF" else 1.0)
    params = {"lengthscales": t(ls),
              "kernel_variance": t(rng.uniform(0.05, 0.5, E)),
              "likelihood_variance": t(rng.uniform(0.01, 0.1, E))}
    args = (params, t(X), t(y), t(mask), t(Z), t(zmask))
    Xp, Zp, m, zm, ls, _, sf2, s2, ybar = cuda_sgpr._prepare(*args)
    Kuu = cuda_sgpr._kuu(Zp / ls[:, None, :], zm, sf2, kernel, 1e-6)[0]
    packed = cuda_sgpr._pack_stream(Xp, m, ybar, Zp, zm, ls, sf2, s2)
    counts = (mask.sum(axis=1).astype(float), zmask.sum(axis=1).astype(float))
    return Kuu, packed, counts, args


def cholinv_residual(A, W):
    """max |W^T A W - I| over the batch, evaluated in f64: zero for the exact
    W = U^-1 of A = U^T U, whatever the conditioning of A."""
    W = W.double()
    eye = torch.eye(A.shape[1], dtype=torch.float64, device=A.device)
    return float((W.mT @ A.double() @ W - eye).abs().max())


def cholinv_library(A):
    """The two PyTorch calls that compute cholinv's function."""
    L, _ = torch.linalg.cholesky_ex(A)
    eye = torch.eye(A.shape[1], dtype=A.dtype, device=A.device)
    return torch.linalg.solve_triangular(L.mT, eye.expand_as(L), upper=True)


def check_cholinv_non_pd(Bm, W, ld):
    """A negative pivot in a later tile column of matrix 1 (row 300 of 512):
    its ld is not finite, every other matrix's W and ld are those of the
    launch without it, bit for bit, and W stays exactly upper."""
    from gpsat_tpu_torch.ops import cuda_cholinv
    bad = Bm.clone()
    bad[1, 300, 300] = -1.0
    Wb, ldb = cuda_cholinv.cholinv_batched(bad)
    keep = torch.ones(Bm.shape[0], dtype=torch.bool, device=Bm.device)
    keep[1] = False
    require(not bool(torch.isfinite(ldb[1])), "cholinv: non-PD ld is finite")
    require(torch.equal(Wb[keep], W[keep]) and torch.equal(ldb[keep],
                                                           ld[keep]),
            "cholinv: a non-PD matrix changed another matrix's outputs")
    require((Wb.tril(-1) == 0).all(), "cholinv: non-PD W not exactly upper")


def compare_sgpr_kernels(kernel, Kuu, packed):
    """Max abs errors of cholinv, stream1 and stream2 against their plain
    versions on one set of inputs. Tolerances of the JAX package's tests
    (tests/test_pallas_cholinv.py, tests/test_pallas_sgpr.py at N=2000): W
    rtol 2e-3 atol 2e-3 and ld rtol 1e-4 atol 1e-4 on B = I + A~A~^T/s2;
    the streamed sums and gradient lanes rtol 1e-2 atol 1e-2, a~ and trA2
    rtol 5e-4 atol 2e-2. Kuu carries jitter 1e-6 and a condition number
    near 1/eps(f32), so two f32 factorisations of it differ entry by entry
    far beyond that. Its W is held by what defines it instead, whatever the
    conditioning: the residual max|W^T Kuu W - I|, evaluated in f64, at most
    RES_TOL and at most five times the residual of the cuSOLVER-based plain
    version. On an H100 both lie between 5e-3 and 1e-1 over 48 to 128
    matrices, the kernel's up to 2.7 times the plain's; an error e in one
    entry of W adds about e sqrt(sf2), so one of the size of a typical
    entry (200) gives a residual near 100 and one of 1 % of it fails too.
    Kuu is also held through what consumes W (Bsum from the kernel's W
    against Bsum from the plain W)."""
    from gpsat_tpu_torch.ops import cuda_cholinv, cuda_sgpr
    xt, yt, zt, p = packed
    Mp = zt.shape[2]
    eye = torch.eye(Mp, dtype=torch.float32, device="cuda")

    W_u, ld_u = cuda_cholinv.cholinv_batched(Kuu)
    Wp_u, ldp_u = cuda_cholinv.cholinv_batched_plain(Kuu)
    require((W_u.tril(-1) == 0).all(), "cholinv: W not exactly upper")
    require(torch.isfinite(ld_u).all() and torch.isfinite(ldp_u).all(),
            f"cholinv {kernel}: Kuu of the comparison is not positive definite")
    res_k, res_p = cholinv_residual(Kuu, W_u), cholinv_residual(Kuu, Wp_u)
    print(f"  cholinv {kernel} Kuu (jitter 1e-6): max|W^T Kuu W - I| in f64 "
          f"kernel {res_k:.3e} plain {res_p:.3e} "
          f"(max |W| {float(W_u.abs().max()):.1f})")
    require(res_k <= RES_TOL and res_k <= 5.0 * res_p + 1e-4,
            f"cholinv Kuu {kernel}: residual {res_k} (plain {res_p})")
    check_close(f"cholinv {kernel} Kuu ld", ld_u, ldp_u, 1e-4, 1e-4)

    got1 = cuda_sgpr.sgpr_stream1(xt, yt, zt, p, W_u, kernel, D)
    want1 = cuda_sgpr._stream1_plain(xt, yt, zt, p, W_u, kernel, D)
    e1 = max(check_close(f"stream1 {kernel} Bsum", got1[0], want1[0], 1e-2, 1e-2),
             check_close(f"stream1 {kernel} a~", got1[1], want1[1], 5e-4, 2e-2),
             check_close(f"stream1 {kernel} trA2", got1[2], want1[2], 5e-4,
                         2e-2))
    require((got1[0] == got1[0].mT).all(), "stream1: Bsum not symmetric")
    again = cuda_sgpr.sgpr_stream1(xt, yt, zt, p, W_u, kernel, D)
    require(all(torch.equal(a, b) for a, b in zip(got1, again)),
            "stream1 does not repeat bit for bit")
    via_plain_W = cuda_sgpr._stream1_plain(xt, yt, zt, p, Wp_u, kernel, D)[0]
    check_close(f"cholinv {kernel} Kuu through Bsum", got1[0], via_plain_W,
                2e-3, 2e-3 * float(via_plain_W.abs().max()))

    Bm = want1[0] + eye
    W_B, ld_B = cuda_cholinv.cholinv_batched(Bm)
    Wp_B, ldp_B = cuda_cholinv.cholinv_batched_plain(Bm)
    require((W_B.tril(-1) == 0).all(), "cholinv: W_B not exactly upper")
    ec = check_close(f"cholinv {kernel} B W", W_B, Wp_B, 2e-3, 2e-3)
    check_close(f"cholinv {kernel} B ld", ld_B, ldp_B, 1e-4, 1e-4)
    again = cuda_cholinv.cholinv_batched(Bm)
    require(torch.equal(W_B, again[0]) and torch.equal(ld_B, again[1]),
            "cholinv does not repeat bit for bit")
    check_cholinv_non_pd(Bm, W_B, ld_B)

    c = (want1[1][:, None, :] @ Wp_B)[:, 0, :]
    dd = (Wp_B @ c[:, :, None])[:, :, 0].contiguous()
    Pm = (Wp_B @ (Wp_B.mT @ want1[0])).contiguous()
    got2 = cuda_sgpr.sgpr_stream2(xt, yt, zt, p, W_u, Pm, dd, kernel, D)
    want2 = cuda_sgpr._stream2_plain(xt, yt, zt, p, W_u, Pm, dd, kernel, D)
    e2 = check_close(f"stream2 {kernel} gout", got2, want2, 1e-2, 1e-2)
    again = cuda_sgpr.sgpr_stream2(xt, yt, zt, p, W_u, Pm, dd, kernel, D)
    require(torch.equal(got2, again), "stream2 does not repeat bit for bit")

    # the one-launch value + gradient: value rtol 2e-4 atol 1e-3 (the value
    # tolerance of tests/test_pallas_sgpr.py), gradient lanes rtol 1e-2 atol
    # 1e-2 as the stream lanes; it factors Kuu itself, so its W_u is the
    # kernel's and the plain version's is cuSOLVER's
    gotm = cuda_sgpr.sgpr_vg_mega(xt, yt, zt, p, kernel, D, 1e-6)
    wantm = cuda_sgpr._mega_plain(xt, yt, zt, p, kernel, D, 1e-6)
    em = check_close(f"mega {kernel} value", gotm[:, 0], wantm[:, 0], 2e-4,
                     1e-3)
    em = max(em, check_close(f"mega {kernel} gradient lanes", gotm[:, 1:],
                             wantm[:, 1:], 1e-2, 1e-2))
    require(torch.equal(gotm, cuda_sgpr.sgpr_vg_mega(xt, yt, zt, p, kernel,
                                                     D, 1e-6)),
            "sgpr_vg_mega does not repeat bit for bit")
    return ({"cholinv": ec, "sgpr_stream1": e1, "sgpr_stream2": e2,
             "sgpr_vg_mega": em}, (Kuu, Bm, W_u, Pm, dd))


def check_sgpr_value_f64(kernel, args):
    """sgpr_vg_batched on every route against ops/sgpr.neg_elbo in f64 on
    the same inputs, at the random hyperparameters of the kernel comparison
    (N=2000, M=500, the first 8 experts, one with short masks): value rtol
    5e-4 atol 2e-2, the tolerance of tests/test_pallas_sgpr.py at N=2000."""
    from gpsat_tpu_torch.ops import cuda_sgpr
    from gpsat_tpu_torch.ops import sgpr as sgpr_math
    n = 8
    params, X, y, mask, Z, zmask = args
    params = {k: v[:n] for k, v in params.items()}
    rest = (X[:n], y[:n], mask[:n], Z[:n], zmask[:n])
    ref = sgpr_math.neg_elbo(
        {k: v.double() for k, v in params.items()}, rest[0].double(),
        rest[1].double(), rest[2].bool(), rest[3].double(), rest[4].bool(),
        kernel=kernel, jitter=1e-6)
    for route in cuda_sgpr.ROUTES:
        val, _ = cuda_sgpr.sgpr_vg_batched(params, *rest, kernel, 1e-6,
                                           route=route)
        rel = float(((val.double() - ref).abs() / ref.abs()).max())
        print(f"  sgpr value {kernel} route={route} vs f64 neg_elbo ({n} "
              f"experts, random hyperparameters): max rel err {rel:.3e}")
        check_close(f"sgpr value {kernel} {route} vs f64", val, ref, 5e-4,
                    2e-2)


def time_sgpr_kernels(kernel, packed, counts, mats):
    """{kernel: row} with ms, plain_ms, bound_ms, bound_by, library_ms.
    Useful flops from each expert's valid counts n, m: kernel build
    m n (3D+8); the two products with the upper-triangular W_u (A~ = W_u^T
    Kuf, W_u v) m^2 n each, half of a dense product, as the kernels skip
    W_u's zero half; the symmetric A~A~^T m^2 n; the dense P A~ 2 m^2 n;
    (D+2) elementwise contractions 3 m n each. So stream1 does 2 m^2 n and
    stream2 4 m^2 n. Bytes: each input once (W_u as its upper half), each
    output once. cholinv 2 M^3 / 3 flops and 8 M^2 bytes per matrix (both
    factorisations of a trial have the padded M)."""
    from gpsat_tpu_torch.ops import cuda_cholinv, cuda_sgpr
    xt, yt, zt, p = packed
    Kuu, Bm, W_u, Pm, dd = mats
    n, m = counts
    B, Mp = Kuu.shape[0], Kuu.shape[1]
    build = float(np.sum(m * n)) * (3 * D + 8)
    m2n = float(np.sum(m * m * n))
    mn = float(np.sum(m * n))
    rows = {}

    def row(fn, plain, flops, nbytes_, library=None):
        b_ms, b_by = bound_ms(flops, nbytes_)
        return {"ms": cuda_ms(fn), "plain_ms": cuda_ms(plain),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None if library is None else cuda_ms(library)}
    rows["cholinv"] = row(
        lambda: cuda_cholinv.cholinv_batched(Bm),
        lambda: cuda_cholinv.cholinv_batched_plain(Bm),
        B * 2.0 * Mp ** 3 / 3.0, B * 8 * Mp * Mp,
        lambda: cholinv_library(Bm))
    rows["sgpr_stream1"] = row(
        lambda: cuda_sgpr.sgpr_stream1(xt, yt, zt, p, W_u, kernel, D),
        lambda: cuda_sgpr._stream1_plain(xt, yt, zt, p, W_u, kernel, D),
        build + 2.0 * m2n + 3.0 * mn,
        nbytes(xt, yt, zt, p) + nbytes(W_u) // 2
        + B * (Mp * Mp + Mp + 1) * 4)
    rows["sgpr_stream2"] = row(
        lambda: cuda_sgpr.sgpr_stream2(xt, yt, zt, p, W_u, Pm, dd, kernel, D),
        lambda: cuda_sgpr._stream2_plain(xt, yt, zt, p, W_u, Pm, dd, kernel,
                                         D),
        build + 4.0 * m2n + 3.0 * (D + 2) * mn,
        nbytes(xt, yt, zt, p, Pm, dd) + nbytes(W_u) // 2 + B * 8 * 4)
    rows["sgpr_vg_mega"] = row(
        lambda: cuda_sgpr.sgpr_vg_mega(xt, yt, zt, p, kernel, D, 1e-6),
        lambda: cuda_sgpr._mega_plain(xt, yt, zt, p, kernel, D, 1e-6),
        2.0 * build + float(np.sum(m * m)) * (3 * D + 8) + 6.0 * m2n
        + 3.0 * (D + 3) * mn
        + B * (2.0 * 2.0 / 3.0 + 3.0 + 2.0 / 3.0) * Mp ** 3,
        nbytes(xt, yt, zt, p) + B * 8 * 4)
    return rows


def time_gv_share(kernel, packed, mats):
    """Route mega's own kernels in one sgpr_vg_mega call, by torch.profiler
    (device_profile.gv_share_ms): {"products": the four P6 products, "p5":
    the P5 matvecs and scalars, "rest": Kuu, I + Bsum, the finish} in ms,
    "products_bound_ms": their useful FP32 flops (11/3 Mp^3 an expert: T1,
    P and T2 with a triangular operand, Kbar_uu's upper pairs) over the
    peak, and "matmul_ms": the same four products as torch.matmul on the
    same tensors (TF32 off; full products), the library yardstick."""
    from gpsat_tpu_torch.ops import cuda_cholinv, cuda_sgpr
    from gpsat_tpu_torch.device_profile import gv_share_ms
    xt, yt, zt, p = packed
    _, Bm, W_u, _, _ = mats
    B, Mp = Bm.shape[0], Bm.shape[1]
    Bsum = Bm - torch.eye(Mp, device="cuda")
    W_B = cuda_cholinv.cholinv_batched(Bm)[0]

    def matmuls():
        T1 = W_B.mT @ Bsum
        P = W_B @ T1
        return W_u @ ((Bsum - P) @ W_u.mT)
    out = gv_share_ms(
        lambda: cuda_sgpr.sgpr_vg_mega(xt, yt, zt, p, kernel, D, 1e-6), REPS)
    out["products_bound_ms"] = bound_ms(B * 11.0 / 3.0 * Mp ** 3, 0)[0]
    out["matmul_ms"] = cuda_ms(matmuls)
    return out


def phase_sgpr_kernels(workload, engine, widths):
    """cholinv, stream1, stream2 and the one-launch value + gradient against
    their plain versions: B=64 for Matern32 and RBF, then Matern32 at the
    widths the main path gives them (`widths`: the pool's slots for all
    four, and the fill chunk's width for cholinv, which is reported on a
    line of its own)."""
    errs = {"cholinv": 0.0, "sgpr_stream1": 0.0, "sgpr_stream2": 0.0,
            "sgpr_vg_mega": 0.0}
    for kernel in ("Matern32", "RBF"):
        Kuu, packed, counts, args = sgpr_kernel_inputs(workload, engine,
                                                       E_CMP, kernel, seed=1)
        err, mats = compare_sgpr_kernels(kernel, Kuu, packed)
        check_sgpr_value_f64(kernel, args)
        times = time_sgpr_kernels(kernel, packed, counts, mats)
        for key in errs:
            errs[key] = max(errs[key], err[key])
            r = times[key]
            print(f"kernel {key} {kernel} B={E_CMP}: max_abs_err "
                  f"{err[key]:.3e} kernel {r['ms']:.3f} ms plain "
                  f"{r['plain_ms']:.3f} ms bound {r['bound_ms']:.4f} ms")
    rows = {}
    for width in sorted(set(widths.values())):
        Kuu, packed, counts, _ = sgpr_kernel_inputs(workload, engine, width,
                                                    "Matern32", seed=3)
        err, mats = compare_sgpr_kernels("Matern32", Kuu, packed)
        times = time_sgpr_kernels("Matern32", packed, counts, mats)
        for key in errs:
            r = times[key]
            print(f"kernel {key} Matern32 at width B={width}: max_abs_err "
                  f"{err[key]:.3e} kernel {r['ms']:.3f} ms plain "
                  f"{r['plain_ms']:.3f} ms library {r['library_ms']} ms "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
            if width == widths["pool"]:
                rows[key] = {"max_abs_err": max(err[key], errs[key]), **r}
        gv = time_gv_share("Matern32", packed, mats)
        require(gv["products"] > 0 and gv["p5"] > 0,
                f"no gv_* kernel in the profile of sgpr_vg_mega: {gv}")
        print(f"kernel sgpr_vg_mega Matern32 at width B={width}, its own "
              f"gv_* kernels: P6 products {gv['products']:.4f} ms (bound "
              f"{gv['products_bound_ms']:.4f} ms; torch.matmul of the four "
              f"products {gv['matmul_ms']:.4f} ms), P5 {gv['p5']:.4f} ms, "
              f"rest {gv['rest']:.4f} ms")
        if width == widths["pool"]:
            rows["sgpr_vg_mega"].update(
                {"gv_" + k + ("" if k.endswith("_ms") else "_ms"): v
                 for k, v in gv.items()})
        require(times["cholinv"]["ms"] < times["cholinv"]["library_ms"],
                f"cholinv at B={width} is slower than torch.linalg: "
                f"{times['cholinv']}")
    return rows


def phase_sgpr_main(cuda_gpr, workload, bench_sgpr_engine, slots):
    """BatchedSGPR.fit_predict_many on the bench sgpr workload, once per
    route. Returns {kernel name: launches} of each route's run."""
    from gpsat_tpu_torch.ops import cuda_sgpr
    from gpsat_tpu_torch.ops import sgpr as sgpr_math

    X, y, mask, Xs = workload(E_SGPR, N_SGPR, P, D)
    outs, launches = {}, {}
    for route in cuda_sgpr.ROUTES:
        engine = bench_sgpr_engine(D, M_SGPR, route=route)
        require(engine.device.type == "cuda" and
                engine.dtype == torch.float32,
                f"engine on {engine.device} in {engine.dtype}")
        cuda_gpr.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.fit_predict_many(X, y, mask, Xs=Xs, slots=slots)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in cuda_gpr.launch_counts().items() if v}
        conv = float(np.mean(out["converged"]))
        print(f"sgpr sweep route={route}: E={E_SGPR} N={N_SGPR} P={P} D={D} "
              f"M={M_SGPR} slots={slots} "
              f"pool_iters={engine._last_pool_iterations} "
              f"converged={conv:.4f} wall={wall:.3f} s "
              f"experts/s={E_SGPR / wall:.2f} launches={counts} peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        for k in ("f*", "f*_var", "y_var"):
            require(out["preds"][k].shape == (E_SGPR, P),
                    f"{k} shape {out['preds'][k].shape}")
            require(np.isfinite(out["preds"][k]).all(), f"non-finite {k}")
        require(np.isfinite(out["objective"]).all(), "non-finite objective")
        require(conv >= 0.99, f"{route}: converged fraction {conv} < 0.99")
        require(counts.get("cholinv", 0) > 0, f"cholinv not launched: {counts}")
        # each route launches its own kernels and none of another's (the
        # mega route's streamed passes are enqueued inside its one entry)
        own = {"hybrid": (), "stream": ("sgpr_stream1", "sgpr_stream2"),
               "mega": ("sgpr_vg_mega",)}[route]
        trials = engine._last_pool_iterations + 1
        for name in ("sgpr_stream1", "sgpr_stream2", "sgpr_vg_mega"):
            require(counts.get(name, 0) == (trials if name in own else 0),
                    f"{route}: launches {counts} over {trials} trials")

        # predictions against an f64 ops/sgpr.predict at the fitted
        # parameters and the engine's inducing points, on the first experts
        n = 8
        params = {k: torch.tensor(out["params"][k][:n], dtype=torch.float64)
                  for k in engine.HYPER_NAMES}
        ref = sgpr_math.predict(
            params, torch.tensor(X[:n]), torch.tensor(y[:n]),
            torch.tensor(mask[:n]),
            torch.tensor(out["params"]["inducing_points"][:n]),
            torch.tensor(out["inducing_mask"][:n]), torch.tensor(Xs[:n]),
            kernel="Matern32", jitter=1e-6)
        err = max(float(np.max(np.abs(out["preds"][k][:n] - ref[k].numpy())))
                  for k in ("f*", "f*_var"))
        print(f"  {route} predictions vs f64 reference ({n} experts): "
              f"max_abs_err {err:.3e}")
        require(err < 2e-2, f"{route}: predictions disagree with f64: {err}")
        outs[route], launches[route] = out, counts

    # The routes compute one objective: at the same parameters (the
    # hybrid sweep's optima, where Kuu is near singular in f32) their values
    # agree to twice the f32 tolerance of the kernels (rtol 1e-3 atol 2e-2),
    # and the hybrid's with the sweep's reported ELBO to rtol 5e-4. An
    # f64 ops/sgpr.neg_elbo at those parameters is printed beside them and
    # held only to 5 %: the f32 optimiser runs the lengthscales up to where
    # Kuu (jitter 1e-6) is near singular in f32, and there any f32
    # evaluation of the collapsed bound is tens of nats off the f64 one
    # (at random hyperparameters it agrees to rtol 5e-4: phase 2,
    # check_sgpr_value_f64). The JAX package's f32 sweep ends the same way:
    # tests/test_torch_sgpr_engine.py::
    # test_f32_sweep_ends_where_f32_cannot_evaluate_the_bound.
    n = 16
    hyb = outs["hybrid"]

    def t(a, dtype=torch.float32):
        return torch.tensor(a[:n], dtype=dtype, device="cuda")
    args = ({k: t(hyb["params"][k]) for k in engine.HYPER_NAMES}, t(X), t(y),
            t(mask), t(hyb["params"]["inducing_points"]),
            t(hyb["inducing_mask"]))
    val_h, _ = cuda_sgpr.sgpr_vg_batched(*args, "Matern32", 1e-6,
                                         route="hybrid")
    val_s, _ = cuda_sgpr.sgpr_vg_batched(*args, "Matern32", 1e-6,
                                         route="stream")
    val_m, _ = cuda_sgpr.sgpr_vg_batched(*args, "Matern32", 1e-6,
                                         route="mega")
    ref = sgpr_math.neg_elbo(
        {k: torch.tensor(hyb["params"][k][:4], dtype=torch.float64)
         for k in engine.HYPER_NAMES}, torch.tensor(X[:4]),
        torch.tensor(y[:4]), torch.tensor(mask[:4]),
        torch.tensor(hyb["params"]["inducing_points"][:4]),
        torch.tensor(hyb["inducing_mask"][:4]), kernel="Matern32",
        jitter=1e-6)
    err = check_close("routes' values at the same parameters", val_s, val_h,
                      1e-3, 2e-2)
    err_m = check_close("mega route's value at the same parameters", val_m,
                        val_h, 1e-3, 2e-2)
    check_close("reported ELBO", -val_h, torch.tensor(hyb["objective"][:n]),
                5e-4, 2e-2)
    err64 = check_close("hybrid value vs f64", val_h[:4], ref, 5e-2, 0.0)
    print(f"  objective at the hybrid optima: hybrid vs stream max abs diff "
          f"{err:.3e}, hybrid vs mega {err_m:.3e}, hybrid vs f64 {err64:.3e}")
    # The optima themselves: in f32 the pools stop on f-stagnation (ftol
    # 1e-9 is below the f32 resolution of a value of order 3e3), at nearby
    # points of a flat optimum where the f32 value itself is uncertain, so
    # they are held loosely: the median difference to 0.5 % of the mean
    # |ELBO|, every expert to 5 %. Each route's reported (f32) ELBO is also
    # held to 5 % of the f64 ELBO at its own optimum: an f32 factorisation
    # that breaks down where Kuu is near singular lets the optimiser stop
    # where the f32 bound is hundreds of nats too high (a cholinv whose
    # panels used the explicit inverse of the diagonal tile did, at 2 of 128
    # experts; tools/compare_sgpr_optima.py tells such points apart).
    def elbo64(out, chunk=16):
        vals = []
        for s in range(0, E_SGPR, chunk):
            part = slice(s, s + chunk)
            prm = {k: torch.tensor(out["params"][k][part],
                                   dtype=torch.float64, device="cuda")
                   for k in engine.HYPER_NAMES}
            vals.append(sgpr_math.elbo(
                prm, *(torch.tensor(v[part], dtype=torch.float64,
                                    device="cuda")
                       for v in (X, y, mask, out["params"]["inducing_points"],
                                 out["inducing_mask"])),
                kernel="Matern32", jitter=1e-6).cpu().numpy())
        return np.concatenate(vals)

    a = hyb["objective"]
    for route in cuda_sgpr.ROUTES:
        b = outs[route]["objective"]
        gap = np.abs(b - elbo64(outs[route]))
        print(f"  {route}: reported (f32) ELBO vs f64 at its optima: median "
              f"{np.median(gap):.3e} max {gap.max():.3e}")
        require((gap <= 5e-2 * np.abs(b)).all(),
                f"{route}: reported ELBO off f64 by {gap.max()} at expert "
                f"{int(np.argmax(gap))}")
        if route == "hybrid":
            continue
        diff = np.abs(a - b)
        print(f"  ELBO at the optima of hybrid and {route}: max abs diff "
              f"{diff.max():.3e} median {np.median(diff):.3e} (mean |ELBO| "
              f"{np.mean(np.abs(a)):.1f})")
        require(np.median(diff) <= 5e-3 * np.mean(np.abs(a)),
                f"median ELBO difference hybrid / {route} {np.median(diff)}")
        np.testing.assert_allclose(a, b, rtol=5e-2)
    return launches


# ---------------------------------------------------------------------------
# per-expert models
# ---------------------------------------------------------------------------

def phase_models(workload, common):
    """GPRModel on one bench `gpr` expert and SGPRModel on one bench `sgpr`
    expert, on the card in f32, through the calls a user makes (construct,
    set_parameter_constraints, optimise_parameters, predict,
    get_objective_function_value), held against the same model run on the
    CPU in f64 from the same start. The two runs are two optimisations, one
    in f32 and one in f64, on a surface that is flat along the long
    lengthscales they end at: predictions GPR rtol 1e-3 atol 5e-3 (the
    exact-GPR sweep's f32 predictions are already 9e-4 from f64 at the same
    parameters, and here the parameters differ too: 1.6e-3 on an H100), SGPR
    rtol 5e-3 atol 5e-3; objective rtol 1e-3 (GPR) and 1e-2 (SGPR)."""
    from gpsat_tpu_torch.models import get_model
    cons = common["constraints"]
    opt = common["optim_kwargs"]
    for name, n_obs, extra, tol, otol in (
            ("GPRModel", N, {}, (1e-3, 5e-3), 1e-3),
            ("SGPRModel", N_SGPR, {"num_inducing_points": M_SGPR,
                                   "jitter": common["jitter"]},
             (5e-3, 5e-3), 1e-2)):
        X, y, _, Xs = workload(1, n_obs, P, D, seed=11)
        res = {}
        for device in ("cuda", "cpu"):
            model = get_model(name)(
                coords=X[0], obs=y[0], kernel=common["kernel"],
                device=None if device == "cuda" else "cpu", **extra)
            require(model.device.type == device and model.dtype == (
                torch.float32 if device == "cuda" else torch.float64),
                f"{name} on {model.device} in {model.dtype}")
            model.set_parameter_constraints(cons, move_within_tol=True,
                                            tol=1e-2)
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            ok = model.optimise_parameters(**opt)
            preds = model.predict(Xs[0])
            obj = model.get_objective_function_value()
            if device == "cuda":
                torch.cuda.synchronize()
            res[device] = (ok, preds, obj, time.perf_counter() - t0, model)
        (ok, preds, obj, wall, model), (ok64, ref, obj64, wall64, _) = \
            res["cuda"], res["cpu"]
        require(model.gpu_name == torch.cuda.get_device_name(0),
                f"{name}.gpu_name {model.gpu_name}")
        for k in ("f*", "f*_var", "y_var"):
            require(preds[k].shape == (P,) and np.isfinite(preds[k]).all(),
                    f"{name} {k}: shape {preds[k].shape} or non-finite")
        err = max(float(np.max(np.abs(preds[k] - ref[k])))
                  for k in ("f*", "f*_var", "y_var"))
        print(f"model {name} N={n_obs}: card f32 converged={ok} objective "
              f"{obj:.4f} in {wall:.3f} s; CPU f64 converged={ok64} objective "
              f"{obj64:.4f} in {wall64:.3f} s; predictions max_abs_err "
              f"{err:.3e}; lengthscales "
              f"{np.round(model.get_lengthscales(), 4).tolist()}")
        for k in ("f*", "f*_var", "y_var"):
            np.testing.assert_allclose(preds[k], ref[k], rtol=tol[0],
                                       atol=tol[1], err_msg=f"{name} {k}")
        np.testing.assert_allclose(obj, obj64, rtol=otol,
                                   err_msg=f"{name} objective")


# ---------------------------------------------------------------------------
# the pipeline's device half at full-Arctic scale
# ---------------------------------------------------------------------------

KM = 1000.0
# configs/example_local_expert_oi.json's model: coords_scale, constraints and
# likelihood bounds (GPRModel, default optimiser settings)
ARCTIC_MODEL = {
    "init_params": {"coords_scale": [100000.0, 100000.0, 1]},
    "constraints": {
        "lengthscales": {"low": [1e-08, 1e-08, 1e-08],
                         "high": [600000.0, 600000.0, 9]},
        "likelihood_variance": {"low": 0.00125, "high": 0.25}}}
# The full-Arctic 50 km north star: experts every 50 km over +-2500 km
# (101 x 101 = 10 201), observations binned to 50 km a day over 9 days,
# +-2 days and 450 km around each expert, predictions on a 25 km grid within
# 200 km of it. 300 along-track chords over +-3000 km give per-expert N
# across the levels 64-1024, all inside the kernels' gate (N padded <= 1024).
ARCTIC = dict(half=2500 * KM, step=50 * KM, domain=3000 * KM, n_tracks=300,
              spacing=7.5 * KM, days=9, noise=0.05, grid=50 * KM,
              day_window=2, radius=450 * KM, pred_step=25 * KM,
              pred_radius=200 * KM)
# the SGPR run: 96 experts of the centre, observations within 850 km (N
# between 1024 and 2048), M=500, route "mega" from init_params
SGPR_RUN = dict(experts=96, radius=850 * KM, M=500, route="mega")


def truth_field(x, y):
    """examples/generate_example_data.py's field (its formula, copied: this
    script imports nothing of examples/)."""
    return (0.15 * np.sin(x / (300 * KM)) + 0.1 * np.cos(y / (400 * KM))
            + 0.08 * np.sin((x + 0.5 * y) / (500 * KM)) + 0.15)


def arctic_tracks(seed=0, cfg=ARCTIC):
    """Along-track chords as examples/generate_example_data.make_tracks draws
    them (one random day each, noise 0.05 on the field), before binning:
    the (x, y, t, z) of every along-track point."""
    rng = np.random.default_rng(seed)
    dom = cfg["domain"]
    s = np.linspace(-dom, dom, int(2 * dom / cfg["spacing"]))
    xs, ys, ts = [], [], []
    for _ in range(cfg["n_tracks"]):
        theta = rng.uniform(0, 2 * np.pi)
        offset = rng.uniform(-dom * 0.7, dom * 0.7)
        x = s * np.cos(theta) - offset * np.sin(theta)
        y = s * np.sin(theta) + offset * np.cos(theta)
        keep = (np.abs(x) < dom) & (np.abs(y) < dom)
        xs.append(x[keep])
        ys.append(y[keep])
        ts.append(np.full(int(keep.sum()), rng.integers(0, cfg["days"])))
    x, y, t = (np.concatenate(a) for a in (xs, ys, ts))
    z = truth_field(x, y) + cfg["noise"] * rng.standard_normal(len(x))
    return x, y, t, z


def arctic_observations(seed=0, cfg=ARCTIC):
    """arctic_tracks' points binned to a 50 km grid per day: (x, y, t, z) of
    the non-empty cells, sorted by day."""
    x, y, t, z = arctic_tracks(seed, cfg)
    dom = cfg["domain"]
    g = cfg["grid"]
    ng = int(round(2 * dom / g))
    ix = np.clip(np.floor((x + dom) / g).astype(int), 0, ng - 1)
    iy = np.clip(np.floor((y + dom) / g).astype(int), 0, ng - 1)
    cell, inv, cnt = np.unique((t * ng + iy) * ng + ix, return_inverse=True,
                               return_counts=True)
    zb = np.bincount(inv, weights=z) / cnt
    xb = -dom + (cell % ng + 0.5) * g
    yb = -dom + ((cell // ng) % ng + 0.5) * g
    return np.stack([xb, yb, (cell // (ng * ng)).astype(float)], 1), zb


def arctic_select(obs_xyt, obs_z, expert_xy, t_expert, radius, cfg=ARCTIC):
    """Per-expert rows of the local data: days within +-day_window of the
    expert and a euclidean radius in (x, y), by scipy.spatial.cKDTree's
    query_ball_point (DataLoader.local_data_select's semantics: a KD radius
    query, rows in the frame's order). Returns X_list, obs_list."""
    from scipy.spatial import cKDTree
    days = obs_xyt[:, 2]
    hits = [[] for _ in range(len(expert_xy))]
    for d in range(int(t_expert) - cfg["day_window"],
                   int(t_expert) + cfg["day_window"] + 1):
        rows = np.flatnonzero(days == d)
        if len(rows) == 0:
            continue
        found = cKDTree(obs_xyt[rows, :2]).query_ball_point(expert_xy, r=radius)
        for i, f in enumerate(found):
            hits[i].append(rows[np.asarray(f, dtype=int)])
    idx = [np.sort(np.concatenate(h)) if h else np.zeros(0, int)
           for h in hits]
    return [obs_xyt[i] for i in idx], [obs_z[i] for i in idx]


def arctic_inputs(seed=0, cfg=ARCTIC):
    """The per-expert inputs of execute_buckets for the full-Arctic grid,
    and the seconds the KD selection took."""
    obs_xyt, obs_z = arctic_observations(seed, cfg)
    e = np.arange(-cfg["half"], cfg["half"] + cfg["step"] / 2, cfg["step"])
    ex, ey = (a.ravel() for a in np.meshgrid(e, e, indexing="ij"))
    t_expert = float(cfg["days"] // 2)
    experts = np.stack([ex, ey, np.full(len(ex), t_expert)], 1)
    t0 = time.perf_counter()
    X_list, obs_list = arctic_select(obs_xyt, obs_z, experts[:, :2],
                                     t_expert, cfg["radius"], cfg)
    gather = time.perf_counter() - t0
    k = int(cfg["pred_radius"] // cfg["pred_step"])
    o = np.arange(-k, k + 1) * cfg["pred_step"]
    ox, oy = (a.ravel() for a in np.meshgrid(o, o, indexing="ij"))
    near = ox ** 2 + oy ** 2 < cfg["pred_radius"] ** 2   # max_dist_bool's <
    offsets = np.stack([ox[near], oy[near], np.zeros(int(near.sum()))], 1)
    pred_list = [xe + offsets for xe in experts]
    return dict(obs=(obs_xyt, obs_z), experts=experts, X_list=X_list,
                obs_list=obs_list, pred_list=pred_list, gather=gather)


def buckets_of(inp):
    from gpsat_tpu_torch.parallel.scheduler import make_buckets
    return make_buckets([len(o) for o in inp["obs_list"]],
                        [len(p) for p in inp["pred_list"]],
                        batch_size=len(inp["obs_list"]))


def assembled(inp, bk, coords_scale=None):
    """assemble_bucket's padded arrays of one bucket of `inp` (coordinates
    scaled by ARCTIC_MODEL's coords_scale unless given another)."""
    from gpsat_tpu_torch.local_experts import assemble_bucket
    scale = np.atleast_2d(ARCTIC_MODEL["init_params"]["coords_scale"]
                          if coords_scale is None else coords_scale)
    return assemble_bucket(bk, inp["X_list"], inp["obs_list"],
                           inp["pred_list"], scale.astype(float),
                           np.ones((1, 1)), expert_locs=inp.get("experts"))


def subset(inp, ids):
    return {"X_list": [inp["X_list"][i] for i in ids],
            "obs_list": [inp["obs_list"][i] for i in ids],
            "pred_list": [inp["pred_list"][i] for i in ids]}


def run_pipeline(engine, inp, mesh=None):
    from gpsat_tpu_torch.local_experts import execute_buckets
    return execute_buckets(
        engine, inp["X_list"], inp["obs_list"], inp["pred_list"],
        coords_scale=ARCTIC_MODEL["init_params"]["coords_scale"], mesh=mesh)


def pred_valid(out):
    """[E, P] mask of each expert's prediction points in out["preds"]."""
    width = out["preds"]["f*"].shape[1]
    return np.arange(width)[None, :] < out["n_pred"][:, None]


# f32 predictions against f64 at the same parameters, each key on its own:
# f* at phase_kernels' predict tolerance; the variances relative to their own
# size (f*_var is ~5e-5 here, below that atol of 1e-4)
PRED_TOL = {"f*": (1e-3, 1e-4), "f*_var": (1e-3, 1e-6), "y_var": (1e-3, 1e-6)}
PRED_KEYS = tuple(PRED_TOL)
# the card's f32 run against the CPU's f64 run of the same experts: two
# optimisations that stop at slightly different parameters (measured on the
# H100: f* 2.7e-4 apart, f*_var 1.0 % and y_var 0.5 % relative); the limits
# are two to four times those
SUBSET_TOL = {"f*": (1e-3, 1e-3), "f*_var": (2e-2, 1e-6),
              "y_var": (2e-2, 1e-6)}


def hold_preds(name, got, want, valid, tol=PRED_TOL):
    """Hold each key of the prediction dicts `got` against `want` ([E, P]
    arrays) on the valid points at its own (rtol, atol); prints each key's
    largest abs and rel error. Returns the largest abs error."""
    worst = 0.0
    for k, (rtol, atol) in tol.items():
        g, w = got[k][valid], want[k][valid]
        e = np.abs(g - w)
        print(f"  {name} {k}: max_abs_err {e.max():.3e}, max rel err "
              f"{np.max(e / np.maximum(np.abs(w), 1e-300)):.3e}, median |{k}| "
              f"{np.median(np.abs(w)):.3e} (rtol {rtol}, atol {atol})")
        bad = int(np.sum(~(e <= atol + rtol * np.abs(w))))
        require(bad == 0, f"{name} {k}: {bad} of {e.size} values beyond "
                          f"rtol {rtol} atol {atol}")
        worst = max(worst, float(e.max()))
    return worst


def check_gpr_against_f64(inp, out, kernel, params=None,
                          hold_objective=True, name="pipeline GPR vs f64"):
    """Predictions (f*, f*_var, y_var, each at PRED_TOL) and objective of
    every expert against ops/gpr in f64 on the card at `params` (default:
    the fitted out["params"]), bucket by bucket in chunks of 64 (objective
    rtol 1e-3 atol 2e-2, phase_bulk_nlml's, unless not `hold_objective`).
    Returns the largest errors."""
    from gpsat_tpu_torch.ops import gpr as gpr_math
    params = out["params"] if params is None else params
    valid = pred_valid(out)
    width = valid.shape[1]
    ref = {k: np.full_like(out["preds"][k], np.nan) for k in PRED_TOL}
    oerr = 0.0
    for bk in buckets_of(inp):
        X, y, mask, Xs, *_ = assembled(inp, bk)
        ids = bk["indices"]
        for s in range(0, len(ids), 64):
            part = ids[s:s + 64]
            rows = slice(s, s + len(part))

            def t(a, dtype=torch.float64):
                return torch.tensor(a[rows], dtype=dtype, device="cuda")
            prm = {k: torch.tensor(v[part], dtype=torch.float64,
                                   device="cuda")
                   for k, v in params.items()}
            pr = gpr_math.predict(prm, t(X), t(y), t(mask, torch.bool),
                                  t(Xs), kernel=kernel)
            for k in ref:
                ref[k][part] = pr[k].cpu().numpy()[:, :width]
            nl = gpr_math.nlml(prm, t(X), t(y), t(mask, torch.bool),
                               kernel=kernel).cpu().numpy()
            if hold_objective:
                np.testing.assert_allclose(out["objective"][part], nl,
                                           rtol=1e-3, atol=2e-2,
                                           err_msg="pipeline NLML")
            oerr = max(oerr, float(np.abs(out["objective"][part] - nl).max()))
    perr = hold_preds(name, out["preds"], ref, valid)
    return perr, oerr


def compare_level(cuda_gpr, inp, out, kernel, chunk=512):
    """compare_kernels (value and predict against their plain versions, vg's
    lanes against f64 beside the plain version's, repeats bit for bit) on
    the assembled arrays of the largest N level at its fitted parameters,
    f32 on the card, in chunks of `chunk` experts. Returns the level's N,
    its experts and the largest errors."""
    bk = buckets_of(inp)[-1]
    X, y, mask, Xs, *_ = assembled(inp, bk)
    ids = bk["indices"]
    errs = {"vg": 0.0, "value": 0.0, "predict": 0.0}
    for s in range(0, len(ids), chunk):
        rows = slice(s, min(s + chunk, len(ids)))

        def t(a):
            return torch.tensor(a[rows], dtype=torch.float32, device="cuda")
        prm = {k: torch.tensor(v[ids[rows]], dtype=torch.float32,
                               device="cuda")
               for k, v in out["params"].items()}
        got = compare_kernels(cuda_gpr, kernel, (prm, t(X), t(y),
                                                 t(mask.astype(np.float32)),
                                                 t(Xs)), vg_grads="f64")
        errs = {k: max(errs[k], got[k]) for k in errs}
    return bk["n_max"], len(ids), errs


def pick_spread(inp, n=16, top=1):
    """n experts spread over the N levels: evenly through each level's
    experts, at most `top` from the largest level (the CPU's f64 cost: with
    3 of them, 100 s of the card host's CPU, a quarter of the script)."""
    levels = {}
    for bk in buckets_of(inp):
        levels.setdefault(bk["n_max"], []).extend(bk["indices"].tolist())
    lv = sorted(levels)
    want = dict.fromkeys(lv, 0)
    want[lv[-1]] = min(top, len(levels[lv[-1]]))
    while sum(want.values()) < n and \
            any(want[l] < len(levels[l]) for l in lv[:-1]):
        for l in lv[:-1]:
            if sum(want.values()) < n and want[l] < len(levels[l]):
                want[l] += 1
    return np.array(sorted({levels[l][int(j)] for l in lv for j in
                            np.linspace(0, len(levels[l]) - 1,
                                        want[l]).round()}))


def phase_pipeline(cuda_gpr):
    """The pipeline's device half (local_experts.execute_buckets, the code
    LocalExpertOI.run runs between its host gather and its store) at the
    full-Arctic 50 km north star, f32 on the card, GPRModel as
    configs/example_local_expert_oi.json configures it; then a small
    SGPRModel run through the same function. Returns the launches of each
    run ({kernel: launches}), the GPR run's inputs and result, and its RMSE
    against the truth field."""
    from gpsat_tpu_torch.local_experts import make_engine
    from gpsat_tpu_torch.models.exact_gpr import GPRModel

    t0 = time.perf_counter()
    cfg = ARCTIC
    inp = arctic_inputs(cfg=cfg)
    n = np.array([len(o) for o in inp["obs_list"]])
    p = np.array([len(q) for q in inp["pred_list"]])
    E = len(n)
    side = int(round(2 * cfg["half"] / cfg["step"])) + 1
    print(f"pipeline inputs: {len(inp['obs'][1])} binned observations, "
          f"{E} experts, made in {time.perf_counter() - t0:.2f} s; gather "
          f"(KD select) {inp['gather']:.2f} s; per-expert N quantiles "
          f"(0, 5, 50, 95, 100 %) {np.percentile(n, [0, 5, 50, 95, 100])}, "
          f"P (0, 50, 100 %) {np.percentile(p, [0, 50, 100])}")
    require(E == side * side, f"{E} experts")
    require(n.min() >= 3, f"an expert with {n.min()} observations")
    require(np.mean(n <= 1024) >= 0.95, "fewer than 95 % of experts in gate")
    levels = sorted({bk["n_max"] for bk in buckets_of(inp)})
    require(len(levels) >= 3, f"N levels {levels}")

    def gpr_engine(dev="cuda"):
        return make_engine(GPRModel, ARCTIC_MODEL["init_params"],
                           ARCTIC_MODEL["constraints"], coords_dim=3,
                           device=dev)
    engine = gpr_engine()
    cuda_gpr.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_pipeline(engine, inp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in cuda_gpr.launch_counts().items() if v}
    conv = float(np.mean(out["converged"]))
    asm = sum(b["assemble_seconds"] for b in out["buckets"])
    print(f"pipeline GPR on {engine.device} in {engine.dtype}: E={E} "
          f"converged={conv:.4f} execute {wall:.3f} s ({E / wall:.2f} "
          f"experts/s, {p.sum() / wall:.0f} prediction points/s), assembly "
          f"{asm:.3f} s (in a thread, beside the engine), levels N {levels}, "
          f"launches={launches}")
    for b in out["buckets"]:
        print(f"  level N={b['n_max']} P={b['p_max']}: {b['experts']} "
              f"experts, {b['seconds']:.3f} s, engine "
              f"{b['engine_seconds']:.3f} s, pool iterations "
              f"{b['pool_iterations']}")
    require(launches.get("nlml_vg", 0) > 0 and
            launches.get("posterior_predict", 0) > 0,
            f"a kernel of the pipeline was not launched: {launches}")
    require(conv >= 0.99, f"pipeline converged fraction {conv} < 0.99")
    require(np.isfinite(out["objective"]).all(), "non-finite objective")
    for k, v in out["params"].items():
        require(np.isfinite(v).all(), f"non-finite {k}")
    valid = pred_valid(out)
    for k in ("f*", "f*_var", "y_var"):
        require(np.isfinite(out["preds"][k][valid]).all(), f"non-finite {k}")

    perr, oerr = check_gpr_against_f64(inp, out, engine.kernel)
    print(f"pipeline GPR vs f64 at the fitted parameters (all {E} experts): "
          f"predictions max_abs_err {perr:.3e}, objective max_abs_err "
          f"{oerr:.3e}")
    n_top, b_top, kerr = compare_level(cuda_gpr, inp, out, engine.kernel)
    print(f"pipeline level N={n_top} ({b_top} experts) at its fitted "
          f"parameters, kernels against their plain versions: max_abs_err "
          f"{kerr}")
    pred_xy = np.concatenate(inp["pred_list"])[:, :2]
    rmse = float(np.sqrt(np.mean(
        (out["preds"]["f*"][valid] - truth_field(*pred_xy.T)) ** 2)))
    print(f"pipeline f* against the truth field at {len(pred_xy)} prediction "
          f"points: RMSE {rmse:.5f} (observation noise {cfg['noise']})")
    require(rmse < cfg["noise"], f"RMSE {rmse} not below the noise")

    # one level again, straight through engine.fit_predict_many on the same
    # assembled arrays: bit for bit (the first level that ran the pool)
    pooled = [i for i, b in enumerate(out["buckets"]) if b["pool_iterations"]]
    bi = pooled[0] if pooled else 0
    bk = buckets_of(inp)[bi]
    X, y, mask, Xs, *_ = assembled(inp, bk)
    direct = gpr_engine().fit_predict_many(X, y, mask, Xs=Xs)
    ids = bk["indices"]
    same = all(np.array_equal(out["params"][k][ids], v)
               for k, v in direct["params"].items())
    same &= all(np.array_equal(out[k][ids], direct[k])
                for k in ("objective", "converged", "iterations"))
    for k in ("f*", "f*_var", "y_var"):
        same &= all(np.array_equal(out["preds"][k][e, :p[e]],
                                   direct["preds"][k][j, :p[e]])
                    for j, e in enumerate(ids))
    print(f"pipeline level N={bk['n_max']} ({len(ids)} experts, "
          f"{out['buckets'][bi]['pool_iterations']} pool iterations) equals "
          f"fit_predict_many on its assembled arrays bit for bit: {same}")
    require(same, "execute_buckets and fit_predict_many differ")

    # 16 experts spread over the levels through the same function on the CPU
    # in f64, each key at SUBSET_TOL
    picks = pick_spread(inp)
    t0 = time.perf_counter()
    ref = run_pipeline(gpr_engine("cpu"), subset(inp, picks))
    cpu_wall = time.perf_counter() - t0
    rel = float(np.max(np.abs(out["objective"][picks] / ref["objective"]
                              - 1)))
    print(f"pipeline CPU f64 run of {len(picks)} experts (N "
          f"{n[picks].tolist()}) in {cpu_wall:.2f} s: objective max rel err "
          f"{rel:.3e}")
    got = {k: out["preds"][k][picks] for k in PRED_TOL}
    hold_preds("pipeline CPU f64", got, ref["preds"], valid[picks],
               tol=SUBSET_TOL)
    np.testing.assert_allclose(out["objective"][picks], ref["objective"],
                               rtol=1e-3, err_msg="pipeline CPU objective")
    return launches, phase_pipeline_sgpr(cuda_gpr, inp), inp, out, rmse


def centre_experts(inp, cfg=SGPR_RUN):
    """The SGPR run's experts: the cfg["experts"] nearest the centre whose
    observations within cfg["radius"] number between 1024 and 2048 (one
    level of 2048). Returns execute_buckets' lists, their locations
    (`experts`) and their N (`n`)."""
    obs_xyt, obs_z = inp["obs"]
    ex = inp["experts"]
    centre = np.argsort(np.abs(ex[:, 0]) + np.abs(ex[:, 1]), kind="stable")
    X_list, obs_list = arctic_select(obs_xyt, obs_z, ex[centre, :2],
                                     ex[0, 2], cfg["radius"])
    n = np.array([len(o) for o in obs_list])
    keep = np.flatnonzero((n > 1024) & (n <= 2048))[:cfg["experts"]]
    require(len(keep) == cfg["experts"], f"{len(keep)} centre experts")
    return {"X_list": [X_list[i] for i in keep],
            "obs_list": [obs_list[i] for i in keep],
            "pred_list": [inp["pred_list"][i] for i in centre[keep]],
            "experts": ex[centre[keep]], "n": n[keep]}


def phase_pipeline_sgpr(cuda_gpr, inp):
    """SGPRModel through make_engine (route and M from init_params) and
    execute_buckets: experts of the centre with N between 1024 and 2048.
    Returns {"launches", "sub" (the experts' inputs), "out"}."""
    from gpsat_tpu_torch.local_experts import make_engine
    from gpsat_tpu_torch.models.sgpr import SGPRModel
    cfg = SGPR_RUN
    sub = centre_experts(inp)
    n = sub["n"]
    init = dict(ARCTIC_MODEL["init_params"], num_inducing_points=cfg["M"],
                route=cfg["route"])
    engine = make_engine(SGPRModel, init, ARCTIC_MODEL["constraints"],
                         coords_dim=3)
    require(engine.route == cfg["route"] and engine.num_inducing == cfg["M"],
            f"SGPR engine route {engine.route} M {engine.num_inducing}")
    cuda_gpr.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_pipeline(engine, sub)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in cuda_gpr.launch_counts().items() if v}
    conv = float(np.mean(out["converged"]))
    print(f"pipeline SGPR: E={len(n)} N (0, 50, 100 %) "
          f"{np.percentile(n, [0, 50, 100])} M={cfg['M']} "
          f"route={cfg['route']} converged={conv:.4f} {wall:.3f} s "
          f"({len(n) / wall:.2f} experts/s) launches={launches}; levels "
          f"(N, experts, pool iterations) "
          f"{[(b['n_max'], b['experts'], b['pool_iterations']) for b in out['buckets']]}")
    require(launches.get("cholinv", 0) > 0 and
            launches.get("sgpr_vg_mega", 0) > 0,
            f"SGPR pipeline: cholinv or the route's kernel not launched: "
            f"{launches}")
    require(conv >= 0.99, f"SGPR pipeline converged fraction {conv}")
    require(np.isfinite(out["objective"]).all(), "SGPR: non-finite objective")
    valid = pred_valid(out)
    for k in ("f*", "f*_var", "y_var"):
        require(np.isfinite(out["preds"][k][valid]).all(),
                f"SGPR non-finite {k}")
    hold_sgpr_f64(f"SGPR vs f64 ({len(n)} experts)", sub, out, engine)
    return {"launches": launches, "sub": sub, "out": out}


def hold_sgpr_f64(name, sub, out, engine, coords_scale=None, tol=PRED_TOL,
                  plain_ratio=None):
    """Every expert of an SGPR run against ops/sgpr.predict in f64 on the
    card at its fitted parameters and inducing points, in chunks of 32,
    each key at `tol` (coordinates scaled by ARCTIC_MODEL's coords_scale
    unless given another). With `plain_ratio` ({key: ratio}), the same call
    in f32 (the plain version of the route's prediction) is held against
    f64 too, and each key's largest abs error must be within its ratio
    times the plain version's. Returns the largest abs error."""
    from gpsat_tpu_torch.ops import sgpr as sgpr_math
    valid = pred_valid(out)
    width = valid.shape[1]
    dts = (torch.float64,) if plain_ratio is None else \
        (torch.float64, torch.float32)
    ref = {dt: {k: np.full_like(out["preds"][k], np.nan) for k in PRED_TOL}
           for dt in dts}
    for bk in buckets_of(sub):
        X, y, mask, Xs, *_ = assembled(sub, bk, coords_scale)
        for s in range(0, len(bk["indices"]), 32):
            ids = bk["indices"][s:s + 32]
            rows = slice(s, s + len(ids))
            Z = out["params"]["inducing_points"][ids]
            for dt in dts:
                def t(a):
                    v = torch.tensor(a[rows], device="cuda")
                    return v.to(dt) if v.is_floating_point() else v
                prm = {k: torch.tensor(out["params"][k][ids], dtype=dt,
                                       device="cuda")
                       for k in engine.HYPER_NAMES}
                pr = sgpr_math.predict(
                    prm, t(X), t(y), t(mask),
                    torch.tensor(Z, dtype=dt, device="cuda"),
                    torch.tensor(np.isfinite(Z[..., 0]), device="cuda"),
                    t(Xs), kernel=engine.kernel, jitter=engine.jitter)
                for k in PRED_TOL:
                    v = pr[k].cpu().numpy()[:, :width]
                    ref[dt][k][ids, :v.shape[1]] = v
    worst = hold_preds(name, out["preds"], ref[torch.float64], valid, tol)
    for k, ratio in (plain_ratio or {}).items():
        f64 = ref[torch.float64][k][valid]
        route = float(np.abs(out["preds"][k][valid] - f64).max())
        plain = float(np.abs(ref[torch.float32][k][valid] - f64).max())
        print(f"  {name} {k}: the route's max_abs_err {route:.3e}, the plain "
              f"f32 prediction's {plain:.3e}, ratio {route / plain:.2f} "
              f"(limit {ratio})")
        require(route <= ratio * plain, f"{name} {k}: the route's error "
                f"{route:.3e} beyond {ratio} times the plain f32 {plain:.3e}")
    return worst


# configs/example_postprocessing.json: the fields it smooths, their
# lengthscales (m) and upper limits
SMOOTHING = {"l_x": 400 * KM, "l_y": 400 * KM,
             "max": {"kernel_variance": 0.5, "likelihood_variance": 0.3}}
# the card's f64 smoother against the native host one (another summation
# order of the same f64 sums)
SMOOTH_RTOL = 1e-10


def smoothed_fields(inp, params):
    """Phase 6's fitted parameters smoothed over the expert locations as
    smooth_hyperparameters does it: one field per lengthscale component and
    one for each variance, smooth_field on the card in f64, each held
    against native.gaussian_2d_weight (C++ on the host, f64) at
    SMOOTH_RTOL with the same clamps. Returns the smoothed parameters
    {name: [E, ...]} and each field's card seconds."""
    from gpsat_tpu_torch import native
    from gpsat_tpu_torch.postprocessing import smooth_field
    require(native._load() is not None, "native host library not loaded")
    x, y = inp["experts"][:, 0], inp["experts"][:, 1]
    lx, ly = SMOOTHING["l_x"], SMOOTHING["l_y"]
    out, secs = {}, {}
    for name, v in params.items():
        cols = v.reshape(len(x), -1)
        hi = SMOOTHING["max"].get(name)
        sm = np.empty_like(cols)
        for j in range(cols.shape[1]):
            field = f"{name}[{j}]" if cols.shape[1] > 1 else name
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sm[:, j] = smooth_field(x, y, cols[:, j], lx, ly, max=hi,
                                    device="cuda")
            torch.cuda.synchronize()
            secs[field] = time.perf_counter() - t0
            t0 = time.perf_counter()
            clamped = cols[:, j] if hi is None else np.minimum(cols[:, j], hi)
            want = native.gaussian_2d_weight(x, y, x, y, lx, ly, clamped)
            want = want if hi is None else np.minimum(want, hi)
            host = time.perf_counter() - t0
            err = float(np.max(np.abs(sm[:, j] / want - 1)))
            print(f"smoothed {field}: {len(x)} experts, card f64 "
                  f"{secs[field]:.4f} s, native host {host:.3f} s, max rel "
                  f"err {err:.3e} (rtol {SMOOTH_RTOL}), range "
                  f"[{sm[:, j].min():.4g}, {sm[:, j].max():.4g}] from "
                  f"[{cols[:, j].min():.4g}, {cols[:, j].max():.4g}]")
            require(np.isfinite(sm[:, j]).all(), f"{field}: non-finite")
            np.testing.assert_allclose(sm[:, j], want, rtol=SMOOTH_RTOL,
                                       err_msg=f"smoothed {field}")
            require(hi is None or sm[:, j].max() <= hi,
                    f"{field} above its limit {hi}")
        out[name] = sm.reshape(v.shape)
    return out, secs


def phase_smoothed(cuda_gpr, inp, fitted, rmse_fit):
    """run_examples.sh step 6 on phase 6's fit: smooth the hyperparameter
    fields (smoothed_fields), then execute_buckets with them and
    optimise=False, as LocalExpertOI.run does for the follow-up config that
    smooth_hyperparameters writes. Returns the launches of the re-predict,
    {kernel: launches}, and the smoothed parameters."""
    from gpsat_tpu_torch.local_experts import execute_buckets, make_engine
    from gpsat_tpu_torch.models.exact_gpr import GPRModel

    smoothed, secs = smoothed_fields(inp, fitted["params"])
    print(f"smoothing on the card: {len(secs)} fields, "
          f"{sum(secs.values()):.4f} s, per field "
          f"{ {k: round(v, 4) for k, v in secs.items()} }")
    engine = make_engine(GPRModel, ARCTIC_MODEL["init_params"],
                         ARCTIC_MODEL["constraints"], coords_dim=3,
                         device="cuda")
    per_level = []

    def on_level(ids, result, f_bar, per_expert_time):
        per_level.append(cuda_gpr.launch_counts().get("posterior_predict", 0))
    E = len(inp["X_list"])
    points = sum(len(q) for q in inp["pred_list"])
    cuda_gpr.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = execute_buckets(
        engine, inp["X_list"], inp["obs_list"], inp["pred_list"],
        coords_scale=ARCTIC_MODEL["init_params"]["coords_scale"],
        overrides=smoothed, optimise=False, on_bucket=on_level)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in cuda_gpr.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"smoothed re-predict on {engine.device} in {engine.dtype}: E={E} "
          f"execute {wall:.3f} s ({E / wall:.2f} experts/s, "
          f"{points / wall:.0f} prediction points/s), peak device memory "
          f"{peak:.2f} GiB, launches={launches}")
    for b, n in zip(out["buckets"], np.diff([0] + per_level)):
        print(f"  level N={b['n_max']} P={b['p_max']}: {b['experts']} "
              f"experts, {b['seconds']:.3f} s, engine "
              f"{b['engine_seconds']:.3f} s, posterior_predict launches {n}")
    require(len(per_level) == len(out["buckets"]) and
            all(n > 0 for n in np.diff([0] + per_level)),
            f"a level ran without the predict kernel: {per_level}")
    require(launches.get("nlml_vg", 0) == 0,
            f"the vg kernel ran with optimise=False: {launches}")
    require((out["iterations"] == 0).all(), "an expert took L-BFGS steps")
    require(np.isfinite(out["objective"]).all(), "non-finite objective")
    valid = pred_valid(out)
    for k in ("f*", "f*_var", "y_var"):
        require(np.isfinite(out["preds"][k][valid]).all(), f"non-finite {k}")
    perr, oerr = check_gpr_against_f64(inp, out, engine.kernel,
                                       params=smoothed, hold_objective=False,
                                       name="smoothed re-predict vs f64")
    print(f"smoothed re-predict vs f64 at the smoothed parameters (all {E} "
          f"experts): predictions max_abs_err {perr:.3e}; f32 objective "
          f"(ops/gpr.nlml_fused) max_abs_err {oerr:.3e}, not held")
    pred_xy = np.concatenate(inp["pred_list"])[:, :2]
    rmse = float(np.sqrt(np.mean(
        (out["preds"]["f*"][valid] - truth_field(*pred_xy.T)) ** 2)))
    print(f"smoothed re-predict f* against the truth field at "
          f"{len(pred_xy)} points: RMSE {rmse:.5f} (phase 6's fit "
          f"{rmse_fit:.5f}, observation noise {ARCTIC['noise']})")
    require(rmse < ARCTIC["noise"], f"RMSE {rmse} not below the noise")
    return launches, smoothed


# ---------------------------------------------------------------------------
# the other model families: SVGP, VFF and ASVGP
# ---------------------------------------------------------------------------

# the bench `svgp` and `vff` workloads (bench.py:480-490); ASVGP on the vff
# shape with 19 B-splines per dimension, VFF's (2 * 10 - 1)**2 = 361 features
SVGP_BENCH = dict(E=128, N=1000, P=400, D=3, M=128)
SVGP_OPT = {"max_iter": 1000, "learning_rate": 5e-2}
VFF_BENCH = dict(E=128, N=1000, P=400, D=2, m=10)
ASVGP_M = 19
# the families' pipeline runs, on the SGPR run's 96 centre experts: SVGP on
# (x, y, t) with the bench recipe; VFF and ASVGP on (x, y) in boxes of
# +-900 km around each expert, wider than the 850 km selection radius, so
# that the expert locations (not the data's extent) fix every box
FAMILY_DOMAIN = 900 * KM
# the f32 ELBO at the fitted state against its f64 evaluation: relative
# limits, about four times the largest measured on the H100 (SVGP 3.1e-5,
# VFF 1.5e-5, ASVGP 3.6e-4)
ELBO_RTOL = {"SVGPModel": 1.5e-4, "VFFModel": 6e-5, "ASVGPModel": 1.5e-3}
# The bench svgp predictions against f64: PRED_TOL but for f*, where 6 of
# 51 200 values were 1.2e-4 to 2.1e-4 off on the H100 (the f32 factor of Kuu
# at M=128, jitter 1e-6); held at atol 1e-3
SVGP_BENCH_TOL = dict(PRED_TOL, **{"f*": (1e-3, 1e-3)})


def family_f64(family, engine, arrays, out_rows, chunk=32):
    """The family's ops in f64 on the card at a fitted state: (ELBO [B],
    predictions {key: [B, P]}) of the padded bucket `arrays` (X, y, mask,
    Xs and, for VFF and ASVGP, the boxes a, b), `out_rows` the engine's
    params (and, for SVGP, inducing_mask) of the same rows, in chunks."""
    from gpsat_tpu_torch.ops import svgp as svgp_math
    X, y, mask, Xs = arrays[:4]
    B = len(X)
    elbo = np.empty(B)
    preds = {k: np.empty(Xs.shape[:2]) for k in PRED_TOL}
    for s in range(0, B, chunk):
        rows = slice(s, min(s + chunk, B))

        def t(a, dtype=torch.float64):
            return torch.tensor(np.asarray(a)[rows], dtype=dtype,
                                device="cuda")
        prm = {k: t(out_rows["params"][k]) for k in engine.HYPER_NAMES}
        if family == "SVGPModel":
            p = out_rows["params"]
            args = (t(p["inducing_mean"]), t(p["inducing_chol"]))
            Z = t(p["inducing_points"])
            zm = t(out_rows["inducing_mask"], torch.bool)
            e = svgp_math.elbo(prm, *args, t(X), t(y), t(mask, torch.bool),
                               Z, zm, kernel=engine.kernel,
                               jitter=engine.jitter)
            pr = svgp_math.predict(prm, *args, Z, zm, t(Xs),
                                   kernel=engine.kernel, jitter=engine.jitter)
        else:
            a, b = t(arrays[4]), t(arrays[5])
            e = engine._math.elbo(prm, t(X), t(y), t(mask, torch.bool), a, b,
                                  engine.ms, kernel=engine.kernel,
                                  jitter=engine.jitter)
            pr = engine._math.predict(prm, t(X), t(y), t(mask, torch.bool),
                                      t(Xs), a, b, engine.ms,
                                      kernel=engine.kernel,
                                      jitter=engine.jitter)
        elbo[rows] = e.cpu().numpy()
        for k in preds:
            preds[k][rows] = pr[k].cpu().numpy()
    return elbo, preds


def hold_family(name, family, objective, elbo64, got, want, valid,
                tol=PRED_TOL):
    """Each prediction key at `tol` and the reported ELBO at ELBO_RTOL of
    the f64 one; prints both."""
    require(np.isfinite(objective).all(), f"{name}: non-finite ELBO")
    rel = np.abs(objective / elbo64 - 1)
    print(f"  {name} ELBO: reported against f64 max rel err {rel.max():.3e} "
          f"(median {np.median(rel):.3e}, limit {ELBO_RTOL[family]}), "
          f"median ELBO {np.median(elbo64):.2f}")
    require(rel.max() <= ELBO_RTOL[family],
            f"{name}: ELBO off f64 by {rel.max()}")
    return hold_preds(name, got, want, valid, tol)


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_family_bench():
    """The bench `svgp` workload through BatchedSVGP (Adam, one chunk of
    128) and the bench `vff` workload through BatchedVFF and BatchedASVGP
    (the L-BFGS pool at bench.py's slot rule), cold and warm, each expert
    held against f64 at its fitted state.

    BatchedASVGP runs in f64 here: in f32 its L-BFGS walks on this workload
    into lengthscales at their bound of 50 and a noise variance at its bound
    of 1e-5, where the f32 bound is off the f64 one by up to 1e12. The JAX
    package's f32 engine does the same on these inputs, on the CPU
    (tests/test_torch_vff.py::
    test_f32_asvgp_runs_to_the_bounds_on_the_bench_vff_inputs). The f32
    run is timed and its experts off f64 are counted and printed, not held
    (ROADMAP.md, reference behaviours)."""
    from gpsat_tpu_torch.profile_sweep import (bench_svgp_engine,
                                               bench_vff_engine, sgpr_slots,
                                               vff_slots, workload)
    from gpsat_tpu_torch.models.batched import BatchedASVGP
    c = SVGP_BENCH
    v = VFF_BENCH
    slots = vff_slots(v["E"], v["N"], v["m"], v["D"])
    runs = (("SVGPModel", bench_svgp_engine(c["D"], c["M"]), c,
             sgpr_slots(c["E"], c["N"], c["M"]), SVGP_BENCH_TOL),
            ("VFFModel", bench_vff_engine(v["D"], v["m"]), v, slots,
             PRED_TOL),
            ("ASVGPModel", bench_vff_engine(v["D"], ASVGP_M,
                                            engine=BatchedASVGP,
                                            dtype=torch.float64), v, slots,
             PRED_TOL),
            ("ASVGPModel f32", bench_vff_engine(v["D"], ASVGP_M,
                                                engine=BatchedASVGP), v,
             slots, None))
    for name, engine, c, slots, tol in runs:
        family = name.split()[0]
        E, N, P, D = c["E"], c["N"], c["P"], c["D"]
        X, y, mask, Xs = workload(E, N, P, D)
        require(engine.device.type == "cuda" and engine.dtype == (
            torch.float64 if name == "ASVGPModel" else torch.float32),
            f"{name}: engine on {engine.device} in {engine.dtype}")
        engine._last_pool_iterations = 0
        if tol is not None:
            _, cold = timed(lambda: engine.fit_predict_many(
                X, y, mask, Xs=Xs, slots=slots))
        torch.cuda.reset_peak_memory_stats()
        out, warm = timed(lambda: engine.fit_predict_many(X, y, mask, Xs=Xs,
                                                          slots=slots))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        conv = float(np.mean(out["converged"]))
        pool = getattr(engine, "_last_pool_iterations", 0)
        feats = (engine.num_inducing if family == "SVGPModel"
                 else int(np.prod([m if family == "ASVGPModel" else 2 * m - 1
                                   for m in engine.ms])))
        print(f"{name} bench E={E} N={N} P={P} D={D} features={feats} "
              f"slots={slots} {engine.dtype}: "
              + (f"cold {cold:.3f} s, " if tol is not None else "")
              + f"warm {warm:.3f} s ({E / warm:.2f} experts/s), peak "
              f"{peak:.2f} GiB, iterations (0, 50, 100 %) "
              f"{np.percentile(out['iterations'], [0, 50, 100]).tolist()}, "
              f"pool iterations {pool}, converged {conv:.4f}")
        if family == "SVGPModel":
            print(f"  SVGPModel plateau-stopped fraction {conv:.4f}")
            arrays = (X, y, mask, Xs)
        else:
            # domain_size None: each box is the expert's data extent
            arrays = (X, y, mask, Xs, X.min(axis=1) - 1e-8,
                      X.max(axis=1) + 1e-8)
        elbo64, ref = family_f64(family, engine, arrays, out)
        if tol is None:
            rel = np.abs(out["objective"] / elbo64 - 1)
            print(f"  {name}: {int(np.sum(rel > 1e-2))} of {E} experts' "
                  f"ELBO off f64 by more than 1 % (max rel {rel.max():.3e}), "
                  f"not held")
            continue
        for k in PRED_KEYS:
            require(out["preds"][k].shape == (E, P) and
                    np.isfinite(out["preds"][k]).all(),
                    f"{name}: {k} of shape {out['preds'][k].shape} or "
                    f"non-finite")
        if family != "SVGPModel":
            require(conv >= 0.99, f"{name}: converged fraction {conv}")
            require(pool > 0, f"{name}: the pool did not run")
        hold_family(f"{name} bench vs f64", family, out["objective"],
                    elbo64, out["preds"], ref, np.ones((E, P), bool), tol)


def phase_family_pipeline(inp):
    """SVGPModel, VFFModel and ASVGPModel through make_engine(get_model(...))
    and execute_buckets on the SGPR run's 96 centre experts: every expert
    against f64 at its fitted state (VFF and ASVGP in boxes of +-900 km
    about the expert, rebuilt here from the expert locations), converged
    (VFF, ASVGP) and RMSE against the truth field."""
    from gpsat_tpu_torch.local_experts import execute_buckets, make_engine
    from gpsat_tpu_torch.models import get_model
    sub = centre_experts(inp)
    cons = ARCTIC_MODEL["constraints"]
    scale3 = ARCTIC_MODEL["init_params"]["coords_scale"]
    runs = (
        ("SVGPModel", sub, scale3,
         {"num_inducing_points": SVGP_BENCH["M"]}, cons, SVGP_OPT),
        ("VFFModel", None, scale3[:2],
         {"num_inducing_features": VFF_BENCH["m"],
          "domain_size": FAMILY_DOMAIN}, None, None),
        ("ASVGPModel", None, scale3[:2],
         {"num_inducing_features": ASVGP_M, "domain_size": FAMILY_DOMAIN},
         None, None))
    sub2 = {"X_list": [x[:, :2] for x in sub["X_list"]],
            "obs_list": sub["obs_list"],
            "pred_list": [q[:, :2] for q in sub["pred_list"]],
            "experts": sub["experts"][:, :2]}
    cons2 = {"lengthscales": {k: v[:2] for k, v in
                              cons["lengthscales"].items()},
             "likelihood_variance": cons["likelihood_variance"]}
    pred_xy = np.concatenate(sub["pred_list"])[:, :2]
    for family, data, scale, init, c, opt in runs:
        data = sub2 if data is None else data
        c = cons2 if c is None else c
        engine = make_engine(get_model(family),
                             dict(init, coords_scale=scale), c,
                             coords_dim=len(scale), optim_kwargs=opt)
        require(type(engine).__name__ == "Batched" + family[:-5],
                f"{family}: engine {type(engine).__name__}")
        out, wall = timed(lambda: execute_buckets(
            engine, data["X_list"], data["obs_list"], data["pred_list"],
            coords_scale=scale, expert_locs=data["experts"]))
        E = len(data["X_list"])
        conv = float(np.mean(out["converged"]))
        valid = pred_valid(out)
        print(f"{family} pipeline E={E} N (0, 50, 100 %) "
                f"{np.percentile(sub['n'], [0, 50, 100]).tolist()} on "
                f"{engine.device} in {engine.dtype}: {wall:.3f} s "
                f"({E / wall:.2f} experts/s), converged {conv:.4f}, levels "
                f"(N, experts, pool iterations) "
                f"{[(b['n_max'], b['experts'], b['pool_iterations']) for b in out['buckets']]}, "
                f"iterations (0, 50, 100 %) "
                f"{np.percentile(out['iterations'], [0, 50, 100]).tolist()}")
        for k in PRED_KEYS:
            require(np.isfinite(out["preds"][k][valid]).all(),
                    f"{family} pipeline: non-finite {k}")
        if family != "SVGPModel":
            require(conv >= 0.99, f"{family} pipeline: converged {conv}")
        elbo64 = np.empty(E)
        ref = {k: np.full_like(out["preds"][k], np.nan) for k in PRED_TOL}
        width = valid.shape[1]
        for bk in buckets_of(data):
            arrays = assembled(data, bk, scale)
            ids = bk["indices"]
            X, y, mask, Xs, _, _, el = arrays
            b = len(ids)
            arrays = (X[:b], y[:b], mask[:b], Xs[:b])
            rows = {"params": {k: v[ids] for k, v in out["params"].items()}}
            if family == "SVGPModel":
                rows["inducing_mask"] = np.isfinite(
                    rows["params"]["inducing_points"][..., 0])
            else:
                half = FAMILY_DOMAIN / np.asarray(scale, dtype=float)
                off = np.abs(X[:b] - el[:b, None]) * mask[:b, :, None]
                require(bool((off < half).all()),
                        f"{family}: data outside the experts' boxes")
                arrays += (el[:b] - half, el[:b] + half)
            e64, pr = family_f64(family, engine, arrays, rows)
            elbo64[ids] = e64
            for k in ref:
                ref[k][ids] = pr[k][:, :width]
        hold_family(f"{family} pipeline vs f64", family, out["objective"],
                    elbo64, out["preds"], ref, valid)
        rmse = float(np.sqrt(np.mean(
            (out["preds"]["f*"][valid] - truth_field(*pred_xy.T)) ** 2)))
        print(f"  {family} pipeline f* against the truth field at "
              f"{len(pred_xy)} points: RMSE {rmse:.5f}")
        require(rmse < ARCTIC["noise"], f"{family}: RMSE {rmse}")


# per-expert models against their f64 CPU run: two optimisations (Adam in
# f32 and in f64 for SVGP, L-BFGS for VFF and ASVGP) that stop at nearby
# points; each prediction key's atol and the objective's rtol, about four
# times the largest measured on the H100 (SVGP f* 3.6e-3, f*_var 1.8e-5,
# y_var 3.7e-5, objective 6.4e-4; VFF 3.5e-5, 1.8e-6, 2.6e-6, 6.9e-6; ASVGP
# 1.25e-2, 6.3e-5, 6.0e-5, 2.7e-3). ASVGP's limits are the widest because
# its f32 bound is the least accurate (the fault that makes the bench ASVGP
# cell run in f64): the f32 run stops where that bound is flat to f32, away
# from the f64 optimum (f* up to 113 % relative on the H100).
FAMILY_MODEL_TOL = {
    "SVGPModel": ({"f*": 1.5e-2, "f*_var": 8e-5, "y_var": 1.5e-4}, 3e-3),
    "VFFModel": ({"f*": 1.5e-4, "f*_var": 8e-6, "y_var": 1.2e-5}, 3e-5),
    "ASVGPModel": ({"f*": 5e-2, "f*_var": 2.5e-4, "y_var": 2.5e-4}, 1.1e-2)}


def phase_family_models(workload, common):
    """SVGPModel (one bench `svgp` expert, N=1000, M=128), VFFModel and
    ASVGPModel (one bench `vff` expert, N=1000, D=2) on the card in f32
    through a user's calls, against the same model run on the CPU in f64
    from the same start."""
    from gpsat_tpu_torch.models import get_model
    c3 = common(3)
    c2 = common(2)
    c2["constraints"]["lengthscales"]["low"] = [0.05] * 2
    for family, D, extra, c, opt in (
            ("SVGPModel", 3, {"num_inducing_points": SVGP_BENCH["M"]}, c3,
             SVGP_OPT),
            ("VFFModel", 2, {"num_inducing_features": VFF_BENCH["m"]}, c2,
             c2["optim_kwargs"]),
            ("ASVGPModel", 2, {"num_inducing_features": ASVGP_M}, c2,
             c2["optim_kwargs"])):
        X, y, _, Xs = workload(1, SVGP_BENCH["N"], P, D, seed=11)
        res = {}
        for device in ("cuda", "cpu"):
            model = get_model(family)(
                coords=X[0], obs=y[0], kernel=c["kernel"],
                device=None if device == "cuda" else "cpu", **extra)
            require(model.device.type == device and model.dtype == (
                torch.float32 if device == "cuda" else torch.float64),
                f"{family} on {model.device} in {model.dtype}")
            model.set_parameter_constraints(c["constraints"],
                                            move_within_tol=True, tol=1e-2)
            t0 = time.perf_counter()
            ok = model.optimise_parameters(**opt)
            preds = model.predict(Xs[0])
            obj = model.get_objective_function_value()
            res[device] = (ok, preds, obj, time.perf_counter() - t0)
        (ok, preds, obj, wall), (ok64, ref, obj64, wall64) = \
            res["cuda"], res["cpu"]
        for k in PRED_KEYS:
            require(preds[k].shape == (P,) and np.isfinite(preds[k]).all(),
                    f"{family} {k}: shape {preds[k].shape} or non-finite")
        err = {k: float(np.max(np.abs(preds[k] - ref[k]))) for k in PRED_KEYS}
        rel = {k: float(np.max(np.abs(preds[k] - ref[k]) / np.abs(ref[k])))
               for k in PRED_KEYS}
        print(f"model {family}: card f32 success={ok} objective {obj:.4f} in "
              f"{wall:.3f} s; CPU f64 success={ok64} objective {obj64:.4f} in "
              f"{wall64:.3f} s; predictions max_abs_err {err}, max rel err "
              f"{rel}")
        atol, otol = FAMILY_MODEL_TOL[family]
        for k in PRED_KEYS:
            np.testing.assert_allclose(preds[k], ref[k], rtol=0,
                                       atol=atol[k], err_msg=f"{family} {k}")
        np.testing.assert_allclose(obj, obj64, rtol=otol,
                                   err_msg=f"{family} objective")


def phase_families(inp):
    """Phase 8: the bench workloads of the three families, their pipeline
    runs and their per-expert models."""
    from gpsat_tpu_torch.profile_sweep import _bench_common, workload
    t0 = time.perf_counter()
    phase_family_bench()
    t1 = time.perf_counter()
    phase_family_pipeline(inp)
    t2 = time.perf_counter()
    phase_family_models(workload, _bench_common)
    t3 = time.perf_counter()
    print(f"phase 8: bench {t1 - t0:.1f} s, pipeline {t2 - t1:.1f} s, "
          f"models {t3 - t2:.1f} s")


# ---------------------------------------------------------------------------
# KISS-GP and the multioutput models
# ---------------------------------------------------------------------------

# The structured KISS run: the N raw along-track points (all nine days,
# before binning) nearest the centre expert, on (x, y) in units of 100 km;
# the automatic grid (141 a side at N=20 000) makes N G^2 = 4e8 > 2**24, so
# the model picks structured mode itself; 30 Adam steps with 8 Hutchinson
# probes; P predictions on a 20 x 20 grid within +-190 km of the expert.
KISS_STRUCT = dict(N=20000, P=400, iterations=30, n_probes=8, subset=2000,
                   half=190 * KM)
# The two-instrument fusion on the largest expert: the phase-6 truth plus
# independent noise per instrument, L = Q = 2, instrument 2 seeing f1 + f2;
# MultioutputSVGPModel with M inducing points, its nonlinear form with S
# Monte-Carlo samples for at most `steps` Adam steps.
FUSION = dict(noise=(0.05, 0.1), H=((1.0, 0.0), (1.0, 1.0)), M=128, S=100,
              steps=300)
# Phase 9's limits, f32 on the card against f64: about four times the
# largest measured on the H100 (in brackets). "objective": relative;
# prediction keys: (rtol, atol); "params": {name: relative}. At one state
# (the f64 evaluation at the card's parameters): objectives rel (KISS dense
# 9.3e-8, MultioutputGPR 7.8e-7, MultioutputSVGP 1.3e-6 linear, 2.4e-7
# nonlinear), predictions within PRED_TOL / MO_PRED. Two fits from one
# start: KISS dense (f64, on the CPU and on the card alike) objective 2.6e-5, f* 1.9e-5, f*_var 7.8e-8,
# y_var 7.1e-8, lengthscales 2.5e-3, kernel variance 1.3e-2; KISS
# structured (f64 on the card, the same probes) objective 4.6e-4, f*
# 3.0e-5, f*_var 2.3e-7, y_var 3.3e-6, lengthscales 2.6e-3, kernel variance
# 3.8e-3, noise 1.2e-3; MultioutputGPR (f64 on the card) objective 6.1e-4.
PHASE9_TOL = {
    "KISS dense": {"objective": 4e-7},
    "KISS dense fits": {
        "objective": 1e-4, "f*": (1e-3, 1e-4), "f*_var": (1e-2, 3e-7),
        "y_var": (1e-3, 3e-7),
        "params": {"lengthscales": 1e-2, "kernel_variance": 6e-2,
                   "likelihood_variance": 1e-3}},
    "KISS structured predict": PRED_TOL,
    "KISS structured fits": {
        "objective": 2e-3, "f*": (1e-3, 1.2e-4), "f*_var": (1e-2, 1e-6),
        "y_var": (1e-3, 1.3e-5),
        "params": {"lengthscales": 1e-2, "kernel_variance": 1.6e-2,
                   "likelihood_variance": 5e-3}},
    "KISS structured matvec": 1e-10,
    "MultioutputGPR": {"objective": 3e-6},
    "MultioutputGPR fits": {"objective": 2.5e-3},
    "MultioutputSVGP linear": {"objective": 5e-6},
    "MultioutputSVGP nonlinear": {"objective": 1e-6}}
MO_PRED = {"f*": (1e-3, 1e-4), "f*_var": (1e-3, 1e-6), "y*": (1e-3, 1e-4),
           "y_var": (1e-3, 1e-6)}


def fusion_h(X, F):
    """The nonlinear forward model of the fusion: instrument 1 sees f1,
    instrument 2 sees f1 + f2 + f2^3 / 3."""
    return torch.stack([F[..., 0],
                        F[..., 0] + F[..., 1] + F[..., 1] ** 3 / 3], -1)


def largest_expert(inp):
    """(X, z, prediction points) of the expert with the most observations
    (phase 6's largest level), in raw units."""
    i = int(np.argmax([len(o) for o in inp["obs_list"]]))
    return inp["X_list"][i], inp["obs_list"][i], inp["pred_list"][i]


def scaled_constraints(d):
    """ARCTIC_MODEL's constraints for the first d coordinates, lengthscale
    bounds in raw units (as make_engine marks them under coords_scale)."""
    c = ARCTIC_MODEL["constraints"]
    return {"lengthscales": {"low": c["lengthscales"]["low"][:d],
                             "high": c["lengthscales"]["high"][:d],
                             "scale": True},
            "likelihood_variance": dict(c["likelihood_variance"])}


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def fit_twice(make, fit, card, ref):
    """The same model fitted from the same start on `card` and on `ref`,
    each a (device, dtype or None for the device's default) pair:
    ((model, success, wall s), (model, success, wall s))."""
    out = []
    for device, dtype in (card, ref):
        model = make(device, dtype)
        sync(device)
        t0 = time.perf_counter()
        ok = fit(model)
        sync(device)
        out.append((model, ok, time.perf_counter() - t0))
    return out


def at_params(make, model):
    """An f64 CPU model of `make` at `model`'s parameters."""
    ev = make("cpu", torch.float64)
    ev.set_parameters(**model.get_parameters())
    return ev


def hold_fits(name, m32, m64, Xs, keys, tol):
    """Two fits from one start, f32 on the card and f64: their objectives
    and predictions at `tol` ({"objective": rtol, key: (rtol, atol)}) and,
    where `tol["params"]` names a limit, their parameters; the parameters
    are printed either way."""
    pa, pb = m32.get_parameters(), m64.get_parameters()
    for k in pa:
        print(f"  {name} {k}: f32 fit {np.round(np.ravel(pa[k]), 6).tolist()}"
              f", f64 fit {np.round(np.ravel(pb[k]), 6).tolist()}")
    hold_rel(name, {"objective": m32.get_objective_function_value()},
             {"objective": m64.get_objective_function_value()},
             {"objective": tol["objective"]})
    if keys:
        g, w = m32.predict(Xs), m64.predict(Xs)
        hold_preds(name, {k: g[k][None] for k in keys},
                   {k: w[k][None] for k in keys},
                   np.ones((1,) + g["f*"].shape, bool),
                   {k: tol[k] for k in keys})
    hold_rel(name, pa, pb, tol.get("params", {}))


def hold_rel(name, got, want, limits):
    """Each {name: value} of `got` within its relative limit of `want`."""
    for k, lim in limits.items():
        rel = float(np.max(np.abs(np.asarray(got[k]) - np.asarray(want[k]))
                           / np.abs(np.asarray(want[k]))))
        print(f"  {name} {k}: rel err {rel:.3e} (limit {lim})")
        require(rel <= lim, f"{name} {k}: rel err {rel} beyond {lim}")


def hold_at_params(name, model, make, Xs, keys):
    """The card model's objective and predictions against the f64 CPU
    evaluation at its parameters (`keys`: {key: (rtol, atol)})."""
    ev = at_params(make, model)
    obj, obj64 = (m.get_objective_function_value() for m in (model, ev))
    g, w = model.predict(Xs), ev.predict(Xs)
    print(f"  {name}: objective {obj:.6f}, f64 at its parameters "
          f"{obj64:.6f}")
    hold_rel(name, {"objective": obj}, {"objective": obj64},
             {"objective": PHASE9_TOL[name]["objective"]})
    for k in keys:
        require(g[k].shape == w[k].shape and np.isfinite(g[k]).all(),
                f"{name} {k}: shape {g[k].shape} or non-finite")
    hold_preds(name, {k: g[k][None] for k in keys},
               {k: w[k][None] for k in keys},
               np.ones((1,) + g["f*"].shape, bool), keys)


def phase_kiss_dense(inp, dev="cuda"):
    """KISSGPModel on the largest expert of phase 6 (x, y, t, ARCTIC_MODEL's
    scale and constraints), the automatic grid (dense), fitted by L-BFGS on
    the card in f32 and, from the same start, in f64 on the card: on the
    CPU the f64 fit took 7-9 s, cut to keep the script near its budget."""
    from gpsat_tpu_torch.models.kiss_gpr import KISSGPModel
    X, z, Xs = largest_expert(inp)
    scale = ARCTIC_MODEL["init_params"]["coords_scale"]

    def make(device, dtype):
        m = KISSGPModel(coords=X, obs=z, coords_scale=scale,
                        kernel="Matern32", device=device, dtype=dtype)
        m.set_parameter_constraints(scaled_constraints(3))
        return m
    (m32, ok, wall), (m64, ok64, wall64) = fit_twice(
        make, lambda m: m.optimise_parameters(), (dev, None),
        (dev, torch.float64))
    require(not m32.structured and m32.grid_size == m64.grid_size,
            f"KISS dense: structured {m32.structured}, grid {m32.grid_size}")
    print(f"KISS dense N={len(z)} P={len(Xs)} grid {m32.grid_size}^3 on "
          f"{m32.device} {m32.dtype}: fit {wall:.3f} s success={ok}; "
          f"{m64.dtype} fit {wall64:.3f} s success={ok64}")
    hold_at_params("KISS dense", m32, make, Xs, PRED_TOL)
    hold_fits("KISS dense fits", m32, m64, Xs, PRED_KEYS,
              PHASE9_TOL["KISS dense fits"])


class counting_cg:
    """Counts the CG iterations (matvecs) that ops/ski_structured runs while
    the context is open: it wraps the module's cg_solve, which its fit and
    predict call by name, and restores it on exit."""

    def __enter__(self):
        from gpsat_tpu_torch.ops import ski_structured as skis
        self.module, self.orig, self.calls = skis, skis.cg_solve, []

        def cg(matvec, B, **kw):
            n = [0]

            def mv(v):
                n[0] += 1
                return matvec(v)
            x = self.orig(mv, B, **kw)
            self.calls.append((B.shape[0], n[0]))
            return x
        skis.cg_solve = cg
        return self

    def __exit__(self, *exc):
        self.module.cg_solve = self.orig
        return False


def kiss_struct_data(cfg=KISS_STRUCT):
    """The N raw track points nearest the centre expert on (x, y), their
    radius, and the P prediction points."""
    x, y, _, z = arctic_tracks()
    r2 = x ** 2 + y ** 2
    near = np.argsort(r2, kind="stable")[:cfg["N"]]
    side = int(round(np.sqrt(cfg["P"])))
    g = np.linspace(-cfg["half"], cfg["half"], side)
    gx, gy = np.meshgrid(g, g, indexing="ij")
    return (np.stack([x[near], y[near]], 1), z[near],
            float(np.sqrt(r2[near[-1]])),
            np.stack([gx.ravel(), gy.ravel()], 1))


def phase_kiss_structured(dev="cuda", cfg=KISS_STRUCT):
    """KISSGPModel on N along-track points, structured by its own choice:
    Adam in f32 on the card, predict at P points; ski_matvec against the
    dense W Kg W^T v + s2 v on a random subset in f64; the f32 predictions
    against the same call in f64 at the same parameters; the fit against an
    f64 fit on the card with the same probes."""
    from gpsat_tpu_torch.models.kiss_gpr import KISSGPModel
    from gpsat_tpu_torch.ops import ski
    from gpsat_tpu_torch.ops import ski_structured as skis
    from gpsat_tpu_torch.ops.kernels import kernel_fn
    X, z, radius, Xs = kiss_struct_data(cfg)

    def make(device, dtype):
        m = KISSGPModel(coords=X, obs=z, coords_scale=[1e5, 1e5],
                        kernel="Matern32", device=device, dtype=dtype)
        m.set_parameter_constraints(scaled_constraints(2))
        return m
    m32 = make(dev, None)
    N, G = len(z), m32.grid_size
    require(m32.structured and N * G ** 2 > 2 ** 24,
            f"KISS structured: N {N}, grid {G}, structured {m32.structured}")
    probes = skis.draw_probes(cfg["n_probes"], N, 0, m32.dtype, m32.device)
    if m32.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with counting_cg() as cg_fit:
        sync(dev)
        t0 = time.perf_counter()
        ok = m32.optimise_parameters(iterations=cfg["iterations"],
                                     probes=probes)
        sync(dev)
        fit_wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if m32.device.type == "cuda" else float("nan")
    with counting_cg() as cg_pred:
        t0 = time.perf_counter()
        preds = m32.predict(Xs)
        sync(dev)
        pred_wall = time.perf_counter() - t0
    its = [n for _, n in cg_fit.calls]
    print(f"KISS structured N={N} (radius {radius / KM:.1f} km, all "
          f"{ARCTIC['days']} days) grid {G}^2 on {m32.device} {m32.dtype}: "
          f"fit {fit_wall:.3f} s ({cfg['iterations']} Adam steps, "
          f"{cfg['n_probes']} probes, success={ok}), CG iterations a step "
          f"(first, median, last, max; to the next multiple of "
          f"{skis.CG_CHECK_EVERY}) {its[0]}, {int(np.median(its))}, "
          f"{its[-1]}, {max(its)}, in all {sum(its)}; predict P={len(Xs)} "
          f"{pred_wall:.3f} s, CG (rhs, iterations) {cg_pred.calls}; peak "
          f"{peak:.2f} GiB")
    for k in PRED_TOL:
        require(preds[k].shape == (len(Xs),) and np.isfinite(preds[k]).all(),
                f"KISS structured {k}: shape or non-finite")

    # the same predict call in f64 at the f32 fit's parameters, on the card
    ev = make(dev, torch.float64)
    ev.set_parameters(**m32.get_parameters())
    ref = ev.predict(Xs)
    hold_preds("KISS structured predict f32 vs f64",
               {k: preds[k][None] for k in PRED_TOL},
               {k: ref[k][None] for k in PRED_TOL},
               np.ones((1, len(Xs)), bool),
               PHASE9_TOL["KISS structured predict"])

    # an f64 fit from the same start with the same probes, on the card
    m64 = make(dev, torch.float64)
    sync(dev)
    t0 = time.perf_counter()
    m64.optimise_parameters(iterations=cfg["iterations"],
                            probes=probes.to(torch.float64))
    sync(dev)
    print(f"  KISS structured f64 fit on {m64.device}: "
          f"{time.perf_counter() - t0:.3f} s")
    hold_fits("KISS structured fits", m32, m64, Xs, PRED_KEYS,
              PHASE9_TOL["KISS structured fits"])

    # ski_matvec against the dense product on a random subset, f64
    rng = np.random.default_rng(5)
    sub = np.sort(rng.choice(N, cfg["subset"], replace=False))
    Xsub = ev.coords[sub]
    params = ev._param_dict()
    sp = skis.SparseInterp(Xsub, ev._starts, ev._steps, G,
                           dtype=torch.float64, device=ev.device)
    v = torch.as_tensor(rng.standard_normal(len(sub)), device=ev.device)
    got = skis.ski_matvec(params, sp, ev._steps, G, "Matern32", 2, v)
    st, sp_ = ev._tensor(ev._starts), ev._tensor(ev._steps)
    W = ski.interp_matrix(ev._tensor(Xsub), st, sp_, G)
    Zg = ski.grid_points(st, sp_, G, 2)
    Kg = kernel_fn("Matern32")(Zg, Zg, params["lengthscales"],
                               params["kernel_variance"])
    want = W @ (Kg @ (W.mT @ v)) + params["likelihood_variance"] * v
    del Kg
    lim = PHASE9_TOL["KISS structured matvec"]
    rel = float(torch.max(torch.abs(got - want)) / torch.max(torch.abs(want)))
    print(f"  KISS structured ski_matvec vs dense on {len(sub)} rows, f64: "
          f"max err {rel:.3e} of max |Kv| (limit {lim})")
    require(rel <= lim, f"ski_matvec off dense by {rel}")


def fusion_kwargs(inp):
    """The prediction points and the model arguments of the two-instrument
    fusion on the largest expert: each column the truth plus its own
    instrument's noise, R diagonal."""
    X, _, Xs = largest_expert(inp)
    rng = np.random.default_rng(9)
    truth = truth_field(X[:, 0], X[:, 1])
    Y = np.stack([truth + s * rng.standard_normal(len(X))
                  for s in FUSION["noise"]], 1)
    return Xs, dict(coords=X, obs=Y, coords_scale=ARCTIC_MODEL[
        "init_params"]["coords_scale"], num_latent_gps=2,
        R=np.diag(np.square(FUSION["noise"])))


def phase_mogpr(inp, dev="cuda"):
    """MultioutputGPRModel, the two-instrument fusion (observation covariance
    [2N, 2N]), L-BFGS on the card in f32, and from the same start in f64 on
    the card (on the CPU it would take minutes); the card's log marginal
    likelihood, latent f and predict_y's diagonals against f64 at its
    parameters."""
    from gpsat_tpu_torch.models.multioutput import MultioutputGPRModel
    Xs, kw = fusion_kwargs(inp)

    def make(device, dtype):
        return MultioutputGPRModel(device=device, dtype=dtype,
                                   H=np.array(FUSION["H"]), **kw)
    (m32, ok, wall), (m64, ok64, wall64) = fit_twice(
        make, lambda m: m.optimise_parameters(), (dev, None),
        (dev, torch.float64))
    N = len(kw["obs"])
    print(f"MultioutputGPRModel N={N} P=2 (covariance [{2 * N}, {2 * N}]) "
          f"on {m32.device} {m32.dtype}: fit {wall:.3f} s success={ok}; "
          f"{m64.dtype} fit {wall64:.3f} s success={ok64}")
    hold_at_params("MultioutputGPR", m32, make, Xs, MO_PRED)
    # the fusion's second latent is not identifiable (both instruments see
    # the one truth, so f2 = 0 and its parameters are free) and the first
    # latent's lengthscales run flat beyond the expert's extent: the two fits
    # stop at different points of a flat valley, so only their objectives
    # are held; their predictions' distance is printed
    hold_fits("MultioutputGPR fits", m32, m64, Xs, (),
              PHASE9_TOL["MultioutputGPR fits"])
    g, w = m32.predict(Xs), m64.predict(Xs)
    print("  MultioutputGPR fits: f32 fit against the f64 fit, max abs "
          + ", ".join(f"{k} {np.max(np.abs(g[k] - w[k])):.3e}"
                      for k in ("f*", "f*_var", "y*", "y_var")))


def phase_mosvgp(inp, dev="cuda"):
    """MultioutputSVGPModel on the fusion data with M inducing points: the
    linear H by Adam at the model's defaults (plateau stop), then the
    nonlinear forward model with S Monte-Carlo samples for at most `steps`
    steps; each card state's ELBO (the nonlinear one with one fixed eps)
    and predictions against the f64 evaluation of the same state."""
    from gpsat_tpu_torch.models.multioutput import MultioutputSVGPModel
    Xs, kw = fusion_kwargs(inp)
    kw["num_inducing_points"] = FUSION["M"]
    for name, extra, opt in (
            ("linear", {"H": np.array(FUSION["H"])}, {}),
            ("nonlinear", {"forward_model": fusion_h,
                           "num_mc_samples": FUSION["S"]},
             {"max_iter": FUSION["steps"]})):
        def make(device, dtype):
            return MultioutputSVGPModel(device=device, dtype=dtype, **extra,
                                        **kw)
        m = make(dev, None)
        sync(dev)
        t0 = time.perf_counter()
        ok = m.optimise_parameters(**opt)
        sync(dev)
        wall = time.perf_counter() - t0
        eps = m.draw_eps() if m.h is not None else None
        elbo = m.get_objective_function_value(eps=eps)
        preds = m.predict(Xs)
        ev = at_params(make, m)
        elbo64 = ev.get_objective_function_value(
            eps=None if eps is None else eps.to("cpu", torch.float64))
        ref = ev.predict(Xs)
        keys = MO_PRED if m.H is not None else {
            k: MO_PRED[k] for k in ("f*", "f*_var")}
        print(f"MultioutputSVGPModel {name} N={len(kw['obs'])} "
              f"M={FUSION['M']} on {m.device} {m.dtype}: "
              f"{m._last_opt_steps} steps in {wall:.3f} s (success={ok}); "
              f"ELBO {elbo:.4f} against f64 {elbo64:.4f}")
        tag = f"MultioutputSVGP {name}"
        hold_rel(tag, {"elbo": elbo}, {"elbo": elbo64},
                 {"elbo": PHASE9_TOL[tag]["objective"]})
        for k in keys:
            require(preds[k].shape == ref[k].shape and
                    np.isfinite(preds[k]).all(), f"{tag} {k}: non-finite")
        hold_preds(f"{tag} vs f64", {k: preds[k][None] for k in keys},
                   {k: ref[k][None] for k in keys},
                   np.ones((1,) + preds["f*"].shape, bool), keys)


def check_family_names():
    """make_engine(get_model(name)) gives the JAX pipeline's engine for the
    new names, by its name fallback (an assertion, no run)."""
    from gpsat_tpu_torch.local_experts import make_engine
    from gpsat_tpu_torch.models import get_model
    for name, want in (("KISSGPModel", "BatchedGPR"),
                       ("MultioutputGPRModel", "BatchedGPR"),
                       ("MultioutputSVGPModel", "BatchedSVGP")):
        got = type(make_engine(get_model(name), {}, coords_dim=3)).__name__
        require(got == want, f"{name}: engine {got}, not {want}")


def phase_kiss_multioutput(inp):
    """Phase 9: KISS-GP dense and structured, the two multioutput models,
    and their engines' names."""
    t = [time.perf_counter()]
    phase_kiss_dense(inp)
    t.append(time.perf_counter())
    phase_kiss_structured()
    t.append(time.perf_counter())
    phase_mogpr(inp)
    t.append(time.perf_counter())
    phase_mosvgp(inp)
    t.append(time.perf_counter())
    check_family_names()
    d = np.diff(t)
    print(f"phase 9: KISS dense {d[0]:.1f} s, structured {d[1]:.1f} s, "
          f"MultioutputGPR {d[2]:.1f} s, MultioutputSVGP {d[3]:.1f} s")



# ---------------------------------------------------------------------------
# phase 10: the expert mesh
# ---------------------------------------------------------------------------

# the smoothers over the mesh against phase 7's dense result (the JAX
# package's test bounds, tests/test_postprocessing.py:119 and :137)
SHARDED_ATOL = 1e-10
TILED_TOL = (1e-7, 1e-9)
# the cross-check engine against the custom one, f32 NLML at each optimum
OPTAX_RTOL = 1e-3


def mesh_of_run():
    """Every card where there are two or more; else two shards of cuda:0,
    each on its own stream."""
    from gpsat_tpu_torch.parallel.mesh import get_mesh
    if torch.cuda.device_count() >= 2:
        return get_mesh()
    return get_mesh(devices=["cuda:0", "cuda:0"])


def differing_fields(a, b):
    """{field: [E] bool}: the experts whose iterations, converged,
    objective, each parameter and each prediction (on its valid points)
    differ between runs a and b in any bit (NaN equal to NaN)."""
    def neq(x, y):
        x, y = np.asarray(x), np.asarray(y)
        d = (x != y) & ~(np.isnan(x) & np.isnan(y)) if x.dtype.kind == "f" \
            else x != y
        return d.reshape(len(d), -1).any(axis=1)
    valid = pred_valid(a)
    out = {k: neq(a[k], b[k]) for k in ("iterations", "converged",
                                        "objective")}
    out.update({k: neq(a["params"][k], b["params"][k]) for k in a["params"]})
    out.update({k: neq(np.where(valid, a["preds"][k], 0.0),
                       np.where(valid, b["preds"][k], 0.0))
                for k in PRED_KEYS})
    return out


def report_mesh_run(name, out, ref):
    """Print a mesh run's levels (seconds, each shard's pool iterations)
    and its experts that differ from the one-device run `ref`, by field.
    Returns [E] bool, the experts that differ in any field."""
    for b, r in zip(out["buckets"], ref["buckets"]):
        print(f"  {name} level N={b['n_max']} P={b['p_max']}: {b['experts']} "
              f"experts, {b['seconds']:.3f} s (one device {r['seconds']:.3f} "
              f"s), pool iterations by shard {b['shard_pool_iterations']} "
              f"(one device {r['pool_iterations']})")
    fields = differing_fields(out, ref)
    diff = np.any(list(fields.values()), axis=0)
    print(f"{name}: {int(diff.sum())} of {len(diff)} experts differ from the "
          f"one-device run in any bit; by field "
          f"{ {k: int(v.sum()) for k, v in fields.items()} }")
    return diff


def shard_overlap(engine, inp, mesh, experts=512):
    """One torch.profiler trace of fit_predict_many over the mesh on the
    first `experts` experts of the largest level: each shard stream's busy
    ms and the ms during which two streams were busy at once."""
    from gpsat_tpu_torch.device_profile import overlap_us, stream_busy
    bk = buckets_of(inp)[-1]
    X, y, mask, Xs, *_ = assembled(inp, bk)
    rows = slice(0, min(experts, len(bk["indices"])))
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        engine.fit_predict_many(X[rows], y[rows], mask[rows], Xs=Xs[rows],
                                mesh=mesh)
        torch.cuda.synchronize()
    busy = stream_busy(prof)
    streams = {k: sum(b - a for a, b in iv) * 1e-3 for k, iv in busy.items()}
    # the shards' streams: the mesh.size busiest (the profiler names a
    # stream by its own id; the default stream carries the few copies made
    # outside the shards)
    top = sorted(streams, key=streams.get, reverse=True)[:mesh.size]
    both = overlap_us({k: busy[k] for k in top}) * 1e-3
    return bk["n_max"], rows.stop, streams, top, both


def phase_mesh_pipeline(cuda_gpr, inp, fitted, sgpr, mesh):
    """Phase 6's GPR and SGPR runs again through execute_buckets(mesh=...):
    launches, each shard's pool iterations, every expert against phase 6's
    one-device run (differing experts held against f64 at PRED_TOL), and
    the trace's evidence that the shards' streams overlap. Returns the
    launches of the two runs."""
    from gpsat_tpu_torch.local_experts import make_engine
    from gpsat_tpu_torch.models.exact_gpr import GPRModel
    from gpsat_tpu_torch.models.sgpr import SGPRModel

    engine = make_engine(GPRModel, ARCTIC_MODEL["init_params"],
                         ARCTIC_MODEL["constraints"], coords_dim=3)
    E = len(inp["X_list"])
    cuda_gpr.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_pipeline(engine, inp, mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in cuda_gpr.launch_counts().items() if v}
    print(f"mesh GPR: E={E} execute {wall:.3f} s ({E / wall:.2f} experts/s) "
          f"over {mesh.size} shards, launches={launches}")
    require(launches.get("nlml_vg", 0) > 0 and
            launches.get("posterior_predict", 0) > 0,
            f"mesh GPR: a kernel was not launched: {launches}")
    diff = report_mesh_run("mesh GPR", out, fitted)
    require(float(np.mean(out["converged"])) >= 0.99,
            "mesh GPR converged fraction")
    if diff.any():
        perr, _ = check_gpr_against_f64(inp, out, engine.kernel,
                                        name="mesh GPR vs f64")
        print(f"mesh GPR vs f64 at its fitted parameters (all {E} "
              f"experts): predictions max_abs_err {perr:.3e}")

    sub = sgpr["sub"]
    init = dict(ARCTIC_MODEL["init_params"], num_inducing_points=SGPR_RUN["M"],
                route=SGPR_RUN["route"])
    s_engine = make_engine(SGPRModel, init, ARCTIC_MODEL["constraints"],
                           coords_dim=3)
    cuda_gpr.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_out = run_pipeline(s_engine, sub, mesh)
    torch.cuda.synchronize()
    s_wall = time.perf_counter() - t0
    s_launches = {k: v for k, v in cuda_gpr.launch_counts().items() if v}
    print(f"mesh SGPR: E={len(sub['X_list'])} route={SGPR_RUN['route']} "
          f"{s_wall:.3f} s (one device: phase 6), launches={s_launches}")
    require(s_launches.get("sgpr_vg_mega", 0) > 0 and
            s_launches.get("cholinv", 0) > 0,
            f"mesh SGPR: a kernel was not launched: {s_launches}")
    s_diff = report_mesh_run("mesh SGPR", s_out, sgpr["out"])
    if s_diff.any():
        hold_sgpr_f64("mesh SGPR vs f64", sub, s_out, s_engine)

    n_top, width, streams, top, both = shard_overlap(engine, inp, mesh)
    print(f"mesh overlap trace (fit_predict_many, level N={n_top}, first "
          f"{width} experts): busy ms by (device, stream) "
          f"{ {k: round(v, 3) for k, v in streams.items()} }; the shards' "
          f"streams {top} busy at once {both:.3f} ms")
    require(len(streams) >= mesh.size,
            f"the trace shows {len(streams)} busy streams, not one a shard")
    require(both > 0, "the shards' streams never ran at once")
    return {k: launches.get(k, 0) + s_launches.get(k, 0)
            for k in set(launches) | set(s_launches)}



def phase_mesh_smoothers(inp, fitted, smoothed, mesh):
    """Phase 7's five fields smoothed over the mesh by the sharded and the
    tiled smoother, with smooth_field's clamps, each held against phase 7's
    dense result (SHARDED_ATOL, TILED_TOL)."""
    from gpsat_tpu_torch.postprocessing import (gaussian_2d_smooth_sharded,
                                                gaussian_2d_smooth_tiled)
    x, y = inp["experts"][:, 0], inp["experts"][:, 1]
    lx, ly = SMOOTHING["l_x"], SMOOTHING["l_y"]
    secs = {}
    for name, v in fitted["params"].items():
        cols = v.reshape(len(x), -1)
        want = smoothed[name].reshape(len(x), -1)
        hi = SMOOTHING["max"].get(name)
        for j in range(cols.shape[1]):
            field = f"{name}[{j}]" if cols.shape[1] > 1 else name
            vals = cols[:, j] if hi is None else np.minimum(cols[:, j], hi)
            for kind, fn in (("sharded", gaussian_2d_smooth_sharded),
                             ("tiled", gaussian_2d_smooth_tiled)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = fn(x, y, x, y, lx, ly, vals, mesh=mesh)
                torch.cuda.synchronize()
                secs[(kind, field)] = time.perf_counter() - t0
                got = got if hi is None else np.minimum(got, hi)
                err = float(np.max(np.abs(got - want[:, j])))
                print(f"mesh smoothed {field} ({kind}): "
                      f"{secs[(kind, field)]:.4f} s, max_abs_err {err:.3e} "
                      f"against phase 7's dense result")
                rtol, atol = (0.0, SHARDED_ATOL) if kind == "sharded" \
                    else TILED_TOL
                np.testing.assert_allclose(got, want[:, j], rtol=rtol,
                                           atol=atol,
                                           err_msg=f"{kind} {field}")
    return secs


def phase_optax(workload, bench_gpr_engine, E=8):
    """batched_lbfgs(engine="optax") on E experts of the bench gpr workload
    (autograd through the f32 NLML on the card) against the custom
    engine's optimum on the same start: NLML within OPTAX_RTOL."""
    from gpsat_tpu_torch.models.exact_gpr import make_gpr_objective
    from gpsat_tpu_torch.ops.lbfgs import batched_lbfgs, linesearch_policy
    X, y, mask, _ = workload(E, N, 1, D)
    eng = bench_gpr_engine(D)
    objective, _ = make_gpr_objective(eng.kernel, eng.free_names, eng.d)
    init = eng._initial_params_batch(E, y_var=eng._signal_variance(y, mask))
    fixed = {n: eng._tensor(init[n]) for n in eng.HYPER_NAMES
             if n not in eng.free_names}
    args = (eng._tensor(X), eng._tensor(y), eng._tensor(mask, torch.bool),
            eng._batched_bijectors(E), fixed)
    u0 = eng._unconstrained(init, E)
    mls, rec = linesearch_policy(eng.dtype, "gpr", n=N)
    walls, res = {}, {}
    for name in ("custom", "optax"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[name] = batched_lbfgs(objective, u0, args, eng.max_iter, eng.gtol,
                                  eng.ftol, 10, mls, rec, engine=name)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
    f = {k: r.fun.cpu().numpy() for k, r in res.items()}
    rel = float(np.max(np.abs(f["optax"] / f["custom"] - 1)))
    print(f"optax engine: {E} bench gpr experts (N={N}, f32 on the card) in "
          f"{walls['optax']:.3f} s ({walls['custom']:.3f} s custom), "
          f"iterations {res['optax'].iterations.tolist()} (custom "
          f"{res['custom'].iterations.tolist()}), NLML max rel err "
          f"{rel:.3e} against the custom engine (rtol {OPTAX_RTOL})")
    require(np.isfinite(f["optax"]).all(), "optax engine: non-finite NLML")
    np.testing.assert_allclose(f["optax"], f["custom"], rtol=OPTAX_RTOL,
                               err_msg="optax engine NLML")


def phase_mesh(cuda_gpr, inp, fitted, sgpr, smoothed, workload,
               bench_gpr_engine):
    """Phase 10: the expert mesh. Returns the launches of its pipeline
    runs, {kernel: launches}."""
    from gpsat_tpu_torch.entry_points import dryrun_multichip
    t = [time.perf_counter()]
    mesh = mesh_of_run()
    print(f"mesh: {mesh} on "
          f"{[torch.cuda.get_device_name(d) for d in mesh.devices]}, "
          f"streams {[getattr(mesh.stream(k), 'cuda_stream', None) for k in range(mesh.size)]}")
    launches = phase_mesh_pipeline(cuda_gpr, inp, fitted, sgpr, mesh)
    t.append(time.perf_counter())
    phase_mesh_smoothers(inp, fitted, smoothed, mesh)
    t.append(time.perf_counter())
    dryrun_multichip(mesh.size, devices=mesh.devices)
    t.append(time.perf_counter())
    phase_optax(workload, bench_gpr_engine)
    t.append(time.perf_counter())
    d = np.diff(t)
    print(f"phase 10: pipelines {d[0]:.1f} s, smoothers {d[1]:.1f} s, "
          f"dryrun {d[2]:.1f} s, optax {d[3]:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 11: the application drivers on the card
# ---------------------------------------------------------------------------

# the sea-ice driver's expert spacings: its default, and phase 6's north-star
# spacing on the driver's +-1000 km grid
SEA_ICE_SPACINGS = (400 * KM, 50 * KM)
# experts of the 50 km run held against the same run on the CPU in f64
SEA_ICE_SUBSET = 4
# the card's f32 fit against the CPU's f64 fit of the same experts: two
# optimisations that stop at different points of a flat ELBO (the
# lengthscales at their bound; PERF.md §7, SGPR's f32 optima). On the H100
# (4 experts; 8 in an earlier run): ELBO 1.77e-3 (1.96e-3) relative, f*
# 7.9e-3 (6.5e-3) apart, f*_var 1.2e-4 and y_var 2.0e-4 apart (median
# 7.9e-4 and 7.5e-3). SUBSET_TOL's f* atol of 1e-3 is beyond two f32/f64
# optima here. Limits about three times the measured.
SEA_ICE_SUBSET_TOL = {"f*": (1e-2, 2.5e-2), "f*_var": (1e-1, 4e-4),
                      "y_var": (1e-1, 6e-4)}
SEA_ICE_ELBO_RTOL = 6e-3
# the sea-ice runs' f32 predictions against f64 at the same parameters. The
# driver's optima put the x and y lengthscales at or near their 1000 km
# bound (20 coords_scale units, 20 inducing spacings), where Kuu is near
# singular in f32: on the H100 the plain f32 prediction (ops/sgpr.predict)
# is 1.02e-4 off f64 in f*, the route's (cholinv's explicit W) 1.68e-4, and
# f*_var 2.7e-3 relative at 400 km; at 50 km the route's f* is 3.9e-4 off
# (plain 1.9e-4), f*_var 6.2e-3 and y_var 6.4e-4 relative. PRED_TOL's f*
# atol of 1e-4 is out of f32's reach here: SUBSET_TOL, but y_var at a
# tenth of its rtol (about three times the measured).
SEA_ICE_TOL = dict(SUBSET_TOL, y_var=(2e-3, 1e-6))
# the route's largest error against f64 over the plain f32 prediction's, in
# the same call: measured on the H100 1.64-2.11 in f* and 2.36-3.37 in the
# variances over the four sea-ice runs
SEA_ICE_ROUTE_RATIO = {"f*": 3.0, "f*_var": 4.0, "y_var": 4.0}


def sea_ice_run(cuda_gpr, sid, data, spacing):
    """The sea-ice driver's device half at one expert spacing: the first
    stage (SGPRModel as MODEL_CONFIG configures it, optimised) through
    execute_buckets, its hyperparameters smoothed on the card with the
    driver's settings, and the re-predict of every expert with
    optimise=False at the smoothed parameters and the first stage's
    inducing points; each run's f*, f*_var and y_var of every expert
    against f64 at its parameters (SEA_ICE_TOL, and within
    SEA_ICE_ROUTE_RATIO of the plain f32 version's error). Returns the
    launches of both runs, the inputs and the first stage's result."""
    from gpsat_tpu_torch.local_experts import execute_buckets, make_engine
    from gpsat_tpu_torch.models.sgpr import SGPRModel
    cfg = sid.MODEL_CONFIG
    scale = cfg["init_params"]["coords_scale"]
    experts = sid.expert_grid(spacing)
    t0 = time.perf_counter()
    X_list, obs_list, pred_list = sid.local_inputs(data, experts)
    inp = {"X_list": X_list, "obs_list": obs_list, "pred_list": pred_list,
           "experts": experts}
    n = np.array([len(o) for o in obs_list])
    print(f"sea-ice {spacing / KM:.0f} km: {len(experts)} experts, gather "
          f"{time.perf_counter() - t0:.2f} s, N (0, 50, 100 %) "
          f"{np.percentile(n, [0, 50, 100])}, P (0, 100 %) "
          f"{np.percentile([len(q) for q in pred_list], [0, 100])}")
    require(n.min() >= 3, f"an expert with {n.min()} observations")
    engine = make_engine(SGPRModel, cfg["init_params"], cfg["constraints"],
                         coords_dim=3)
    require(engine.route == "hybrid" and engine.num_inducing == 300,
            f"sea-ice engine route {engine.route} M {engine.num_inducing}")
    launches = {}

    def counted(**kw):
        cuda_gpr.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        o = execute_buckets(engine, X_list, obs_list, pred_list,
                            coords_scale=scale, expert_locs=experts, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = {k: v for k, v in cuda_gpr.launch_counts().items() if v}
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        return o, wall, got

    out, wall, got = counted()
    conv = float(np.mean(out["converged"]))
    print(f"sea-ice {spacing / KM:.0f} km fit: {len(experts)} experts in "
          f"{wall:.3f} s ({len(experts) / wall:.2f} experts/s), converged "
          f"{conv:.4f}, levels (N, experts, pool iterations) "
          f"{[(b['n_max'], b['experts'], b['pool_iterations']) for b in out['buckets']]}, "
          f"launches {got}")
    require(got.get("cholinv", 0) > 0, f"sea-ice fit: no cholinv: {got}")
    require(conv >= 0.95, f"sea-ice fit converged fraction {conv}")
    require(np.isfinite(out["objective"]).all(), "sea-ice: non-finite ELBO")
    hold_sgpr_f64(f"sea-ice {spacing / KM:.0f} km fit vs f64", inp, out,
                  engine, coords_scale=scale, tol=SEA_ICE_TOL,
                  plain_ratio=SEA_ICE_ROUTE_RATIO)

    t = time.perf_counter()
    smoothed = sid.smooth_params(experts, out["params"], device="cuda")
    torch.cuda.synchronize()
    print(f"sea-ice {spacing / KM:.0f} km smoothing on the card: "
          f"{time.perf_counter() - t:.4f} s")
    for name, cfg_s in sid.SMOOTH_CONFIG.items():
        require(np.isfinite(smoothed[name]).all(), f"smoothed {name}")
        require(cfg_s.get("max") is None or
                smoothed[name].max() <= cfg_s["max"], f"{name} above max")
    overrides = dict(smoothed,
                     inducing_points=out["params"]["inducing_points"])
    again, wall, got = counted(overrides=overrides, optimise=False)
    print(f"sea-ice {spacing / KM:.0f} km re-predict: {wall:.3f} s, "
          f"launches {got}")
    require((again["iterations"] == 0).all(), "re-predict took steps")
    require(got.get("cholinv", 0) > 0, f"re-predict: no cholinv: {got}")
    moved = max(float(np.max(np.abs(again["params"][k] / smoothed[k] - 1)))
                for k in sid.SMOOTH_CONFIG)
    print(f"  re-predict parameters against the smoothed ones (an f32 round "
          f"trip through the bijectors): max rel {moved:.3e}")
    hold_sgpr_f64(f"sea-ice {spacing / KM:.0f} km re-predict vs f64", inp,
                  again, engine, coords_scale=scale, tol=SEA_ICE_TOL,
                  plain_ratio=SEA_ICE_ROUTE_RATIO)
    valid = pred_valid(again)
    pred_xy = np.concatenate(pred_list)[:, :2]
    owner = np.repeat(experts[:, :2], [len(q) for q in pred_list], axis=0)
    rmse = sid.merged_rmse(pred_xy, owner, again["preds"]["f*"][valid],
                           float(np.mean(np.repeat(again["f_bar"],
                                                   valid.sum(1)))))
    print(f"sea-ice {spacing / KM:.0f} km merged thickness RMSE against "
          f"the truth: {rmse:.5f} m (observation noise 0.10 m; the JAX "
          f"driver at 2 experts on the CPU: 0.0391 m)")
    require(rmse < 0.1, f"sea-ice RMSE {rmse} not below the noise")
    return launches, inp, out, engine


def phase_drivers(cuda_gpr):
    """Phase 11: (a) the sea-ice driver's device half at its default expert
    spacing and at 50 km, from the port driver's numpy cores (6000 synthetic
    points of seed 0 binned to 50 km, the SIC < 0.15 pseudo-observations,
    the synthetic secondary instrument fused), with SEA_ICE_SUBSET experts
    of the 50 km run against the same call on the CPU in f64
    (SEA_ICE_SUBSET_TOL); (b) numerical_stability_check.main on the card: its own
    check, the vg and predict kernels launched in its f32 cases, and each
    jittered f32 case's f* against the f64 case's (PRED_TOL). Returns the
    launches of the phase, {kernel: launches}."""
    from gpsat_tpu_torch.examples import numerical_stability_check as nsc
    from gpsat_tpu_torch.examples import sea_ice_freeboard_driver as sid
    from gpsat_tpu_torch.local_experts import execute_buckets, make_engine
    from gpsat_tpu_torch.models.sgpr import SGPRModel

    t_phase = time.perf_counter()
    data = sid.driver_arrays(plus_secondary=True)
    print(f"sea-ice driver data: {len(data['z'])} training rows (binned "
          f"observations, SIC pseudo-observations, secondary instrument)")
    launches = {}
    for spacing in SEA_ICE_SPACINGS:
        got, inp, out, engine = sea_ice_run(cuda_gpr, sid, data, spacing)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    picks = pick_spread(inp, n=SEA_ICE_SUBSET, top=1)
    cfg = sid.MODEL_CONFIG
    cpu = make_engine(SGPRModel, cfg["init_params"], cfg["constraints"],
                      coords_dim=3, device="cpu")
    t0 = time.perf_counter()
    ref = execute_buckets(cpu, *(subset(inp, picks)[k] for k in (
        "X_list", "obs_list", "pred_list")),
        coords_scale=cfg["init_params"]["coords_scale"],
        expert_locs=inp["experts"][picks])
    rel = float(np.max(np.abs(out["objective"][picks] / ref["objective"]
                              - 1)))
    print(f"sea-ice CPU f64 run of {len(picks)} experts (N "
          f"{[len(inp['obs_list'][i]) for i in picks]}) in "
          f"{time.perf_counter() - t0:.2f} s: ELBO max rel err {rel:.3e}")
    width = ref["preds"]["f*"].shape[1]
    got = {k: out["preds"][k][picks, :width] for k in PRED_TOL}
    valid = pred_valid(ref)
    for k in PRED_TOL:
        e = np.abs(got[k] - ref["preds"][k])[valid]
        w = np.abs(ref["preds"][k])[valid]
        print(f"  sea-ice CPU f64 {k}: max_abs_err {e.max():.3e}, 99 % "
              f"{np.quantile(e, 0.99):.3e}, max rel err "
              f"{np.max(e / np.maximum(w, 1e-300)):.3e}")
    hold_preds("sea-ice CPU f64", got, ref["preds"], valid,
               tol=SEA_ICE_SUBSET_TOL)
    np.testing.assert_allclose(out["objective"][picks], ref["objective"],
                               rtol=SEA_ICE_ELBO_RTOL,
                               err_msg="sea-ice CPU ELBO")

    cuda_gpr.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cases = nsc.main(device="cuda")
    torch.cuda.synchronize()
    got = {k: v for k, v in cuda_gpr.launch_counts().items() if v}
    print(f"numerical_stability_check on the card: {len(cases)} cases in "
          f"{time.perf_counter() - t0:.2f} s, launches {got}")
    require(got.get("nlml_vg", 0) > 0 and got.get("posterior_predict", 0) > 0,
            f"stability check: vg or predict not launched: {got}")
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    f64 = {c["jitter"]: c for c in cases if c["dtype"] == "float64"}
    for c in cases:
        if c["dtype"] != "float32" or c["jitter"] == 0.0:
            continue
        want = f64[c["jitter"]]
        rtol, atol = PRED_TOL["f*"]
        err = np.abs(c["preds"]["f*"] - want["preds"]["f*"])
        print(f"  jitter {c['jitter']:.0e}: f32 NLML {c['nlml']:.5f}, f64 "
              f"{want['nlml']:.5f}; f* max_abs_err {err.max():.3e} (rtol "
              f"{rtol}, atol {atol})")
        require(c["finite"] and bool(np.all(
            err <= atol + rtol * np.abs(want["preds"]["f*"]))),
            f"stability f32 f* at jitter {c['jitter']} off the f64 case")
    print(f"phase 11 (drivers): {time.perf_counter() - t_phase:.1f} s, "
          f"launches {launches}")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from gpsat_tpu_torch.ops import _build, cuda_gpr
    from gpsat_tpu_torch.parallel.scheduler import (auto_batch_size,
                                                    bucket_level)
    from gpsat_tpu_torch.profile_sweep import (_bench_common,
                                               bench_gpr_engine,
                                               bench_sgpr_engine, sgpr_slots,
                                               workload)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    path, secs, log = _build.build(force=True)
    print(f"build: {path} in {secs:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())

    slots = min(E_MAIN, auto_batch_size(N, P, device=torch.device("cuda")))
    widths = {"vg": slots, "value": E_MAIN,
              "predict": min(1024, bucket_level(E_MAIN))}
    rows = phase_kernels(cuda_gpr, workload, widths)
    sgpr_engine = bench_sgpr_engine(D, M_SGPR)
    s_slots = sgpr_slots(E_SGPR, N_SGPR, M_SGPR)
    X0 = np.zeros((E_SGPR, N_SGPR, D))
    s_widths = {"pool": s_slots,
                "fill": sgpr_engine._fill_chunk_width(E_SGPR, X0, None,
                                                      s_slots, True)}
    rows.update(phase_sgpr_kernels(workload, sgpr_engine, s_widths))
    launches = phase_main(cuda_gpr, workload, bench_gpr_engine, slots)
    s_launches = phase_sgpr_main(cuda_gpr, workload, bench_sgpr_engine,
                                 s_slots)
    launches["cholinv"] = s_launches["hybrid"]["cholinv"]
    launches["sgpr_stream1"] = s_launches["stream"]["sgpr_stream1"]
    launches["sgpr_stream2"] = s_launches["stream"]["sgpr_stream2"]
    launches["sgpr_vg_mega"] = s_launches["mega"]["sgpr_vg_mega"]
    phase_models(workload, _bench_common(D))
    gpr_pipe, sgpr_pipe, arctic, fitted, rmse_fit = phase_pipeline(cuda_gpr)
    smoothed_pipe, smoothed = phase_smoothed(cuda_gpr, arctic, fitted,
                                             rmse_fit)
    cuda_gpr.reset_launch_counts()
    phase_families(arctic)
    phase_kiss_multioutput(arctic)
    launched = {k: v for k, v in cuda_gpr.launch_counts().items() if v}
    require(not launched, f"phases 8-9 launched kernels: {launched}")
    mesh_pipe = phase_mesh(cuda_gpr, arctic, fitted, sgpr_pipe, smoothed,
                           workload, bench_gpr_engine)
    drivers = phase_drivers(cuda_gpr)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: no output")

    kernels = []
    for name, key, src, replaces in (
            ("nlml_vg", "vg", "gpsat_tpu_torch/csrc/gp_vg.cu",
             "gpsat_tpu/ops/pallas_gpr.py:602"),
            ("posterior_predict", "predict",
             "gpsat_tpu_torch/csrc/gp_predict.cu",
             "gpsat_tpu/ops/pallas_gpr.py:952"),
            ("nlml_value", "value", "gpsat_tpu_torch/csrc/gp_value.cu",
             "gpsat_tpu/ops/pallas_gpr.py:348"),
            ("cholinv", "cholinv", "gpsat_tpu_torch/csrc/gp_cholinv.cu",
             "gpsat_tpu/ops/pallas_cholinv.py:86"),
            ("sgpr_stream1", "sgpr_stream1",
             "gpsat_tpu_torch/csrc/gp_sgpr_stream.cu",
             "gpsat_tpu/ops/pallas_sgpr.py:636"),
            ("sgpr_stream2", "sgpr_stream2",
             "gpsat_tpu_torch/csrc/gp_sgpr_stream.cu",
             "gpsat_tpu/ops/pallas_sgpr.py:688"),
            ("sgpr_vg_mega", "sgpr_vg_mega",
             "gpsat_tpu_torch/csrc/gp_sgpr_vg.cu",
             "gpsat_tpu/ops/pallas_sgpr.py:880")):
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": launches[name], **rows[key],
               "pipeline_launches": gpr_pipe.get(name, 0),
               "pipeline_sgpr_launches": sgpr_pipe["launches"].get(name, 0),
               "pipeline_smoothed_launches": smoothed_pipe.get(name, 0),
               "pipeline_mesh_launches": mesh_pipe.get(name, 0),
               "drivers_launches": drivers.get(name, 0)}
        for field in ("launches", "max_abs_err", "ms", "plain_ms",
                      "bound_ms", "bound_by"):
            require(row.get(field) is not None, f"{name}: no {field}")
        require("library_ms" in row, f"{name}: no library_ms")
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
