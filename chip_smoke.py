#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (gpsat_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. build the CUDA kernels from gpsat_tpu_torch/csrc with nvcc (sm_90a);
  2. hold each kernel against its plain PyTorch version on the card, on the
     bench workload recipe at E=64, N=400, P=400, D=3 (Matern32 and RBF) and
     at the batch widths the main path gives each kernel (Matern32), and time
     both with CUDA events;
  3. drive the main path, BatchedGPR.fit_predict_many, on the bench `gpr`
     workload (E=512, N=400, P=400, D=3, f32), check convergence, finite
     predictions, agreement with an f64 torch.linalg evaluation on a few
     experts, and that both kernels were launched.
The line before the last is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}. Imports nothing of JAX or gpsat_tpu.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

E_MAIN, E_CMP, N, P, D = 512, 64, 400, 400, 3
REPS = 5                    # timed launches per kernel, after one warm-up
# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
_FP32_FLOPS = 67e12
_HBM_BYTES_PER_S = 3.35e12


def vg_flops(N, D):
    """Useful flops of one NLML value+gradient evaluation (bench.py
    analytic_flops, exact-GPR per-eval term)."""
    return N ** 3 + N * N * (3 * D + 12 + 3 * (D + 2))


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


def compare_kernels(cuda_gpr, kernel, inputs):
    """Max abs errors (vg, predict) of each wrapper against its plain
    version; fails beyond the tolerances of tests/test_pallas_gpr.py."""
    params, X, y, m, Xs = inputs
    val, g = cuda_gpr.nlml_vg_batched(params, X, y, m, kernel, 1e-6)
    pval, pg = cuda_gpr.nlml_vg_batched_plain(params, X, y, m, kernel, 1e-6)
    err = check_close(f"vg {kernel} value", val, pval, 2e-5, 1e-3)
    for k in g:
        err = max(err, check_close(f"vg {kernel} d/d{k}", g[k], pg[k], 2e-3,
                                   2e-3))
    pr = cuda_gpr.posterior_predict_batched(params, X, y, m, Xs, kernel, 1e-6)
    ppr = cuda_gpr.posterior_predict_batched_plain(params, X, y, m, Xs,
                                                   kernel, 1e-6)
    perr = max(check_close(f"predict {kernel} {k}", pr[k], ppr[k], 1e-3,
                           1e-4) for k in pr)
    return {"vg": err, "predict": perr}


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
    gives each kernel (vg: the pool's slots; predict: the fill chunk)."""
    errs = {"vg": 0.0, "predict": 0.0}
    for kernel in ("Matern32", "RBF"):
        inputs = kernel_inputs(workload, E_CMP, seed=1)
        err = compare_kernels(cuda_gpr, kernel, inputs)
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
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
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
          f"pool_iters={engine._last_pool_iterations} (JAX engine on TPU "
          f"v5e, 69 slots: 232) converged={conv:.4f} wall={wall:.3f} s "
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
    # parameters, on the first experts
    n = 8
    params = {k: torch.tensor(v[:n], dtype=torch.float64)
              for k, v in out["params"].items()}
    ref = gpr_math.predict(params, torch.tensor(X[:n]), torch.tensor(y[:n]),
                           torch.tensor(mask[:n]), torch.tensor(Xs[:n]),
                           kernel="Matern32")
    err = max(float(np.max(np.abs(out["preds"][k][:n] - ref[k].numpy())))
              for k in ("f*", "f*_var"))
    print(f"main path predictions vs f64 reference ({n} experts): "
          f"max_abs_err {err:.3e}")
    require(err < 1e-2, f"main-path predictions disagree with f64: {err}")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from gpsat_tpu_torch.ops import _build, cuda_gpr
    from gpsat_tpu_torch.parallel.scheduler import (auto_batch_size,
                                                    bucket_level)
    from gpsat_tpu_torch.profile_sweep import bench_gpr_engine, workload

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
    widths = {"vg": slots, "predict": min(1024, bucket_level(E_MAIN))}
    rows = phase_kernels(cuda_gpr, workload, widths)
    launches = phase_main(cuda_gpr, workload, bench_gpr_engine, slots)

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
             "gpsat_tpu/ops/pallas_gpr.py:952")):
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        **rows[key], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
