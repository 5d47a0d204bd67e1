"""Where the time of the exact-GPR sweep goes on a CUDA device.

    python -m gpsat_tpu_torch.profile_sweep [--experts 512] [--out FILE]

Runs BatchedGPR.fit_predict_many on the bench `gpr` workload (N=400, P=400,
D=3, Matern32, f32) three times: a cold run (first use of every kernel), a
warm run timed on the host clock, and a warm run under torch.profiler. Prints
one JSON object: wall times, pool iterations and slots, launches of each fused
kernel, the device time of each CUDA kernel by name, and the device's busy
share of the profiled wall time. Needs a CUDA device; numbers are this run's.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from gpsat_tpu_torch.models.batched import BatchedGPR
from gpsat_tpu_torch.ops import cuda_gpr
from gpsat_tpu_torch.parallel.scheduler import auto_batch_size


def workload(E, N, P, D=3, seed=0):
    """bench.make_workload's recipe, de-meaned."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-4.0, 4.0, (E, N, D))
    X[..., 2] = 0.0
    z = (0.4 * np.sin(X[..., 0] * 0.8) + 0.3 * np.cos(X[..., 1] * 0.6)
         + 0.05 * rng.standard_normal((E, N)))
    Xs = rng.uniform(-4.0, 4.0, (E, P, D))
    Xs[..., 2] = 0.0
    return X, z - z.mean(axis=1, keepdims=True), np.ones((E, N), bool), Xs


def bench_gpr_engine(D=3, **kw):
    """BatchedGPR with the bench `gpr` configuration (bench.py:501-506)."""
    return BatchedGPR(
        coords_dim=D, kernel="Matern32",
        constraints={"lengthscales": {"low": [0.01] * D, "high": [50.0] * D},
                     "likelihood_variance": {"low": 1e-5, "high": 1.0}},
        optim_kwargs={"max_iter": 250, "gtol": 1e-5, "ftol": 1e-9},
        jitter=1e-6, **kw)


def _device_times(prof):
    """{kernel name: (device microseconds, calls)} of the CUDA kernels."""
    out = {}
    for evt in prof.key_averages():
        us = evt.device_time_total
        if us and evt.device_type == torch.autograd.DeviceType.CUDA:
            out[evt.key] = (float(us), int(evt.count))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--experts", type=int, default=512)
    ap.add_argument("--out", default=None,
                    help="also write the JSON object to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_sweep: no CUDA device", file=sys.stderr)
        return 1

    E, N, P, D = args.experts, 400, 400, 3
    X, y, mask, Xs = workload(E, N, P, D)
    engine = bench_gpr_engine(D)

    def sweep():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.fit_predict_many(X, y, mask, Xs=Xs)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    _, cold = sweep()
    cuda_gpr.reset_launch_counts()
    out, warm = sweep()
    launches = {"nlml_vg": cuda_gpr.nlml_vg_batched.launches,
                "posterior_predict": cuda_gpr.posterior_predict_batched.launches}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, profiled = sweep()
    kernels = _device_times(prof)
    busy_us = sum(us for us, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    pool_iters = engine._last_pool_iterations
    result = {
        "card": smi, "experts": E, "N": N, "P": P, "D": D,
        "slots": min(E, auto_batch_size(N, P, device=engine.device)),
        "pool_iters": pool_iters,
        "converged": float(np.mean(out["converged"])),
        "wall_cold_s": cold, "wall_warm_s": warm, "wall_profiled_s": profiled,
        "experts_per_s_warm": E / warm, "launches": launches,
        "device_busy_s": busy_us * 1e-6 if busy_us else "not measured",
        "device_busy_share": busy_us * 1e-6 / profiled if busy_us
        else "not measured",
        "host_ms_per_pool_iter": 1e3 * (profiled - busy_us * 1e-6)
        / max(pool_iters, 1) if busy_us else "not measured",
        "cuda_kernel_launches": sum(c for _, c in kernels.values()),
        "top_kernels_ms": {k[:80]: {"ms": us * 1e-3, "calls": c}
                           for k, (us, c) in top},
    }
    text = json.dumps(result)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
