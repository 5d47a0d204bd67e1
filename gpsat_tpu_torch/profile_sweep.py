"""Where the time of a sweep goes on a CUDA device.

    python -m gpsat_tpu_torch.profile_sweep [gpr|sgpr|svgp|vff]
                                            [--experts E] [--out FILE]

`gpr` (the default) runs BatchedGPR.fit_predict_many on the bench `gpr`
workload (E=512, N=400, P=400, D=3, Matern32, f32); `sgpr` runs
BatchedSGPR.fit_predict_many on the bench `sgpr` workload (E=128, N=2000,
P=400, D=3, M=500, 48 slots), once per route ("hybrid", "stream", "mega");
`svgp` runs BatchedSVGP on the bench `svgp` workload (E=128, N=1000, P=400,
D=3, M=128, one chunk of 128); `vff` runs BatchedVFF (m=10) and then
BatchedASVGP (m=19, the same 361 features) on the bench `vff` workload
(E=128, N=1000, P=400, D=2, 76 slots).
Each sweep runs three times: a cold run (first use of every kernel), a warm
run timed on the host clock, and a warm run under torch.profiler. Prints one
JSON object
per sweep: wall times, pool iterations and slots, launches of each fused
kernel, peak device memory, the device time of each CUDA kernel by name and
summed per port kernel (`port_kernels_ms`: cholinv, stream1, stream2 and
nlml_vg enqueue several) and, for route mega, per phase of its own kernels
(`gv_ms`: the four P6 products, P5, the rest), and the device's busy share
of the profiled wall time. Needs a CUDA device; numbers are this run's.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from gpsat_tpu_torch.device_profile import (base_name, by_gv_group,
                                           device_times)
from gpsat_tpu_torch.models.batched import (BatchedASVGP, BatchedGPR,
                                            BatchedSGPR, BatchedSVGP,
                                            BatchedVFF)
from gpsat_tpu_torch.ops import cuda_gpr, cuda_sgpr
from gpsat_tpu_torch.parallel.scheduler import auto_batch_size


def workload(E, N, P, D=3, seed=0):
    """bench.make_workload's recipe, de-meaned."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-4.0, 4.0, (E, N, D))
    if D > 2:
        X[..., 2] = 0.0
    z = (0.4 * np.sin(X[..., 0] * 0.8) + 0.3 * np.cos(X[..., 1] * 0.6)
         + 0.05 * rng.standard_normal((E, N)))
    Xs = rng.uniform(-4.0, 4.0, (E, P, D))
    if D > 2:
        Xs[..., 2] = 0.0
    return X, z - z.mean(axis=1, keepdims=True), np.ones((E, N), bool), Xs


def _bench_common(D):
    """The engine configuration shared by bench.py's modes (bench.py:501-506)."""
    return dict(
        coords_dim=D, kernel="Matern32",
        constraints={"lengthscales": {"low": [0.01] * D, "high": [50.0] * D},
                     "likelihood_variance": {"low": 1e-5, "high": 1.0}},
        optim_kwargs={"max_iter": 250, "gtol": 1e-5, "ftol": 1e-9},
        jitter=1e-6)


def bench_gpr_engine(D=3, **kw):
    """BatchedGPR with the bench `gpr` configuration."""
    return BatchedGPR(**_bench_common(D), **kw)


def bench_sgpr_engine(D=3, M=500, **kw):
    """BatchedSGPR with the bench `sgpr` configuration (bench.py:507-508)."""
    return BatchedSGPR(num_inducing_points=M, **_bench_common(D), **kw)


def sgpr_slots(E, N, M):
    """Pool width of the bench `sgpr` mode (bench.py:536-538): a budget of
    3 * 2**24 elements for the dominant [B, M, N] buffers, rounded down to a
    multiple of 16 (48 at N=2000, M=500). The bench `svgp` mode takes the
    same rule (bench.py:525-530): 128 at N=1000, M=128, one chunk of the
    bench's 128 experts."""
    B = min(E, max(1, (3 * 2**24) // (M * N)))
    return B - B % 16 if B >= 16 else B


def vff_slots(E, N, m, D):
    """Pool width of the bench `vff` mode (bench.py:539-541): a budget of
    2**25 elements for [B, M, N] with M reckoned as (2m + 1)**D (441 at m=10,
    D=2, where the model has (2m - 1)**D = 361 features): 76 at N=1000."""
    return min(E, max(1, 2**25 // max((2 * m + 1) ** D * N, 1)))


def bench_svgp_engine(D=3, M=128, **kw):
    """BatchedSVGP with the bench `svgp` configuration (bench.py:485-487,
    :509-511): Adam lr 5e-2, at most 1000 steps, M seeded inducing points."""
    common = _bench_common(D)
    common["optim_kwargs"] = {"max_iter": 1000, "learning_rate": 5e-2}
    return BatchedSVGP(num_inducing_points=M, **common, **kw)


def bench_vff_engine(D=2, m=10, engine=None, **kw):
    """BatchedVFF with the bench `vff` configuration (bench.py:488-490,
    :512-514): m features per dimension, lengthscales bounded below by 0.05.
    `engine=BatchedASVGP` gives the ASVGP engine on the same configuration
    (m then counts B-splines per dimension)."""
    common = _bench_common(D)
    common["constraints"]["lengthscales"]["low"] = [0.05] * D
    return (engine or BatchedVFF)(num_inducing_features=[m] * D, **common,
                                  **kw)


# The CUDA kernels of each port kernel (a launch entry may enqueue several),
# by the prefix of their names. The exact-GPR kernels factor on cholinv's
# kernels (gp_cholinv_*), so in the gpr sweep the cholinv family is vg's
# factor and the fill's (posterior_predict's) factor; gp_gpr_scale_kernel,
# their scale pass, is in no family.
_FAMILIES = {"nlml_vg": "gp_vg_", "posterior_predict": "gp_predict_",
             "nlml_value": "gp_value_", "cholinv": "gp_cholinv_",
             "sgpr_stream1": "gp_sgpr_stream1_",
             "sgpr_stream2": "gp_sgpr_stream2_", "sgpr_vg_mega": "gv_"}


def _by_family(kernels):
    """{port kernel: {"ms", "calls"}} summed over the CUDA kernels whose
    names carry its prefix."""
    out = {}
    for key, (us, calls) in kernels.items():
        name = base_name(key)
        for fam, prefix in _FAMILIES.items():
            if name.startswith(prefix):
                ms, n = out.get(fam, (0.0, 0))
                out[fam] = (ms + us * 1e-3, n + calls)
    return {fam: {"ms": ms, "calls": n} for fam, (ms, n) in out.items()}


def profile(engine, E, N, P, D, slots):
    """Cold, warm and profiled sweeps of `engine` on the bench workload."""
    X, y, mask, Xs = workload(E, N, P, D)

    def sweep():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.fit_predict_many(X, y, mask, Xs=Xs, slots=slots)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    _, cold = sweep()
    cuda_gpr.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    out, warm = sweep()
    launches = {k: v for k, v in cuda_gpr.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, profiled = sweep()
    kernels = device_times(prof)
    busy_us = sum(us for us, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    pool_iters = getattr(engine, "_last_pool_iterations", 0)
    return {
        "card": smi, "model": engine.model_name,
        "route": getattr(engine, "route", None),
        "experts": E, "N": N, "P": P, "D": D,
        "slots": slots, "pool_iters": pool_iters,
        "converged": float(np.mean(out["converged"])),
        "wall_cold_s": cold, "wall_warm_s": warm, "wall_profiled_s": profiled,
        "experts_per_s_warm": E / warm, "launches": launches,
        "peak_memory_bytes": peak,
        "device_busy_s": busy_us * 1e-6 if busy_us else "not measured",
        "device_busy_share": busy_us * 1e-6 / profiled if busy_us
        else "not measured",
        "host_ms_per_pool_iter": 1e3 * (profiled - busy_us * 1e-6)
        / pool_iters if busy_us and pool_iters else "not measured",
        "cuda_kernel_launches": sum(c for _, c in kernels.values()),
        "top_kernels_ms": {k[:80]: {"ms": us * 1e-3, "calls": c}
                           for k, (us, c) in top},
        "port_kernels_ms": _by_family(kernels),
        "gv_ms": by_gv_group(kernels),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", default="gpr",
                    choices=("gpr", "sgpr", "svgp", "vff"))
    ap.add_argument("--experts", type=int, default=None)
    ap.add_argument("--out", default=None,
                    help="also write the JSON objects to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_sweep: no CUDA device", file=sys.stderr)
        return 1

    results = []
    if args.mode == "gpr":
        E, N, P, D = args.experts or 512, 400, 400, 3
        engine = bench_gpr_engine(D)
        slots = min(E, auto_batch_size(N, P, device=engine.device))
        results.append(profile(engine, E, N, P, D, slots))
    elif args.mode == "sgpr":
        E, N, P, D, M = args.experts or 128, 2000, 400, 3, 500
        for route in cuda_sgpr.ROUTES:
            results.append(profile(bench_sgpr_engine(D, M, route=route), E, N,
                                   P, D, sgpr_slots(E, N, M)))
    elif args.mode == "svgp":
        E, N, P, D, M = args.experts or 128, 1000, 400, 3, 128
        results.append(profile(bench_svgp_engine(D, M), E, N, P, D,
                               sgpr_slots(E, N, M)))
    else:
        E, N, P, D, m = args.experts or 128, 1000, 400, 2, 10
        slots = vff_slots(E, N, m, D)
        results.append(profile(bench_vff_engine(D, m), E, N, P, D, slots))
        results.append(profile(bench_vff_engine(D, 2 * m - 1,
                                                engine=BatchedASVGP),
                               E, N, P, D, slots))
    text = "\n".join(json.dumps(r) for r in results)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
