"""Where do two SGPR routes end on the bench `sgpr` sweep, and how far apart?

    python tools/compare_sgpr_optima.py [ROOT] [--routes hybrid stream]

ROOT (default: this checkout) is a directory holding a `gpsat_tpu_torch`
package. Runs `chip_smoke.py`'s bench `sgpr` sweep (E=128, N=2000, P=400,
D=3, M=500, 48 slots, Matern32, f32 on the card) once per route and, for the
experts whose reported ELBOs differ most between the first two routes, prints
each route's hyperparameters, iterations and ELBO, the f32 value of every
route at every route's optimum, the f32 ELBO of `ops/sgpr.elbo` there
(torch.linalg factorisations, no kernel of the port) and the f64 one (the
same function on the CPU). That tells an optimum that is really worse (f64
ELBO lower) from an f32 evaluation that is off at the point where the sweep
stopped. The hybrid route's f32 value is also taken with cholinv's plain
version (torch.linalg Cholesky and a triangular solve against I) and, with
`--other-lib`, with the cholinv kernel of another build of the kernels
(`libgpkernels.so`, same `gp_cholinv_launch` signature), to tell which
factorisation the f32 value depends on. Prints one JSON line per expert;
needs a CUDA device.
"""

import argparse
import json
import os
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    ap.add_argument("--routes", nargs="+", default=["hybrid", "stream"])
    ap.add_argument("--worst", type=int, default=4)
    ap.add_argument("--other-lib", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("compare_sgpr_optima: no CUDA device", file=sys.stderr)
        return 1
    import ctypes
    from gpsat_tpu_torch.ops import cuda_cholinv, cuda_sgpr
    from gpsat_tpu_torch.ops import sgpr as sgpr_math
    from gpsat_tpu_torch.profile_sweep import (bench_sgpr_engine, sgpr_slots,
                                               workload)

    torch.backends.cuda.matmul.allow_tf32 = False
    E, N, P, D, M = 128, 2000, 400, 3, 500
    X, y, mask, Xs = workload(E, N, P, D)
    slots = sgpr_slots(E, N, M)
    outs = {}
    for route in args.routes:
        engine = bench_sgpr_engine(D, M, route=route)
        outs[route] = engine.fit_predict_many(X, y, mask, Xs=Xs, slots=slots)
        iters = getattr(engine, "_last_pool_iterations", None)
        print(json.dumps({"route": route, "pool_iters": iters,
                          "converged": float(np.mean(
                              outs[route]["converged"]))}))
    names = engine.HYPER_NAMES
    cholinvs = {"plain": cuda_cholinv.cholinv_batched_plain}
    if args.other_lib:
        other = ctypes.CDLL(args.other_lib)
        other.gp_cholinv_launch.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 2 + [ctypes.c_void_p]

        def other_cholinv(A):
            A = A.contiguous()
            W, ws = torch.empty_like(A), torch.empty_like(A)
            ld = torch.empty(A.shape[0], dtype=A.dtype, device=A.device)
            code = other.gp_cholinv_launch(
                A.data_ptr(), W.data_ptr(), ld.data_ptr(), ws.data_ptr(),
                A.shape[0], A.shape[1],
                torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"other gp_cholinv_launch: error {code}")
            return W, ld
        cholinvs["other_lib"] = other_cholinv
    a, b = (outs[r]["objective"] for r in args.routes[:2])
    order = np.argsort(-np.abs(a - b))[:args.worst]
    for e in order.tolist():
        row = {"expert": e, "root": os.path.abspath(args.root)}
        for at in args.routes:
            o = outs[at]
            prm = {k: o["params"][k][e:e + 1] for k in names}
            Z = o["params"]["inducing_points"][e:e + 1]
            zm = o["inducing_mask"][e:e + 1]
            def f32_value(route):
                val, _ = cuda_sgpr.sgpr_vg_batched(
                    {k: torch.tensor(v, dtype=torch.float32, device="cuda")
                     for k, v in prm.items()},
                    *(torch.tensor(v, dtype=torch.float32, device="cuda")
                      for v in (X[e:e + 1], y[e:e + 1], mask[e:e + 1], Z,
                                zm)), "Matern32", 1e-6, route=route)
                return -float(val[0])
            f32 = {route: f32_value(route) for route in args.routes}
            hybrid_with = {}
            for name, fn in cholinvs.items():
                kernel = cuda_sgpr.cholinv_batched
                cuda_sgpr.cholinv_batched = fn
                try:
                    hybrid_with[name] = f32_value("hybrid")
                finally:
                    cuda_sgpr.cholinv_batched = kernel
            f64, f32_linalg = (float(sgpr_math.elbo(
                {k: torch.tensor(v, dtype=dt, device=dev)
                 for k, v in prm.items()},
                *(torch.tensor(v, dtype=dt, device=dev)
                  for v in (X[e:e + 1], y[e:e + 1], mask[e:e + 1], Z, zm)),
                kernel="Matern32", jitter=1e-6)[0])
                for dt, dev in ((torch.float64, "cpu"),
                                (torch.float32, "cuda")))
            row[at] = {
                "elbo_reported": float(o["objective"][e]),
                "iterations": int(np.asarray(o["iterations"])[e]),
                "converged": bool(np.asarray(o["converged"])[e]),
                "params": {k: np.asarray(v).ravel().round(6).tolist()
                           for k, v in prm.items()},
                "elbo_f32_by_route": f32,
                "elbo_f32_hybrid_with_cholinv": hybrid_with,
                "elbo_f32_torch_linalg": f32_linalg, "elbo_f64": f64}
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
