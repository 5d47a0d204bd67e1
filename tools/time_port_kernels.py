#!/usr/bin/env python3
"""Time the CUDA kernels of one checkout of gpsat_tpu_torch on the card.

    python tools/time_port_kernels.py [ROOT]

ROOT (default: this checkout) is a directory holding a `gpsat_tpu_torch`
package; its kernels are built there and timed at the widths the bench
sweeps give them (vg: 345 experts, predict and value: 512, N=400, P=400;
cholinv, stream1, stream2, sgpr_vg_mega: 48 experts, N=2000, M=500 padded
to 512, and cholinv at the fill's 128 as well; cholinv_vg: cholinv alone on
vg's 345 kernel matrices, N=400 padded to 448; cholinv_factor: the
exact-GPR factor alone, with no W = U^{-1} and no border, on 512 kernel
matrices rebuilt from the coordinates (gp_cholinv_kernel_launch, where the
checkout has it); Matern32, D=3, fixed random hyperparameters), by CUDA
events over 20 warm launches. Prints one JSON line
with the card's name and power limit. To compare two commits, unpack each
with `git archive` and run this script on both in one job, in the order
parent, change, change, parent: two jobs may land on two cards.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

REPS = 20


def cuda_ms(fn):
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


def factor_alone(lib, xt, p, kernel_id, D):
    """A launcher of gp_cholinv_kernel_launch with W and the border skipped
    on the packed inputs, N padded to the factor's 64-wide tile."""
    from gpsat_tpu_torch.ops import _build
    E, _, Nx = xt.shape
    M = -(-Nx // 64) * 64
    xs = torch.zeros(E, 8, M, device="cuda")
    xs[:, :D, :Nx] = xt[:, :D] / p[:, :D, None]
    xs[:, 7, :Nx] = xt[:, 7]
    ws = torch.empty(E, M, M, device="cuda")
    ld = torch.empty(E, device="cuda")

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib, lib.gp_cholinv_kernel_launch(
            xs.data_ptr(), None, p.data_ptr(), None, ld.data_ptr(),
            ws.data_ptr(), None, None, E, M, 0, D, kernel_id, stream),
            "gp_cholinv_kernel_launch")
    return run


def main():
    if not torch.cuda.is_available():
        print("time_port_kernels: no CUDA device", file=sys.stderr)
        return 1
    from gpsat_tpu_torch.ops import _build, cuda_cholinv, cuda_gpr, cuda_sgpr
    from gpsat_tpu_torch.profile_sweep import bench_sgpr_engine, workload
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(force=True)
    rng = np.random.default_rng(4)
    kernel, D = "Matern32", 3

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device="cuda")

    def hyper(E):
        return {"lengthscales": t(rng.uniform(0.5, 2.0, (E, D))),
                "kernel_variance": t(rng.uniform(0.05, 0.5, E)),
                "likelihood_variance": t(rng.uniform(0.01, 0.1, E))}

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    out = {"tree": ROOT, "card": smi[0] if smi else
           torch.cuda.get_device_name(0)}
    for name, E in (("vg", 345), ("predict", 512), ("value", 512)):
        X, y, mask, Xs = workload(E, 400, 400, D, seed=3)
        xt, yt, p, _, _ = cuda_gpr._pack(hyper(E), t(X), t(y),
                                         t(mask.astype(np.float32)), 1e-6)
        xs = cuda_gpr._pack_xs(t(Xs))
        if name == "vg":
            out[name] = cuda_ms(
                lambda: cuda_gpr._vg_launch(xt, yt, p, kernel, D))
            # the factor under vg's many-blocks design, at its padding
            xt64 = torch.zeros(E, 8, 448, device="cuda")
            xt64[:, :, :xt.shape[2]] = xt
            A = cuda_gpr._masked_matrix(xt64, p, kernel, D)[0].contiguous()
            out["cholinv_vg"] = cuda_ms(
                lambda: cuda_cholinv._cholinv_launch(A))
        elif name == "value":
            out[name] = cuda_ms(
                lambda: cuda_gpr._value_launch(xt, yt, p, kernel, D))
            if "gp_cholinv_kernel_launch" in _build._SIGNATURES:
                out["cholinv_factor"] = cuda_ms(factor_alone(
                    _build.load_library(), xt, p,
                    cuda_gpr._KERNEL_IDS[kernel], D))
        else:
            out[name] = cuda_ms(
                lambda: cuda_gpr._predict_launch(xt, yt, p, xs, kernel, D))

    for B in (48, 128):
        X, y, mask, _ = workload(B, 2000, 1, D, seed=3)
        Z, zmask = bench_sgpr_engine(D, 500)._build_inducing(X, mask)
        Xp, Zp, m, zm, ls, _, sf2, s2, ybar = cuda_sgpr._prepare(
            hyper(B), t(X), t(y), t(mask), t(Z), t(zmask))
        Kuu = cuda_sgpr._kuu(Zp / ls[:, None, :], zm, sf2, kernel, 1e-6)[0]
        xt, yt, zt, p = cuda_sgpr._pack_stream(Xp, m, ybar, Zp, zm, ls, sf2,
                                               s2)
        W_u, _ = cuda_cholinv.cholinv_batched(Kuu)
        Bsum, at, _ = cuda_sgpr.sgpr_stream1(xt, yt, zt, p, W_u, kernel, D)
        Bm = Bsum + torch.eye(Bsum.shape[1], device="cuda")
        if B == 128:   # the fill's width: cholinv only
            out["cholinv_128"] = cuda_ms(
                lambda: cuda_cholinv.cholinv_batched(Bm))
            continue
        W_B, _ = cuda_cholinv.cholinv_batched(Bm)
        c = (at[:, None, :] @ W_B)[:, 0, :]
        dd = (W_B @ c[:, :, None])[:, :, 0].contiguous()
        Pm = (W_B @ (W_B.mT @ Bsum)).contiguous()
        out["cholinv"] = cuda_ms(lambda: cuda_cholinv.cholinv_batched(Bm))
        out["sgpr_stream1"] = cuda_ms(
            lambda: cuda_sgpr.sgpr_stream1(xt, yt, zt, p, W_u, kernel, D))
        out["sgpr_stream2"] = cuda_ms(
            lambda: cuda_sgpr.sgpr_stream2(xt, yt, zt, p, W_u, Pm, dd, kernel,
                                           D))
        out["sgpr_vg_mega"] = cuda_ms(
            lambda: cuda_sgpr.sgpr_vg_mega(xt, yt, zt, p, kernel, D, 1e-6))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
