#!/usr/bin/env python3
"""Time the CUDA kernels of one checkout of gpsat_tpu_torch on the card.

    python tools/time_port_kernels.py [ROOT] [--gv-shapes BxM,...]

ROOT (default: this checkout) is a directory holding a `gpsat_tpu_torch`
package; its kernels are built there and timed at the widths the bench
sweeps give them (vg: 345 experts, predict and value: 512, N=400, P=400;
cholinv, stream1, stream2, sgpr_vg_mega: 48 experts, N=2000, M=500 padded
to 512, and cholinv at the fill's 128 as well; cholinv_vg: cholinv alone on
vg's 345 kernel matrices, N=400 padded to 448; cholinv_factor: the
exact-GPR factor alone, with no W = U^{-1} and no border, on 512 kernel
matrices rebuilt from the coordinates (gp_cholinv_kernel_launch, where the
checkout has it), and cholinv_factor_library: torch.linalg.cholesky_ex on
the same 512 matrices padded to 448; Matern32, D=3, fixed random
hyperparameters), by CUDA
events over 20 warm launches. sgpr_vg_mega runs at 48 and 128 experts;
beside each, `gv` holds the device time of route mega's own kernels
(csrc/gp_sgpr_vg.cu's gv_*) in one call, by torch.profiler: the four P6
products, the P5 matvecs and scalars, and the rest (Kuu, I + Bsum, the
finish), and `gv_matmul` the same four products as torch.matmul with TF32
off on the same tensors (full products: the library yardstick of the
products). Prints one JSON line with the card's name and power limit. To
compare two commits, unpack each with `git archive` and run this script on
both in one job, in the order parent, change, change, parent: two jobs may
land on two cards.

--gv-shapes gives the (experts, inducing points) shapes of the mega timing
(N=2000; default 48x500,128x500); --gv-only times mega alone.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

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


def own_device_profile():
    """This checkout's gpsat_tpu_torch/device_profile.py, loaded by its path
    (it imports torch alone), so that a ROOT that predates it is timed by
    the same kernel groups."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "gpsat_tpu_torch", "device_profile.py")
    spec = importlib.util.spec_from_file_location("_device_profile", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def gv_matmuls(W_B, Bsum, W_u):
    """The four P6 products of route mega as torch.matmul, full products."""
    def run():
        T1 = W_B.mT @ Bsum
        P = W_B @ T1
        T2 = (Bsum - P) @ W_u.mT
        return W_u @ T2
    return run


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
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?",
                    default=os.path.join(os.path.dirname(__file__), ".."))
    ap.add_argument("--gv-shapes", default="48x500,128x500")
    ap.add_argument("--gv-only", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    gv_shapes = [tuple(int(v) for v in s.split("x"))
                 for s in args.gv_shapes.split(",")]
    if not torch.cuda.is_available():
        print("time_port_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
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
    out = {"tree": root, "card": smi[0] if smi else
           torch.cuda.get_device_name(0)}
    for name, E in () if args.gv_only else (("vg", 345), ("predict", 512),
                                             ("value", 512)):
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
            xt64 = torch.zeros(E, 8, 448, device="cuda")
            xt64[:, :, :xt.shape[2]] = xt
            A = cuda_gpr._masked_matrix(xt64, p, kernel, D)[0].contiguous()
            out["cholinv_factor_library"] = cuda_ms(
                lambda: torch.linalg.cholesky_ex(A))
        else:
            out[name] = cuda_ms(
                lambda: cuda_gpr._predict_launch(xt, yt, p, xs, kernel, D))

    for B in () if args.gv_only else (48, 128):
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

    prof = own_device_profile()
    # gv_small_kernel: P5 of checkouts before the tiled P5, one block an
    # expert
    gv_groups = dict(prof.GV_GROUPS, p5=prof.GV_GROUPS["p5"] +
                     ("gv_small_kernel",))
    for B, M in gv_shapes:
        X, y, mask, _ = workload(B, 2000, 1, D, seed=3)
        Z, zmask = bench_sgpr_engine(D, M)._build_inducing(X, mask)
        Xp, Zp, m, zm, ls, _, sf2, s2, ybar = cuda_sgpr._prepare(
            hyper(B), t(X), t(y), t(mask), t(Z), t(zmask))
        Kuu = cuda_sgpr._kuu(Zp / ls[:, None, :], zm, sf2, kernel, 1e-6)[0]
        xt, yt, zt, p = cuda_sgpr._pack_stream(Xp, m, ybar, Zp, zm, ls, sf2,
                                               s2)
        W_u, _ = cuda_cholinv.cholinv_batched(Kuu)
        Bsum = cuda_sgpr.sgpr_stream1(xt, yt, zt, p, W_u, kernel, D)[0]
        Bm = Bsum + torch.eye(Bsum.shape[1], device="cuda")
        W_B, _ = cuda_cholinv.cholinv_batched(Bm)

        def mega():
            return cuda_sgpr.sgpr_vg_mega(xt, yt, zt, p, kernel, D, 1e-6)
        key = ("sgpr_vg_mega" if (B, M) == (48, 500) else
               f"sgpr_vg_mega_{B}x{Zp.shape[1]}")
        out[key] = cuda_ms(mega)
        out[key + "_gv"] = prof.gv_share_ms(mega, REPS, gv_groups)
        out[key + "_gv_matmul"] = cuda_ms(gv_matmuls(W_B, Bsum, W_u))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
