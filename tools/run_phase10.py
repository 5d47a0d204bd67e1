"""Phase 10 of chip_smoke.py (the expert mesh) alone, after the minimum of
phases 1, 6 and 7 that it needs: the kernels' build, phase 6's one-device
GPR and SGPR runs, and the dense smoothing of the five fields.

    python3 tools/run_phase10.py

Run from the repository root on a machine with a CUDA device; prints the
card, the one-device run's levels and phase 10's lines (about 3 minutes on
one H100, the build included).
"""
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import torch

import chip_smoke as cs
from gpsat_tpu_torch.local_experts import make_engine
from gpsat_tpu_torch.models.exact_gpr import GPRModel
from gpsat_tpu_torch.ops import _build, cuda_gpr
from gpsat_tpu_torch.postprocessing import smooth_field
from gpsat_tpu_torch.profile_sweep import bench_gpr_engine, workload

torch.backends.cuda.matmul.allow_tf32 = False
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip())
print(torch.__version__, torch.version.cuda, torch.cuda.device_count())
path, secs, log = _build.build(force=True)
print(f"build {secs:.1f} s")
inp = cs.arctic_inputs()
eng = make_engine(GPRModel, cs.ARCTIC_MODEL["init_params"],
                  cs.ARCTIC_MODEL["constraints"], coords_dim=3)
cuda_gpr.reset_launch_counts()
torch.cuda.synchronize()
t0 = time.perf_counter()
fitted = cs.run_pipeline(eng, inp)
torch.cuda.synchronize()
print(f"one-device GPR execute {time.perf_counter() - t0:.3f} s, launches "
      f"{cuda_gpr.launch_counts()}")
for b in fitted["buckets"]:
    print(f"  level N={b['n_max']}: {b['experts']} experts, "
          f"{b['seconds']:.3f} s, pool iterations {b['pool_iterations']}")
sgpr = cs.phase_pipeline_sgpr(cuda_gpr, inp)
x, y = inp["experts"][:, 0], inp["experts"][:, 1]
smoothed = {}
for name, v in fitted["params"].items():
    cols = v.reshape(len(x), -1)
    hi = cs.SMOOTHING["max"].get(name)
    smoothed[name] = np.stack(
        [smooth_field(x, y, cols[:, j], cs.SMOOTHING["l_x"],
                      cs.SMOOTHING["l_y"], max=hi, device="cuda")
         for j in range(cols.shape[1])], 1).reshape(v.shape)
t0 = time.perf_counter()
launches = cs.phase_mesh(cuda_gpr, inp, fitted, sgpr, smoothed, workload,
                         bench_gpr_engine)
print(f"phase 10 {time.perf_counter() - t0:.1f} s, launches {launches}")
