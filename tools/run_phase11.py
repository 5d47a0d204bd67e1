"""Phase 11 of chip_smoke.py (the application drivers on the card) alone,
after the kernels' build (phase 1), which is all it needs.

    python3 tools/run_phase11.py

Run from the repository root on a machine with a CUDA device; prints the
card and phase 11's lines.
"""
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch

import chip_smoke as cs
from gpsat_tpu_torch.ops import _build, cuda_gpr

torch.backends.cuda.matmul.allow_tf32 = False
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip())
print(torch.__version__, torch.version.cuda, torch.cuda.device_count())
path, secs, log = _build.build(force=True)
print(f"build {secs:.1f} s")
t0 = time.perf_counter()
launches = cs.phase_drivers(cuda_gpr)
print(f"phase 11 {time.perf_counter() - t0:.1f} s, launches {launches}")
