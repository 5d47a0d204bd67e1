"""The published float32 peak of one NVIDIA H100 SXM (NVIDIA's data sheet,
dense, at the full 700 W power limit), and the card's own power limit to
report beside any share of it. The shares are of the flops bound alone:
the kernels of the cells move O(N^2) bytes for O(N^3) operations, and
their bytes over 3.35 TB/s take far less time."""

import subprocess

FP32_FLOPS = 67e12          # float32 outside the tensor cores


def power_limit():
    """The card's name and power limit as nvidia-smi reads them, or None
    where nvidia-smi is absent."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else None
