"""gpsat_tpu_torch — the local-expert GP engine in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``gpsat_tpu`` (JAX + Pallas on TPU), which stays beside it as the
reference. This package imports torch, numpy and scipy only; it never imports
jax or any ``gpsat_tpu`` module, and keeps its own copies of what it needs.

Layout
------
- ``gpsat_tpu_torch.ops``      : masked GP math (kernels, exact GPR), bijectors,
                                 packing, batched L-BFGS, and the CUDA kernel
                                 wrappers (``ops/cuda_gpr.py``, sources in
                                 ``csrc/``).
- ``gpsat_tpu_torch.models``   : ``BatchedGPR``, the exact-GPR sweep engine.
- ``gpsat_tpu_torch.parallel`` : expert bucketing and batch sizing.
- ``gpsat_tpu_torch.weights``  : carry parameters and optimiser states over
                                 from the JAX package as numpy arrays.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit CPU device they raise instead of running quietly on
the host. The working dtype defaults to float32 on the card and float64 on
the CPU (as ``gpsat_tpu`` picks f32 on an accelerator and f64 on the host).
"""

import os

import torch

__version__ = "0.1.0"

_PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
_PARENT_DIR = os.path.dirname(_PACKAGE_DIR)


def get_path(*sub_dir):
    """Path inside the package directory."""
    return os.path.join(_PACKAGE_DIR, *sub_dir)


def get_parent_path(*sub_dir):
    """Path inside the repository root."""
    return os.path.join(_PARENT_DIR, *sub_dir)


def resolve_device(device=None):
    """torch.device for an entry point: ``cuda`` unless the caller asks for
    something else. Raises when ``cuda`` is asked for (explicitly or by
    default) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gpsat_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the host")
    return dev


def default_dtype(device):
    """float32 on the card, float64 on the host."""
    return torch.float32 if torch.device(device).type == "cuda" \
        else torch.float64
