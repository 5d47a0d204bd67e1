"""gpsat_tpu_torch — the local-expert GP engine in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``gpsat_tpu`` (JAX + Pallas on TPU), which stays beside it as the
reference. This package imports torch, numpy and scipy only; it never imports
jax or any ``gpsat_tpu`` module, and keeps its own copies of what it needs.

Layout
------
- ``gpsat_tpu_torch.ops``      : masked GP math (kernels, exact GPR, SGPR,
                                 SVGP, VFF, ASVGP, dense and structured
                                 KISS-GP in ``ski.py`` and
                                 ``ski_structured.py``, multi-output GPR and
                                 SVGP in ``multioutput.py``), bijectors,
                                 packing, batched L-BFGS, and the
                                 CUDA kernel wrappers (``ops/cuda_gpr.py``,
                                 ``ops/cuda_cholinv.py``, ``ops/cuda_sgpr.py``;
                                 sources in ``csrc/``).
- ``gpsat_tpu_torch.models``   : the sweep engines ``BatchedGPR``,
                                 ``BatchedSGPR``, ``BatchedSVGP``,
                                 ``BatchedVFF`` and ``BatchedASVGP``, and
                                 the per-expert models (``models.get_model``):
                                 ``GPRModel``, ``SGPRModel``, ``SVGPModel``,
                                 ``VFFModel``, ``ASVGPModel``,
                                 ``KISSGPModel`` (``models/kiss_gpr.py``),
                                 ``MultioutputGPRModel`` and
                                 ``MultioutputSVGPModel``
                                 (``models/multioutput.py``).
- ``gpsat_tpu_torch.parallel`` : expert bucketing and batch sizing; the
                                 share-nothing multi-process stripe
                                 (``parallel/multihost.py``).
- ``gpsat_tpu_torch.local_experts`` : the pipeline entry point
                                 ``LocalExpertOI`` (host gather, buckets,
                                 engine, results store) and its device half
                                 ``execute_buckets``, which needs neither
                                 pandas nor h5py.
- ``gpsat_tpu_torch.postprocessing`` : hyperparameter smoothing (f64, on
                                 the card unless told otherwise; its numpy
                                 core ``smooth_field`` needs neither pandas
                                 nor h5py) and prediction gluing.
- ``gpsat_tpu_torch.tracing`` : spans and counters of the host work
                                 (levels, the L-BFGS pool, the fill, the
                                 chunked path, device reads), kept in memory
                                 while a torch profiler runs or ``enable()``
                                 is in force.
- CLIs of run_examples.sh: ``read_and_store`` (step 2), ``bin_data`` (step
                                 4), ``local_expert_oi`` (steps 5 and 6,
                                 ``--device``), ``postprocessing`` (step 6).
- ``gpsat_tpu_torch.examples`` : the application drivers of the JAX
                                 package's ``examples/`` (the production
                                 sea-ice driver, seasonal, cross-validation,
                                 ...) and ``run_examples``, the seven steps
                                 of run_examples.sh.
- host modules (copies of the JAX package's): ``store`` (HDF5 results
                                 store, the same schema), ``dataloader``,
                                 ``dataprepper``, ``prediction_locations``,
                                 ``config_dataclasses``, ``utils``,
                                 ``ncio`` (netCDF without xarray),
                                 ``datetime_utils``, ``satdata``,
                                 ``plot_utils``; ``native``, the C++/OpenMP
                                 host helper built with g++ at first use.
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


def get_data_path(*sub_dir):
    """Path inside <repo>/data."""
    return os.path.join(_PARENT_DIR, "data", *sub_dir)


def get_config_path(*sub_dir):
    """Path inside <repo>/configs."""
    return os.path.join(_PARENT_DIR, "configs", *sub_dir)


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
