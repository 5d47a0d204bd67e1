"""The application drivers of the JAX package's ``examples/``, on the port.

One module for each driver, with the same name, command line and functions:

    python -m gpsat_tpu_torch.examples.<driver> [arguments] [--device D]

They import ``gpsat_tpu_torch``, torch, numpy, scipy and pandas, and nothing
of jax, ``gpsat_tpu`` or the top-level ``examples``. pandas, h5py and
matplotlib are imported inside the functions that need them, so that every
module imports on a machine without them. A driver that computes on the
device takes ``--device`` (``device=`` in ``main``): it runs on ``cuda``
unless the caller passes another, and without a card it raises unless given
``cpu``.

The numpy cores of the sea-ice driver (``sea_ice_freeboard_driver``) and the
near-duplicate stress check (``numerical_stability_check``) need neither
pandas nor h5py. ``run_examples`` runs the seven steps of the JAX package's
``run_examples.sh`` through the port.
"""
