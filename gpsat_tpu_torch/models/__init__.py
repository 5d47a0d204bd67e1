"""Batched model engines (exact GPR)."""

from gpsat_tpu_torch.models.batched import BatchedGPR  # noqa: F401
