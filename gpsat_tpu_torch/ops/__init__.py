"""Batched, masked GP math in PyTorch: kernels, bijectors, packing, exact GPR,
batched L-BFGS, and the wrappers of the hand-written CUDA kernels
(``cuda_gpr``; built on first use, never at import)."""
