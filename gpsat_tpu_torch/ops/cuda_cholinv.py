"""Batched Cholesky + full triangular inverse for Hopper (torch counterpart
of gpsat_tpu/ops/pallas_cholinv.py).

``csrc/gp_cholinv.cu`` replaces ``pallas_cholinv._cholinv_kernel``: a
right-looking blocked factorisation on 64 x 64 tiles and the W = U^{-1}
recurrence by tile offset, a fixed sequence of launches with many blocks per
matrix (4 M/64 - 3 launches per call, counted here as one).

    W  [B, M, M]  U^{-1} (upper triangular, exact zeros below; A = U^T U)
    ld [B]        sum(log diag U) = 0.5 * logdet A

The input must be a *masked* SPD matrix: padded rows/columns zeroed with a
unit diagonal (they factor to identity and contribute log 1 = 0). A matrix
that is not positive definite gives a non-finite ``ld`` for that matrix only.

On a CUDA tensor ``cholinv_batched`` launches the kernel or raises (M must be
inside the gate ``cholinv_supported``: a multiple of 128, at most 1024); on a
CPU tensor it runs ``cholinv_batched_plain``. ``cholinv_batched.launches``
counts the launches; each call, on either path, adds its B matrices to the
recorder's ``cholinv_mats`` count (``gpsat_tpu_torch.tracing``).
"""

import torch

from gpsat_tpu_torch import tracing
from gpsat_tpu_torch.ops import _build
from gpsat_tpu_torch.ops.cuda_gpr import _GATE_PAD, _check_cuda

__all__ = ["cholinv_supported", "cholinv_batched", "cholinv_batched_plain"]


def cholinv_supported(M=None):
    """Can the fused kernel factor [.., M, M] matrices?"""
    return M is None or (M % _GATE_PAD == 0 and M <= 1024)


def cholinv_batched_plain(A):
    """(W, ld) with torch.linalg on any device: Cholesky, then a triangular
    solve against I. A failed factorisation gives NaN for that matrix."""
    A = A.to(torch.float32)
    B, M, _ = A.shape
    L, info = torch.linalg.cholesky_ex(A)
    bad = (info != 0) | ~torch.isfinite(A).all(dim=(1, 2))
    L = torch.where(bad[:, None, None], torch.full_like(L, torch.nan), L)
    eye = torch.eye(M, dtype=A.dtype, device=A.device).expand(B, M, M)
    W = torch.linalg.solve_triangular(L.mT, eye, upper=True).triu()
    ld = torch.log(torch.diagonal(L, dim1=1, dim2=2)).sum(dim=1)
    return W, ld


def _cholinv_launch(A):
    """Launch csrc/gp_cholinv.cu on a contiguous f32 CUDA [B, M, M] tensor."""
    _check_cuda(A)
    B, M, _ = A.shape
    W = torch.empty_like(A)
    ld = torch.empty(B, dtype=torch.float32, device=A.device)
    if B == 0:
        return W, ld
    ws = torch.empty_like(A)  # U's upper tiles and their transposes
    lib = _build.load_library()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        code = lib.gp_cholinv_launch(A.data_ptr(), W.data_ptr(),
                                     ld.data_ptr(), ws.data_ptr(), B, M,
                                     stream)
    _build.check(lib, code, "gp_cholinv_launch")
    cholinv_batched.launches += 1
    return W, ld


def cholinv_batched(A):
    """(W = U^{-1}, sum-log-diag-U) of batched masked SPD matrices
    (A = U^T U, W upper triangular). A: [B, M, M], read and never written;
    the result is f32."""
    B, M, M2 = A.shape
    if M != M2:
        raise ValueError(f"cholinv_batched: A must be [B, M, M], got {A.shape}")
    if A.is_cuda:
        if not cholinv_supported(M):
            raise ValueError(f"cholinv_batched: M={M} is outside the CUDA "
                             "kernel's gate (a multiple of 128, at most 1024)")
        out = _cholinv_launch(A.to(torch.float32).contiguous())
    elif A.device.type == "cpu":
        out = cholinv_batched_plain(A)
    else:
        raise ValueError(f"cholinv_batched: unsupported device {A.device}")
    tracing.count("cholinv_mats", B)
    return out


cholinv_batched.launches = 0
