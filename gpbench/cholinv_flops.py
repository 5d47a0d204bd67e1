"""Useful float32 operations of one factor-and-invert of the cholinv kernel
(csrc/gp_cholinv.cu through ops/cuda_cholinv.cholinv_batched) at the
matrix's own size M, never the padded size it runs at: the Cholesky factor
A = U^T U, M^3 / 3, and the triangular inverse W = U^{-1}, M^3 / 3; terms of
lower order are left out."""


def factor_and_invert(M):
    return 2.0 * M ** 3 / 3.0
