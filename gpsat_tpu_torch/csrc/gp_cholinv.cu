// Batched Cholesky + full triangular inverse of masked SPD matrices, one
// thread block per matrix.
//
// Replaces gpsat_tpu/ops/pallas_cholinv.py:_cholinv_kernel (:86), called
// through _cholinv_call (:162) by cholinv_batched (:189):
//   A  [B][M][M]  masked SPD input (padded rows/columns zero, unit diagonal);
//                 read only, never written
//   W  [B][M][M]  U^{-1}, upper triangular with exact zeros below the
//                 diagonal (A = U^T U)
//   ld [B]        sum log diag U = 0.5 log det A; NaN or -inf when a pivot is
//                 not positive, for that matrix only
//   ws [B][M][M]  workspace for U (upper tiles)
// M is a multiple of GP_T.
//
// The factorisation and the W recurrence are gp_factor_invert_from
// (gp_common.cuh) with the tiles of A read from device memory instead of
// rebuilt from coordinates.
// Bound on an H100: FP32 operations (2 M^3 / 3 per matrix against 8 M^2 bytes).
// One block walks its M/32 tile columns in series, so a batch of a few dozen
// matrices leaves most SMs idle and the kernel sits far from that bound.
#include "gp_common.cuh"

__global__ void __launch_bounds__(GP_THREADS)
gp_cholinv_kernel(const float* A, float* W, float* ld, float* ws, int M) {
  extern __shared__ float sm[];
  const int e = blockIdx.x;
  const size_t off = (size_t)e * M * M;
  GpShared s = gp_carve(sm, 0, 0);
  float* We = W + off;

  // exact zeros in the tiles below the diagonal, which the recurrence never
  // writes (consumers contract full rows of W)
  const int nb = M / GP_T;
  for (int i = 1; i < nb; ++i)
    for (int e2 = threadIdx.x; e2 < GP_T * i * GP_T; e2 += GP_THREADS) {
      const int r = e2 / (i * GP_T), c = e2 % (i * GP_T);
      We[(size_t)(i * GP_T + r) * M + c] = 0.f;
    }
  if (threadIdx.x == 0) s.scal[0] = 0.f;
  __syncthreads();

  const GpMatrixSource src{A + off, M};
  const float logdet = gp_factor_invert_from(src, s, ws + off, M, We, M, M);
  if (threadIdx.x == 0) ld[e] = logdet;
}

extern "C" int gp_cholinv_launch(const float* A, float* W, float* ld,
                                 float* ws, int B, int M, void* stream) {
  const size_t smem = sizeof(float) * gp_smem_floats(0, 0, 0);
  return gp_launch(gp_cholinv_kernel, B, smem, (cudaStream_t)stream, A, W, ld,
                   ws, M);
}
