// Masked-GPR NLML value only, one thread block per expert.
//
// Replaces gpsat_tpu/ops/pallas_gpr.py:_value_kernel (:348), called through
// _nlml_value_call (:454) by nlml_value_batched (:486). Same inputs:
//   xt  [B][8][Np]  coordinates (dims 0..D-1), float mask in row 7
//   yt  [B][Np]     masked observations
//   p   [B][8]      ls_0..ls_{D-1}, sf2 @5, noise (+jitter) @6
//   out [B]         NLML; NaN when the matrix is not positive definite
//   ws  [B][Np][Np] workspace for U (upper tiles)
// Np is a multiple of GP_T; padded rows carry mask 0, factor to the identity
// and add exactly 0 to the log-determinant and to the quadratic form.
//
// Per expert: the factor half of gp_common.cuh (gp_factor_from), no
// W = U^{-1} recurrence. The observations ride along as in the TPU kernel's
// bordered Cholesky: once diagonal tile k is factored, with its inverse W_kk
// still in shared memory, the hook computes
//   z_k = W_kk^T (y_k - sum_{p<k} U_pk^T z_p),
// so z = U^{-T} y and value = 0.5 z^T z + sum log diag U + 0.5 n log 2 pi.
// Bound on an H100: FP32 operations (~N^3 / 3 per expert against ~20 N bytes
// of input); a third of gp_vg.cu's work on the same tile products.
#include "gp_common.cuh"

// gp_factor_from's hook: forward substitution of tile k of z (kept in
// s.alpha; s.t1 holds the right-hand side of the tile).
struct GpForwardSubst {
  const GpShared& s;
  const float* U;
  int ldu;
  __device__ void operator()(int k) const {
    const int tid = threadIdx.x, c = tid & 31, part = tid >> 5;
    const int kT = k * GP_T;
    float a = 0.f;
    for (int q = part; q < kT; q += GP_THREADS / 32)
      a += U[(size_t)q * ldu + kT + c] * s.alpha[q];
    s.red[part * GP_TS + c] = a;
    __syncthreads();
    if (tid < GP_T) {
      float t = s.y[kT + c];
      for (int w = 0; w < GP_THREADS / 32; ++w) t -= s.red[w * GP_TS + c];
      s.t1[kT + c] = t;
      __syncwarp();
      float z = 0.f;
      for (int q = 0; q <= c; ++q) z += s.Wt[q * GP_TS + c] * s.t1[kT + q];
      s.alpha[kT + c] = z;
    }
  }
};

template <int KID>
__global__ void __launch_bounds__(GP_THREADS)
gp_value_kernel(const float* __restrict__ xt, const float* __restrict__ yt,
                const float* __restrict__ p, float* __restrict__ out,
                float* ws, int Np, int D) {
  extern __shared__ float sm[];
  const int e = blockIdx.x;
  const float* pe = p + (size_t)e * 8;
  float* U = ws + (size_t)e * Np * Np;
  GpShared s = gp_carve(sm, D, Np);
  gp_stage(s, xt + (size_t)e * 8 * Np, yt + (size_t)e * Np, pe, D, Np);

  const GpKernelSource<KID> src{s, D, Np, pe[5], pe[6]};
  gp_factor_from(src, s, U, Np, Np, GpForwardSubst{s, U, Np});

  float quad = 0.f, nvalid = 0.f;
  for (int i = threadIdx.x; i < Np; i += GP_THREADS) {
    quad += s.alpha[i] * s.alpha[i];
    nvalid += s.m[i];
  }
  quad = gp_block_sum(quad, s.red);
  nvalid = gp_block_sum(nvalid, s.red);
  if (threadIdx.x == 0)
    out[e] = 0.5f * quad + s.scal[0] + 0.5f * nvalid * 1.8378770664093453f;
}

extern "C" int gp_value_launch(const float* xt, const float* yt,
                               const float* p, float* out, float* ws, int B,
                               int Np, int D, int kernel_id, void* stream) {
  const size_t smem = sizeof(float) * gp_smem_floats(D, Np, 0);
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(B);
  int code;
  GP_DISPATCH(gp_value_kernel, xt, yt, p, out, ws, Np, D)
  return code;
}
