// Masked-GPR NLML value only, on cholinv's many-blocks factor.
//
// Replaces gpsat_tpu/ops/pallas_gpr.py:_value_kernel (:348), called through
// _nlml_value_call (:454) by nlml_value_batched (:486). Same inputs:
//   xt  [B][8][Nx]  coordinates (dims 0..D-1), float mask in row 7
//   yt  [B][Nx]     masked observations
//   p   [B][8]      ls_0..ls_{D-1}, sf2 @5, noise (+jitter) @6
//   out [B]         NLML; NaN when the matrix is not positive definite
//   ws              scratch of gp_value_ws_floats(B, Nx) floats
// Nx is a multiple of 32; padded columns carry mask 0. The kernels work on
// M = Nx rounded up to GL_T (the tile edge of gp_cholinv.cu), the extra rows
// padded the same way: they factor to the identity and add exactly 0 to the
// log-determinant and to the quadratic form.
//
// Design: the factor half of gp_vg.cu, with no W = U^{-1}. The observations
// ride along as the border of the factor, as in the TPU kernel's bordered
// Cholesky:
//   scale  xs = x / ls, y and the mask, padded to M (gp_gpr_scale_kernel)
//                                                              grid (B)
//   factor gp_cholinv_kernel_launch with y as its border: U, ld = sum log
//          diag U and z = U^{-T} y by cholinv's right-looking schedule on
//          64 x 64 tiles, K rebuilt from xs where step 0 first reads it, z
//          by the diag and panel steps; a pivot that is not positive gives
//          NaN for that expert only                       3 M/64 - 2 grids
//   finish one warp per expert: value = 0.5 z.z + ld + 0.5 n log 2 pi by
//          gp_nlml_warp, the function vg's finish calls on the same factor
//          (same source, same M): the two agree bit for bit
// Fixed-order sums only: a second launch repeats the first bit for bit.
// FP32 FMA on the CUDA cores.
// Bound on an H100: FP32 operations (~N^3 / 3 per expert against ~20 N bytes
// of input). The critical path is cholinv's: M/64 diagonal steps on single
// warps (without W's inverse) and M/64 panel solves.
#include "gp_common.cuh"

#define GL_T 64  // tile edge: CI_T of gp_cholinv.cu

extern "C" int gp_cholinv_kernel_launch(const float* xs, const float* xp,
                                        const float* p, float* W, float* ld,
                                        float* ws, float* Z, float* z, int B,
                                        int M, int Pk, int D, int kernel_id,
                                        void* stream);

static inline int gl_pad(int Nx) { return (Nx + GL_T - 1) / GL_T * GL_T; }

// The scratch layout: offsets in floats, in this order.
struct GpValueWorkspace {
  size_t U;   // [B][M][M] cholinv's ws
  size_t z;   // [2][B][M] z = U^{-T} y, then the panels' residual
  size_t xs;  // [B][8][M] coordinates / lengthscales, y, mask
  size_t ld;  // [B]
  size_t floats;
};

static GpValueWorkspace gl_layout(int B, int Nx) {
  const size_t b = B, m = gl_pad(Nx);
  GpValueWorkspace w;
  size_t q = 0;
  w.U = q; q += b * m * m;
  w.z = q; q += 2 * b * m;
  w.xs = q; q += b * 8 * m;
  w.ld = q; q += b;
  w.floats = q;
  return w;
}

// One warp per expert e: out[e] = gp_nlml_warp of its z.
__global__ void __launch_bounds__(GP_THREADS)
gp_value_finish_kernel(const float* z, const float* xs, const float* ld,
                       float* out, int B, int M) {
  const int e = blockIdx.x * (GP_THREADS / 32) + (threadIdx.x >> 5);
  if (e >= B) return;
  const float v = gp_nlml_warp(z + (size_t)e * M, 1,
                               xs + ((size_t)e * 8 + 7) * M, ld[e], M);
  if ((threadIdx.x & 31) == 0) out[e] = v;
}

extern "C" long long gp_value_ws_floats(int B, int Nx) {
  return (long long)gl_layout(B, Nx).floats;
}

extern "C" int gp_value_launch(const float* xt, const float* yt,
                               const float* p, float* out, float* ws, int B,
                               int Nx, int D, int kernel_id, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const GpValueWorkspace w = gl_layout(B, Nx);
  const int M = gl_pad(Nx);
  float *U = ws + w.U, *z = ws + w.z, *xs = ws + w.xs, *ld = ws + w.ld;
  gp_gpr_scale_kernel<<<B, GP_THREADS, 0, st>>>(xt, yt, p, xs, Nx, M, D);
  int code = (int)cudaGetLastError();
  if (code != 0) return code;
  code = gp_cholinv_kernel_launch(xs, nullptr, p, nullptr, ld, U, nullptr, z,
                                  B, M, 0, D, kernel_id, stream);
  if (code != 0) return code;
  const int warps = GP_THREADS / 32;
  gp_value_finish_kernel<<<(B + warps - 1) / warps, GP_THREADS, 0, st>>>(
      z, xs, ld, out, B, M);
  return (int)cudaGetLastError();
}
