// Fused masked-GPR posterior prediction on cholinv's many-blocks factor.
//
// Replaces gpsat_tpu/ops/pallas_gpr.py:_predict_kernel (:952), called through
// _predict_call (:1108) by posterior_predict_batched (:1146). Inputs as
// gp_vg.cu plus
//   xsp  [B][8][Pp]  prediction coordinates (dims 0..D-1)
//   mean [B][Pp]     Ks^T K^{-1} y
//   var  [B][Pp]     sf2 - |U^{-T} Ks|^2 by column (the wrapper clamps at 0)
//   ws               scratch of gp_predict_ws_floats(B, Nx, Pp) floats:
//                    [B][M][M + Pk + 2] floats and the scaled coordinates
// where Ks = sf2 phi(X, Xs) with masked data rows (K* below). Nx and Pp are
// multiples of 32; the kernels work on M = Nx and Pk = Pp rounded up to
// GP_PT (the tile edge of gp_cholinv.cu).
//
// Design: the factor of gp_value.cu with K* riding in its border beside y,
// and no W = U^{-1}:
//   scale  xs = x / ls, y and the mask, padded to M; xp = xsp / ls padded to
//          Pk (gp_gpr_scale_kernel)                       grids (B), (B)
//   factor gp_cholinv_kernel_launch with K* and y as its border: U, z =
//          U^{-T} y (by the diag steps) and Z* = U^{-T} K* by cholinv's
//          right-looking schedule on 64 x 64 tiles, the K* tiles by a
//          left-looking border step a tile row (a full-depth tile product,
//          then the same forward substitution with U_kk as the panels of
//          K), each built from xs and xp where that step reads it (K* is
//          never stored apart from its solve); a pivot that is not positive
//          gives NaN for that expert only                  4 M/64 - 2 grids
//   finish block (c, e) takes 64 columns of Z*: four threads a column over
//          interleaved rows, compensated (Kahan) sums added in order,
//            mean_c = sum_r Z*_rc z_r,  var_c = sf2 - sum_r Z*_rc^2
//          (|z| grows as the noise falls: the terms of the mean cancel, and
//          a plain f32 running sum loses digits the factor kept)
//                                                      grid (Pk/64, B)
// Fixed-order sums only: a second launch repeats the first bit for bit.
// FP32 FMA on the CUDA cores.
// Bound on an H100: FP32 operations (~N^3 / 3 + N^2 P per expert for the
// factor and the border solve against ~20 (N + P) bytes of input). The
// border's products and solves take most of them; the critical path is the
// factor's M/64 diagonal steps and the border's M/64 tile-row steps.
#include "gp_common.cuh"

#define GP_PT 64  // tile edge: CI_T of gp_cholinv.cu

extern "C" int gp_cholinv_kernel_launch(const float* xs, const float* xp,
                                        const float* p, float* W, float* ld,
                                        float* ws, float* Z, float* z, int B,
                                        int M, int Pk, int D, int kernel_id,
                                        void* stream);

static inline int gq_pad(int n) { return (n + GP_PT - 1) / GP_PT * GP_PT; }

// The scratch layout: offsets in floats, in this order.
struct GpPredictWorkspace {
  size_t U;   // [B][M][M] cholinv's ws
  size_t Z;   // [B][M][Pk] the K* border: U^{-T} K*
  size_t z;   // [2][B][M] z = U^{-T} y, then the panels' residual
  size_t xs;  // [B][8][M] coordinates / lengthscales, y, mask
  size_t xp;  // [B][8][Pk] prediction coordinates / lengthscales
  size_t ld;  // [B]
  size_t floats;
};

static GpPredictWorkspace gq_layout(int B, int Nx, int Pp) {
  const size_t b = B, m = gq_pad(Nx), pk = gq_pad(Pp);
  GpPredictWorkspace w;
  size_t q = 0;
  w.U = q; q += b * m * m;
  w.Z = q; q += b * m * pk;
  w.z = q; q += 2 * b * m;
  w.xs = q; q += b * 8 * m;
  w.xp = q; q += b * 8 * pk;
  w.ld = q; q += b;
  w.floats = q;
  return w;
}

// s + v with Kahan's compensation c (fixed order, no reassociation).
static __device__ __forceinline__ void gq_kahan(float& s, float& c, float v) {
  const float y = v - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

// Block (c, e): columns cT .. cT+63 of expert e's solved border Z* [M][Pk]
// and z [M]. Thread (part, j) = (tid / 64, tid % 64) sums rows part,
// part + 4, ... of column cT + j in order, compensated; the four parts are
// added in order. Writes the columns below Pp only.
__global__ void __launch_bounds__(GP_THREADS)
gp_predict_finish_kernel(const float* Z, const float* z, const float* p,
                         float* mean, float* var, int M, int Pk, int Pp) {
  __shared__ float sm[4][GP_PT], sv[4][GP_PT];
  const int e = blockIdx.y, cT = blockIdx.x * GP_PT, tid = threadIdx.x;
  const int j = tid % GP_PT, part = tid / GP_PT;
  const float* Ze = Z + (size_t)e * M * Pk + cT + j;
  const float* ze = z + (size_t)e * M;
  float a = 0.f, ca = 0.f, v = 0.f, cv = 0.f;
  for (int r = part; r < M; r += 4) {
    const float s = Ze[(size_t)r * Pk];
    gq_kahan(a, ca, s * ze[r]);
    gq_kahan(v, cv, s * s);
  }
  sm[part][j] = a;
  sv[part][j] = v;
  __syncthreads();
  const int c = cT + tid;
  if (tid < GP_PT && c < Pp) {
    mean[(size_t)e * Pp + c] = sm[0][tid] + sm[1][tid] + sm[2][tid] +
                               sm[3][tid];
    var[(size_t)e * Pp + c] =
        p[(size_t)e * 8 + 5] - (sv[0][tid] + sv[1][tid] + sv[2][tid] +
                                sv[3][tid]);
  }
}

extern "C" long long gp_predict_ws_floats(int B, int Nx, int Pp) {
  return (long long)gq_layout(B, Nx, Pp).floats;
}

extern "C" int gp_predict_launch(const float* xt, const float* yt,
                                 const float* p, const float* xsp,
                                 float* mean, float* var, float* ws, int B,
                                 int Nx, int Pp, int D, int kernel_id,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const GpPredictWorkspace w = gq_layout(B, Nx, Pp);
  const int M = gq_pad(Nx), Pk = gq_pad(Pp);
  float *U = ws + w.U, *Z = ws + w.Z, *z = ws + w.z, *xs = ws + w.xs,
        *xp = ws + w.xp, *ld = ws + w.ld;
  gp_gpr_scale_kernel<<<B, GP_THREADS, 0, st>>>(xt, yt, p, xs, Nx, M, D);
  gp_gpr_scale_kernel<<<B, GP_THREADS, 0, st>>>(xsp, nullptr, p, xp, Pp, Pk,
                                                D);
  int code = (int)cudaGetLastError();
  if (code != 0) return code;
  code = gp_cholinv_kernel_launch(xs, xp, p, nullptr, ld, U, Z, z, B, M, Pk,
                                  D, kernel_id, stream);
  if (code != 0) return code;
  gp_predict_finish_kernel<<<dim3(Pk / GP_PT, B), GP_THREADS, 0, st>>>(
      Z, z, p, mean, var, M, Pk, Pp);
  return (int)cudaGetLastError();
}
