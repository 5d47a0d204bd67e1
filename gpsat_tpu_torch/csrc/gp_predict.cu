// Fused masked-GPR posterior prediction, one thread block per expert.
//
// Replaces gpsat_tpu/ops/pallas_gpr.py:_predict_kernel (:952), called through
// _predict_call (:1108) by posterior_predict_batched (:1146). Inputs as
// gp_vg.cu plus
//   xs   [B][8][Pp]  prediction coordinates (dims 0..D-1)
//   mean [B][Pp]     Ks^T alpha
//   var  [B][Pp]     sf2 - ||W^T Ks||^2 (the wrapper clamps at 0)
//   ws   [B][Np][2Np + Pp] workspace: U | W = U^{-1} | Ks
// where Ks = sf2 phi(X, Xs) with masked data rows. Np and Pp are multiples
// of GP_T.
// Bound on an H100: FP32 operations (~N^3/3 + 2 N^2 P per expert beyond the
// factorisation); see gp_common.cuh.
#include "gp_common.cuh"

template <int KID>
__global__ void __launch_bounds__(GP_THREADS)
gp_predict_kernel(const float* __restrict__ xt, const float* __restrict__ yt,
                  const float* __restrict__ p, const float* __restrict__ xs,
                  float* __restrict__ mean, float* __restrict__ var,
                  float* ws, int Np, int Pp, int D) {
  extern __shared__ float sm[];
  const int e = blockIdx.x;
  const int ld = 2 * Np + Pp;
  const float* pe = p + (size_t)e * 8;
  const float sf2 = pe[5], noise = pe[6];
  float* U = ws + (size_t)e * Np * ld;
  float* W = U + Np;
  float* Ks = U + 2 * Np;
  GpShared s = gp_carve(sm, D, Np);
  gp_stage(s, xt + (size_t)e * 8 * Np, yt + (size_t)e * Np, pe, D, Np);
  const float* xse = xs + (size_t)e * 8 * Pp;
  for (int i = threadIdx.x; i < Pp; i += GP_THREADS)
    for (int d = 0; d < D; ++d) s.xp[d * Pp + i] = xse[d * Pp + i] / pe[d];

  gp_factor_invert<KID>(s, U, W, ld, D, Np, sf2, noise);
  gp_alpha(s, W, ld, Np);

  const int tid = threadIdx.x;
  const float scale = gp_scale<KID>();
  for (int i = tid; i < Np * Pp; i += GP_THREADS) {
    const int r = i / Pp, c = i % Pp;
    float r2 = 0.f;
    for (int d = 0; d < D; ++d) {
      const float dd = s.xs[d * Np + r] - s.xp[d * Pp + c];
      r2 += dd * dd;
    }
    Ks[(size_t)r * ld + c] = sf2 * gp_phi<KID>(r2 * scale) * s.m[r];
  }
  __syncthreads();

  for (int c = tid; c < Pp; c += GP_THREADS) {
    float a = 0.f;
    for (int r = 0; r < Np; ++r) a += Ks[(size_t)r * ld + c] * s.alpha[r];
    mean[(size_t)e * Pp + c] = a;
  }

  // var: column sums of (W^T Ks)^2, tile row rt of W^T Ks reading rows
  // q < (rt+1)T of W (W upper)
  const int c0 = (tid & 15) * 2;
  const int nb = Np / GP_T, nbp = Pp / GP_T;
  for (int ct = 0; ct < nbp; ++ct) {
    float col[2] = {0.f, 0.f};
    for (int rt = 0; rt < nb; ++rt) {
      float v[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      tile_mma<true, false>(v, W + rt * GP_T, ld, Ks + ct * GP_T, ld,
                            (rt + 1) * GP_T, s);
      col[0] += v[0][0] * v[0][0] + v[1][0] * v[1][0];
      col[1] += v[0][1] * v[0][1] + v[1][1] * v[1][1];
    }
    s.red[(tid >> 4) * GP_TS + c0] = col[0];
    s.red[(tid >> 4) * GP_TS + c0 + 1] = col[1];
    __syncthreads();
    if (tid < GP_T) {
      float t = 0.f;
      for (int g = 0; g < 16; ++g) t += s.red[g * GP_TS + tid];
      var[(size_t)e * Pp + ct * GP_T + tid] = sf2 - t;
    }
    __syncthreads();
  }
}

extern "C" int gp_predict_launch(const float* xt, const float* yt,
                                 const float* p, const float* xs,
                                 float* mean, float* var, float* ws, int B,
                                 int Np, int Pp, int D, int kernel_id,
                                 void* stream) {
  const size_t smem = sizeof(float) * gp_smem_floats(D, Np, Pp);
  cudaStream_t st = (cudaStream_t)stream;
  switch (kernel_id) {
    case GP_MATERN12:
      return gp_launch(gp_predict_kernel<GP_MATERN12>, B, smem, st, xt, yt,
                       p, xs, mean, var, ws, Np, Pp, D);
    case GP_MATERN32:
      return gp_launch(gp_predict_kernel<GP_MATERN32>, B, smem, st, xt, yt,
                       p, xs, mean, var, ws, Np, Pp, D);
    case GP_MATERN52:
      return gp_launch(gp_predict_kernel<GP_MATERN52>, B, smem, st, xt, yt,
                       p, xs, mean, var, ws, Np, Pp, D);
    case GP_RBF:
      return gp_launch(gp_predict_kernel<GP_RBF>, B, smem, st, xt, yt, p, xs,
                       mean, var, ws, Np, Pp, D);
    case GP_EXPONENTIAL:
      return gp_launch(gp_predict_kernel<GP_EXPONENTIAL>, B, smem, st, xt,
                       yt, p, xs, mean, var, ws, Np, Pp, D);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
