// Fused masked-GPR NLML value and gradient, one thread block per expert.
//
// Replaces gpsat_tpu/ops/pallas_gpr.py:_vg_kernel (:602), called through
// _nlml_vg_call (:816) by nlml_vg_batched (:847). Same inputs and the same
// output lanes:
//   xt  [B][8][Np]  coordinates (dims 0..D-1), float mask in row 7
//   yt  [B][Np]     masked observations
//   p   [B][8]      ls_0..ls_{D-1}, sf2 @5, noise (+jitter) @6
//   out [B][8]      0: NLML, 1..D: d/dlog ls_j, 6: d/dlog sf2, 7: d/dnoise
//   ws  [B][Np][2Np] workspace: U at columns [0, Np), W = U^{-1} at [Np, 2Np)
// Np is a multiple of GP_T; padded rows carry mask 0.
//
// Per expert: blocked Cholesky + W (gp_factor_invert), alpha = W W^T y, then
// Q = W W^T - alpha alpha^T tile by tile over the upper tile pairs (Q, dK and
// the distances are symmetric, so an off-diagonal pair counts twice) with the
// closed-form dK of gp_phi_grad reduced on the fly:
//   d/dlog sf2  = 0.5 sum Q * sf2 phi m m
//   d/dlog ls_j = 0.5 sum Q * sf2 F q2_j m m
//   d/dnoise    = 0.5 sum_i Q_ii m_i
// Bound on an H100: FP32 operations (~N^3 per expert); see gp_common.cuh.
#include "gp_common.cuh"

template <int KID>
__global__ void __launch_bounds__(GP_THREADS)
gp_vg_kernel(const float* __restrict__ xt, const float* __restrict__ yt,
             const float* __restrict__ p, float* __restrict__ out,
             float* ws, int Np, int D) {
  extern __shared__ float sm[];
  const int e = blockIdx.x;
  const int ld = 2 * Np;
  const float* pe = p + (size_t)e * 8;
  const float sf2 = pe[5], noise = pe[6];
  float* U = ws + (size_t)e * Np * ld;
  float* W = U + Np;
  GpShared s = gp_carve(sm, D, Np);
  gp_stage(s, xt + (size_t)e * 8 * Np, yt + (size_t)e * Np, pe, D, Np);

  const float logdet = gp_factor_invert<KID>(s, U, W, ld, D, Np, sf2, noise);
  gp_alpha(s, W, ld, Np);

  const int tid = threadIdx.x;
  const int r0 = (tid >> 4) * 2, c0 = (tid & 15) * 2;
  const int nb = Np / GP_T;
  const float scale = gp_scale<KID>();
  float gls[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  float gsf2 = 0.f, gn = 0.f;
  for (int rt = 0; rt < nb; ++rt) {
    for (int ct = rt; ct < nb; ++ct) {
      // K^{-1} tile (rt, ct) = sum_q W[rt*T + r][q] W[ct*T + c][q], q >= ct*T
      const int q0 = ct * GP_T;
      float kinv[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      tile_mma<false, true>(kinv, W + (size_t)rt * GP_T * ld + q0, ld,
                            W + (size_t)ct * GP_T * ld + q0, ld, Np - q0, s);
      const float wsym = (rt == ct) ? 0.5f : 1.f;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int r = rt * GP_T + r0 + a;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int c = ct * GP_T + c0 + b;
          const float qp = kinv[a][b] - s.alpha[r] * s.alpha[c];
          float q2[5];
          float r2 = 0.f;
          for (int d = 0; d < 5; ++d) {
            if (d < D) {
              const float dd = s.xs[d * Np + r] - s.xs[d * Np + c];
              q2[d] = dd * dd * scale;
              r2 += q2[d];
            } else {
              q2[d] = 0.f;
            }
          }
          const float mm = s.m[r] * s.m[c];
          gsf2 += wsym * (qp * (sf2 * gp_phi<KID>(r2) * mm));
          const float qf = qp * (sf2 * gp_phi_grad<KID>(r2) * mm);
#pragma unroll
          for (int d = 0; d < 5; ++d) gls[d] += wsym * (qf * q2[d]);
          if (r == c) gn += 0.5f * qp * s.m[r];
        }
      }
    }
  }

  float quad = 0.f, nvalid = 0.f;
  for (int i = tid; i < Np; i += GP_THREADS) {
    quad += s.y[i] * s.alpha[i];
    nvalid += s.m[i];
  }
  quad = gp_block_sum(quad, s.red);
  nvalid = gp_block_sum(nvalid, s.red);
  gsf2 = gp_block_sum(gsf2, s.red);
  gn = gp_block_sum(gn, s.red);
  for (int d = 0; d < 5; ++d) gls[d] = gp_block_sum(gls[d], s.red);
  if (tid == 0) {
    float* o = out + (size_t)e * 8;
    o[0] = 0.5f * quad + logdet + 0.5f * nvalid * 1.8378770664093453f;
    for (int d = 0; d < 5; ++d) o[1 + d] = d < D ? gls[d] : 0.f;
    o[6] = gsf2;
    o[7] = gn;
  }
}

extern "C" int gp_vg_launch(const float* xt, const float* yt, const float* p,
                            float* out, float* ws, int B, int Np, int D,
                            int kernel_id, void* stream) {
  const size_t smem = sizeof(float) * gp_smem_floats(D, Np, 0);
  cudaStream_t st = (cudaStream_t)stream;
  switch (kernel_id) {
    case GP_MATERN12:
      return gp_launch(gp_vg_kernel<GP_MATERN12>, B, smem, st, xt, yt, p,
                       out, ws, Np, D);
    case GP_MATERN32:
      return gp_launch(gp_vg_kernel<GP_MATERN32>, B, smem, st, xt, yt, p,
                       out, ws, Np, D);
    case GP_MATERN52:
      return gp_launch(gp_vg_kernel<GP_MATERN52>, B, smem, st, xt, yt, p,
                       out, ws, Np, D);
    case GP_RBF:
      return gp_launch(gp_vg_kernel<GP_RBF>, B, smem, st, xt, yt, p, out, ws,
                       Np, D);
    case GP_EXPONENTIAL:
      return gp_launch(gp_vg_kernel<GP_EXPONENTIAL>, B, smem, st, xt, yt, p,
                       out, ws, Np, D);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* gp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
