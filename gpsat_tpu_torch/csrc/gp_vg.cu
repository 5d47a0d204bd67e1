// Fused masked-GPR NLML value and gradient on cholinv's many-blocks factor.
//
// Replaces gpsat_tpu/ops/pallas_gpr.py:_vg_kernel (:602), called through
// _nlml_vg_call (:816) by nlml_vg_batched (:847). Same inputs and the same
// output lanes:
//   xt  [B][8][Nx]  coordinates (dims 0..D-1), float mask in row 7
//   yt  [B][Nx]     masked observations
//   p   [B][8]      ls_0..ls_{D-1}, sf2 @5, noise (+jitter) @6
//   out [B][8]      0: NLML, 1..D: d/dlog ls_j, 6: d/dlog sf2, 7: d/dnoise
//   ws              scratch of gp_vg_ws_floats(B, Nx) floats
// Nx is a multiple of 32; padded columns carry mask 0. The kernels work on
// M = Nx rounded up to GV_T (the tile edge of gp_cholinv.cu), the extra
// rows padded the same way.
//
// Design: a fixed sequence of launches, each with a grid that fills the card
// (many blocks per expert), instead of one block walking an expert's whole
// factor:
//   scale  xs = x / ls, y and the mask, padded to M (gp_gpr_scale_kernel)
//                                                              grid (B)
//   factor gp_cholinv_kernel_launch: cholinv's right-looking schedule on
//          64 x 64 tiles, whose step 0 rebuilds each tile of the masked
//          noisy K from xs where it first reads it (K is never stored),
//          with y as its border: W = U^{-1}, ld = 0.5 log det K and t1 =
//          z = U^{-T} y (by the diag and panel steps), NaN for a pivot that
//          is not positive, for that expert only          4 M/64 - 3 grids
//   alpha  alpha = W t1 = K^{-1} y                         grid (M/64, B)
//   grad   one block per (upper 64 x 64 tile pair (r, c), expert): the tile
//          K^{-1}_rc = sum_{q >= c} W_rq W_cq^T by gp_mma_pipe<64> (both
//          operands read across their rows, parked in shared memory), then
//          Q = K^{-1} - alpha alpha^T reduced against the closed-form dK
//          rebuilt from the tile's coordinates (weight 1/2 on a diagonal
//          tile: Q, dK and the distances are symmetric):
//            d/dlog sf2  = 0.5 sum Q * sf2 phi m m
//            d/dlog ls_j = 0.5 sum Q * sf2 F q2_j m m
//            d/dnoise    = 0.5 sum_i Q_ii m_i
//          into seven partial lanes per item          grid (pairs, B)
//   finish one warp per expert: the value 0.5 |z|^2 + ld + 0.5 n log 2 pi
//          by gp_nlml_warp, as gp_value.cu takes it from the same factor
//          (the two agree bit for bit), and lanes 1..7 from the items'
//          partials, each added in order
// Every sum has a fixed order (no atomics): a second launch repeats the
// first bit for bit. FP32 FMA on the CUDA cores.
// Bound on an H100: FP32 operations (~N^3 per expert: the factor and the
// inverse 2 N^3 / 3, the K^{-1} tiles N^3 / 2, against ~20 N bytes of
// input). The critical path is cholinv's: M/64 diagonal steps on single
// warps and 4 M/64 - 3 launches.
#include "gp_common.cuh"

#define GV_T 64  // tile edge: CI_T of gp_cholinv.cu

extern "C" int gp_cholinv_kernel_launch(const float* xs, const float* xp,
                                        const float* p, float* W, float* ld,
                                        float* ws, float* Z, float* z, int B,
                                        int M, int Pk, int D, int kernel_id,
                                        void* stream);

static inline int gv_pad(int Nx) { return (Nx + GV_T - 1) / GV_T * GV_T; }

// The scratch layout: offsets in floats, in this order.
struct GpVgWorkspace {
  size_t W;      // [B][M][M] W = U^{-1}
  size_t U;      // [B][M][M] cholinv's ws
  size_t z;      // [2][B][M] t1 = U^{-T} y, then the panels' residual
  size_t xs;     // [B][8][M] coordinates / lengthscales, y, mask
  size_t alpha;  // [B][M]
  size_t part;   // [B][pairs][8]
  size_t ld;     // [B]
  size_t floats;
};

static GpVgWorkspace gv_vg_layout(int B, int Nx) {
  const size_t b = B, m = gv_pad(Nx), nt = m / GV_T;
  GpVgWorkspace w;
  size_t q = 0;
  w.W = q; q += b * m * m;
  w.U = q; q += b * m * m;
  w.z = q; q += 2 * b * m;
  w.xs = q; q += b * 8 * m;
  w.alpha = q; q += b * m;
  w.part = q; q += b * (nt * (nt + 1) / 2) * 8;
  w.ld = q; q += b;
  w.floats = q;
  return w;
}

// alpha = W t1 = K^{-1} y with t1 = z = U^{-T} y: block (i, e) forms alpha
// on the 64 rows of tile row i, a warp a row over q >= r.
__global__ void __launch_bounds__(GP_THREADS)
gp_vg_alpha_kernel(const float* W, const float* t1, float* alpha, int M) {
  __shared__ float t[1024];
  const int e = blockIdx.y, rT = blockIdx.x * GV_T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = rT + tid; i < M; i += GP_THREADS) t[i] = t1[(size_t)e * M + i];
  __syncthreads();
  for (int r = rT + warp; r < rT + GV_T; r += GP_THREADS / 32) {
    const float* Wr = W + ((size_t)e * M + r) * M;
    float a = 0.f;
    for (int q = r + lane; q < M; q += 32) a += Wr[q] * t[q];
    a = gp_warp_sum(a);
    if (lane == 0) alpha[(size_t)e * M + r] = a;
  }
}

// The gradient pass: block (t, e) takes the t-th upper tile pair (i, j),
// i <= j, in row order, and writes its seven partial lanes to
// part[e][t][1..7] (lane 0 is 0).
template <int KID>
__global__ void __launch_bounds__(GP_THREADS)
gp_vg_grad_kernel(const float* xs, const float* p, const float* W,
                  const float* alpha, float* part, int M, int D) {
  __shared__ __align__(16) float stage[GP_PIPE_STAGE_FLOATS(GV_T)];
  __shared__ float xr[5][GV_T], xc[5][GV_T], mr[GV_T], mc[GV_T], ar[GV_T],
      ac[GV_T], red[8 * 8];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const int e = blockIdx.y, nt = M / GV_T;
  int t = blockIdx.x, i = 0;
  while (t >= nt - i) {
    t -= nt - i;
    ++i;
  }
  const int j = i + t, rT = i * GV_T, cT = j * GV_T;
  const float* xe = xs + (size_t)e * 8 * M;
  if (tid < GV_T) {
    for (int d = 0; d < D; ++d) {
      xr[d][tid] = xe[d * M + rT + tid];
      xc[d][tid] = xe[d * M + cT + tid];
    }
    mr[tid] = xe[7 * M + rT + tid];
    mc[tid] = xe[7 * M + cT + tid];
    ar[tid] = alpha[(size_t)e * M + rT + tid];
    ac[tid] = alpha[(size_t)e * M + cT + tid];
  }
  // K^{-1} tile: sum_q W[rT + r][q] W[cT + c][q] over q >= cT (W[cT + c][q]
  // is 0 below); gp_mma_pipe synchronises the block before the staged
  // coordinates above are read
  const float* We = W + (size_t)e * M * M;
  float acc[4][4] = {};
  gp_mma_pipe<GV_T, false, true>(acc, We + (size_t)rT * M + cT, M,
                                 We + (size_t)cT * M + cT, M, M - cT, stage);

  const float sf2 = p[(size_t)e * 8 + 5], scale = gp_scale<KID>();
  const float wsym = i == j ? 0.5f : 1.f;
  float v[8] = {};  // lanes: 1..5 d/dlog ls, 6 d/dlog sf2, 7 d/dnoise
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty * 4 + a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = tx * 4 + b;
      const float qp = acc[a][b] - ar[r] * ac[c];
      float q2[5];
      float r2 = 0.f;
      for (int d = 0; d < 5; ++d) {
        if (d < D) {
          const float dd = xr[d][r] - xc[d][c];
          q2[d] = dd * dd * scale;
          r2 += q2[d];
        } else {
          q2[d] = 0.f;
        }
      }
      const float mm = mr[r] * mc[c];
      v[6] += wsym * (qp * (sf2 * gp_phi<KID>(r2) * mm));
      const float qf = qp * (sf2 * gp_phi_grad<KID>(r2) * mm);
#pragma unroll
      for (int d = 0; d < 5; ++d) v[1 + d] += wsym * (qf * q2[d]);
      if (i == j && r == c) v[7] += 0.5f * qp * mr[r];
    }
  }
  // the eight lanes over the block: each warp's sum, then the eight warps'
  // sums in order
#pragma unroll
  for (int l = 1; l < 8; ++l) {
    const float s = gp_warp_sum(v[l]);
    if (lane == 0) red[warp * 8 + l] = s;
  }
  __syncthreads();
  if (tid < 8) {
    float s = 0.f;
    if (tid > 0)
      for (int w = 0; w < GP_THREADS / 32; ++w) s += red[w * 8 + tid];
    part[((size_t)e * gridDim.x + blockIdx.x) * 8 + tid] =
        tid >= 1 + D && tid <= 5 ? 0.f : s;
  }
}

// One warp per expert e: out[e][0] = 0.5 |z|^2 + ld + 0.5 n log 2 pi by
// gp_nlml_warp, and out[e][1..7] <- the partials of the expert's tile
// pairs, lane l adding lane l's in order.
__global__ void __launch_bounds__(GP_THREADS)
gp_vg_finish_kernel(const float* part, const float* z, const float* xs,
                    const float* ld, float* out, int B, int M) {
  const int e = blockIdx.x * (GP_THREADS / 32) + (threadIdx.x >> 5);
  const int l = threadIdx.x & 31;
  if (e >= B) return;
  const int nt = M / GV_T, pairs = nt * (nt + 1) / 2;
  const float v = gp_nlml_warp(z + (size_t)e * M, 1,
                               xs + ((size_t)e * 8 + 7) * M, ld[e], M);
  if (l == 0) out[(size_t)e * 8] = v;
  if (l >= 1 && l < 8) {
    float s = 0.f;
    for (int t = 0; t < pairs; ++t) s += part[((size_t)e * pairs + t) * 8 + l];
    out[(size_t)e * 8 + l] = s;
  }
}

extern "C" long long gp_vg_ws_floats(int B, int Nx) {
  return (long long)gv_vg_layout(B, Nx).floats;
}

extern "C" int gp_vg_launch(const float* xt, const float* yt, const float* p,
                            float* out, float* ws, int B, int Nx, int D,
                            int kernel_id, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const GpVgWorkspace w = gv_vg_layout(B, Nx);
  const int M = gv_pad(Nx), nt = M / GV_T, pairs = nt * (nt + 1) / 2;
  float *W = ws + w.W, *U = ws + w.U, *z = ws + w.z, *xs = ws + w.xs,
        *alpha = ws + w.alpha, *part = ws + w.part, *ld = ws + w.ld;
  gp_gpr_scale_kernel<<<B, GP_THREADS, 0, st>>>(xt, yt, p, xs, Nx, M, D);
  int code = (int)cudaGetLastError();
  if (code != 0) return code;
  code = gp_cholinv_kernel_launch(xs, nullptr, p, W, ld, U, nullptr, z, B,
                                  M, 0, D, kernel_id, stream);
  if (code != 0) return code;
  gp_vg_alpha_kernel<<<dim3(nt, B), GP_THREADS, 0, st>>>(W, z, alpha, M);
  code = (int)cudaGetLastError();
  if (code != 0) return code;
  {
    const dim3 grid(pairs, B);
    const size_t smem = 0;
    GP_DISPATCH(gp_vg_grad_kernel, (const float*)xs, p, (const float*)W,
                (const float*)alpha, part, M, D)
    if (code != 0) return code;
  }
  const int warps = GP_THREADS / 32;
  gp_vg_finish_kernel<<<(B + warps - 1) / warps, GP_THREADS, 0, st>>>(
      part, z, xs, ld, out, B, M);
  return (int)cudaGetLastError();
}

extern "C" const char* gp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
