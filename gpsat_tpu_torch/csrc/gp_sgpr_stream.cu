// The two N-streamed kernels of the SGPR collapsed-ELBO value and gradient.
//
// Replace gpsat_tpu/ops/pallas_sgpr.py:_sgpr_stream1_kernel (:636, called by
// _sgpr_stream1_call :788) and _sgpr_stream2_kernel (:688, called by
// _sgpr_stream2_call :835), with the routine that stages their tiles,
// _build_kuf_at_tiles (:600). Inputs (all f32):
//   xt [B][8][Np]   data coordinates (dims 0..D-1), float mask in row 7
//   yt [B][Np]      masked observations ybar
//   zt [B][8][Mp]   inducing coordinates, float mask in row 7
//   p  [B][8]       ls_0..ls_{D-1}, sf2 @5, s2 @6
//   Wu [B][Mp][Mp]  W_u = U_u^{-1}, upper triangular with exact zeros below
//                   the diagonal (the output of gp_cholinv.cu); the kernels
//                   skip the zero half of every product with it
// Np is a multiple of GS_PW (128) and Mp of 128.
//
// stream1 -> Bsum [B][Mp][Mp] = A~ A~^T / s2, at [B][Mp] = A~ ybar,
//            trA2 [B] = |A~|_F^2, with A~ = W_u^T Kuf.
// stream2 (plus P [B][Mp][Mp] = I - B^{-1}, dd [B][Mp] = B^{-1} a~)
//         -> gout [B][8]: lanes 1..D the uf part of d/dlog ls_j, lane 6 the
//            uf part of d/dlog sf2, from
//              beta = ybar/s2 - A~^T dd/s2^2,  v = P A~ + dd beta^T,
//              Kbar_uf = -W_u v / s2,
//            reduced elementwise against sf2 phi and sf2 F q2_j (never the
//            rank-1 expansion, which cancels at coincident points).
//
// Design. The data axis is cut into panels of GS_PW columns. For each panel
// a block builds the Kuf panel [Mp x GS_PW] in its slice of a device-memory
// workspace, turns it into A~ in place (tile rows in descending order: row
// i of W_u^T Kuf reads only Kuf rows <= i), and adds its own partial
// outputs. A second kernel adds the partials of each expert in a fixed
// order, so a run repeats itself bit for bit: there are no atomics.
// stream1: block (e, s) of a (B, S) grid walks panels s, s+S, ... of expert
// e; every product is a GS_T x GS_T tile by gs_mma64 (4x4 micro-tiles).
// stream2: a grid of G blocks (one per SM, from the wrapper: the 8x8
// micro-tiles take ~220 registers a thread, so a second block of 256 threads
// would not fit beside it) takes the (expert, panel) items in turn, one
// partial per item, so every SM gets the same number of panels within one
// and the workspace is G panel pairs (G x 2 Mp GS_PW floats: 69 MB at
// G = 132, Mp = 512) whatever B and N; every product is a 128 x 128 tile by
// gp_mma_pipe (the next chunk in flight while one is multiplied), so P is
// read once per panel and A~ and v Mp / 128 times.
// Bound on an H100: FP32 operations against ~6 M^2 bytes per expert. stream1
// needs 2 M^2 N (the triangular W_u^T Kuf and the symmetric A~ A~^T, M^2 N
// each), stream2 4 M^2 N (A~ again, the dense P A~ at 2 M^2 N, the
// triangular W_u v). The tile products run on the CUDA cores in FP32.
#include "gp_sgpr_common.cuh"

template <int KID>
__global__ void __launch_bounds__(GP_THREADS)
gp_sgpr_stream1_kernel(const float* xt, const float* yt, const float* zt,
                       const float* p, const float* Wu, float* partB,
                       float* partA, float* partT, float* ws, int Np, int Mp,
                       int D) {
  extern __shared__ __align__(16) float sm[];
  const int e = blockIdx.x, sp = blockIdx.y, S = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = (tid >> 4) * 4, c0 = (tid & 15) * 4;
  const size_t slot = (size_t)e * S + sp;
  const float* pe = p + (size_t)e * 8;
  const float sf2 = pe[5], inv_s2 = 1.f / pe[6];
  const float* Wue = Wu + (size_t)e * Mp * Mp;
  float* Bp = partB + slot * Mp * Mp;
  float* pan = ws + slot * Mp * GS_PW;
  GpShared s = gp_carve(sm, 0, 0);
  GsShared g = gs_carve(s.xs, D, Mp);

  gs_stage_inducing(g, zt + (size_t)e * 8 * Mp, pe, D, Mp);
  for (int i = tid; i < Mp; i += GP_THREADS) g.vec[i] = 0.f;
  for (int i = tid; i < Mp * Mp; i += GP_THREADS) Bp[i] = 0.f;
  __syncthreads();

  float tr = 0.f;
  for (int n0 = sp * GS_PW; n0 < Np; n0 += S * GS_PW) {
    gs_stage_panel(g, xt + (size_t)e * 8 * Np, yt + (size_t)e * Np, pe, D, Np,
                   n0);
    gs_build_at_panel<KID, GS_T>(s.As, g, Wue, pan, Mp, D, sf2);

    // a~ += A~ ybar and |A~|_F^2, one warp per row
    for (int m = warp; m < Mp; m += GP_THREADS / 32) {
      float a = 0.f, q = 0.f;
      for (int n = lane; n < GS_PW; n += 32) {
        const float v = pan[(size_t)m * GS_PW + n];
        a += v * g.yv[n];
        q += v * v;
      }
      a = gp_warp_sum(a);
      q = gp_warp_sum(q);
      if (lane == 0) {
        g.vec[m] += a;
        tr += q;
      }
    }

    // B += A~ A~^T / s2 over the upper tile pairs (the reduce kernel
    // mirrors them); each thread owns the same entries in every panel
    for (int iT = 0; iT < Mp; iT += GS_T)
      for (int jT = iT; jT < Mp; jT += GS_T) {
        float acc[4][4] = {};
        gs_mma64<false, true>(acc, pan + (size_t)iT * GS_PW, GS_PW,
                              pan + (size_t)jT * GS_PW, GS_PW, GS_PW, s.As);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            Bp[(size_t)(iT + r0 + a) * Mp + jT + c0 + b] += acc[a][b] * inv_s2;
      }
    __syncthreads();
  }

  tr = gp_block_sum(tr, s.red);
  for (int i = tid; i < Mp; i += GP_THREADS) partA[slot * Mp + i] = g.vec[i];
  if (tid == 0) partT[slot] = tr;
}

// Bsum, at, trA2 <- the S partials of each expert, added in order; the tiles
// below the diagonal of Bsum are the mirror of those above it. Grid (B, Mp):
// one block per row of Bsum.
__global__ void __launch_bounds__(GP_THREADS)
gp_sgpr_stream1_reduce(const float* partB, const float* partA,
                       const float* partT, float* Bsum, float* at,
                       float* trA2, int Mp, int S) {
  const int e = blockIdx.x, r = blockIdx.y;
  const size_t base = (size_t)e * S;
  for (int c = threadIdx.x; c < Mp; c += GP_THREADS) {
    const bool upper = r / GS_T <= c / GS_T;
    const size_t o = upper ? (size_t)r * Mp + c : (size_t)c * Mp + r;
    float t = 0.f;
    for (int sp = 0; sp < S; ++sp) t += partB[(base + sp) * Mp * Mp + o];
    Bsum[((size_t)e * Mp + r) * Mp + c] = t;
    if (r == 0) {
      float a = 0.f;
      for (int sp = 0; sp < S; ++sp) a += partA[(base + sp) * Mp + c];
      at[(size_t)e * Mp + c] = a;
    }
  }
  if (r == 0 && threadIdx.x == 0) {
    float t = 0.f;
    for (int sp = 0; sp < S; ++sp) t += partT[base + sp];
    trA2[e] = t;
  }
}

// stream2's block: GS2_T x GS2_T output tiles through gp_mma_pipe, whose
// stage is the front of the dynamic shared memory.
#define GS2_T 128
static_assert(GS_PW == GS2_T, "a stream2 panel is one output tile wide");

static inline __host__ __device__ int gs2_smem_floats(int D, int Mp) {
  return GP_PIPE_STAGE_FLOATS(GS2_T) + 32 + (D + 2) * Mp + (D + 3) * GS_PW;
}

// Grid G: block b takes the items w = b, b + G, ...
// of the B x (Np / GS_PW) (expert, panel) pairs in turn and writes each
// item's partial lanes to partG [B][Np / GS_PW][8]; ws holds G panel pairs.
template <int KID>
__global__ void __launch_bounds__(GP_THREADS, 1)
gp_sgpr_stream2_kernel(const float* xt, const float* yt, const float* zt,
                       const float* p, const float* Wu, const float* Pm,
                       const float* dd, float* partG, float* ws, int B,
                       int Np, int Mp, int D) {
  constexpr int TM = GS2_T / 16;
  extern __shared__ __align__(16) float sm[];
  float* stage = sm;
  float* red = sm + GP_PIPE_STAGE_FLOATS(GS2_T);
  const GsShared g = gs_carve(red + 32, D, Mp);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int np = Np / GS_PW;
  float* pan = ws + (size_t)blockIdx.x * 2 * Mp * GS_PW;  // Kuf, then A~
  float* vpan = pan + (size_t)Mp * GS_PW;                 // v
  const float scale = gp_scale<KID>();

  int staged = -1;
  for (int w = blockIdx.x; w < B * np; w += gridDim.x) {
    const int e = w / np, n0 = (w % np) * GS_PW;
    const float* pe = p + (size_t)e * 8;
    const float sf2 = pe[5], inv_s2 = 1.f / pe[6];
    const float* Wue = Wu + (size_t)e * Mp * Mp;
    const float* Pe = Pm + (size_t)e * Mp * Mp;
    if (e != staged) {
      __syncthreads();
      gs_stage_inducing(g, zt + (size_t)e * 8 * Mp, pe, D, Mp);
      for (int i = tid; i < Mp; i += GP_THREADS)
        g.vec[i] = dd[(size_t)e * Mp + i];
      staged = e;
    }
    gs_stage_panel(g, xt + (size_t)e * 8 * Np, yt + (size_t)e * Np, pe, D, Np,
                   n0);
    gs_build_at_panel<KID, GS2_T>(stage, g, Wue, pan, Mp, D, sf2);

    // beta = ybar / s2 - A~^T dd / s2^2
    for (int n = tid; n < GS_PW; n += GP_THREADS) {
      float a = 0.f;
      for (int m = 0; m < Mp; ++m) a += g.vec[m] * pan[(size_t)m * GS_PW + n];
      g.beta[n] = g.yv[n] * inv_s2 - a * inv_s2 * inv_s2;
    }
    __syncthreads();

    // v = P A~ + dd beta^T
    for (int iT = 0; iT < Mp; iT += GS2_T) {
      float acc[TM][TM] = {};
      gp_mma_pipe<GS2_T, false, false>(acc, Pe + (size_t)iT * Mp, Mp, pan,
                                       GS_PW, Mp, stage);
#pragma unroll
      for (int a = 0; a < TM; ++a) {
        const int m = iT + gp_pipe_at(a, ty);
#pragma unroll
        for (int h = 0; h < TM / 4; ++h) {
          const int n = h * 64 + tx * 4;
          const float dm = g.vec[m];
          *reinterpret_cast<float4*>(vpan + (size_t)m * GS_PW + n) =
              make_float4(acc[a][4 * h + 0] + dm * g.beta[n + 0],
                          acc[a][4 * h + 1] + dm * g.beta[n + 1],
                          acc[a][4 * h + 2] + dm * g.beta[n + 2],
                          acc[a][4 * h + 3] + dm * g.beta[n + 3]);
        }
      }
    }
    __syncthreads();

    // Kbar_uf = -W_u v / s2 tile by tile (row i of W_u reads v rows >= i);
    // each tile goes through the (idle) stage and is reduced elementwise
    // against the kernel derivatives in a loop over its entries
    float gls[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    float gsf2 = 0.f;
    for (int iT = 0; iT < Mp; iT += GS2_T) {
      float acc[TM][TM] = {};
      gp_mma_pipe<GS2_T, false, false>(acc, Wue + (size_t)iT * Mp + iT, Mp,
                                       vpan + (size_t)iT * GS_PW, GS_PW,
                                       Mp - iT, stage);
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int h = 0; h < TM / 4; ++h)
          *reinterpret_cast<float4*>(stage + gp_pipe_at(a, ty) * GS_PW +
                                     h * 64 + tx * 4) =
              make_float4(acc[a][4 * h + 0], acc[a][4 * h + 1],
                          acc[a][4 * h + 2], acc[a][4 * h + 3]);
      __syncthreads();
      for (int e = tid; e < GS2_T * GS_PW; e += GP_THREADS) {
        const int m = iT + e / GS_PW, n = e % GS_PW;
        const float kbar = -stage[e] * inv_s2;
        float q2[5];
        float r2 = 0.f;
        for (int d = 0; d < 5; ++d) {
          if (d < D) {
            const float df = g.zs[d * Mp + m] - g.xs[d * GS_PW + n];
            q2[d] = df * df * scale;
            r2 += q2[d];
          } else {
            q2[d] = 0.f;
          }
        }
        const float mm = g.zm[m] * g.mx[n];
        gsf2 += kbar * (sf2 * gp_phi<KID>(r2) * mm);
        const float qf = kbar * (sf2 * gp_phi_grad<KID>(r2) * mm);
#pragma unroll
        for (int d = 0; d < 5; ++d) gls[d] += qf * q2[d];
      }
      __syncthreads();
    }

    gsf2 = gp_block_sum(gsf2, red);
    for (int d = 0; d < 5; ++d) gls[d] = gp_block_sum(gls[d], red);
    if (tid == 0) {
      float* o = partG + (size_t)w * 8;
      o[0] = 0.f;
      for (int d = 0; d < 5; ++d) o[1 + d] = d < D ? gls[d] : 0.f;
      o[6] = gsf2;
      o[7] = 0.f;
    }
  }
}

// gout [B][8] <- the S partials of each expert, added in order (stream2:
// one partial per panel).
__global__ void gp_sgpr_stream2_reduce(const float* partG, float* gout, int B,
                                       int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * 8) return;
  const int e = i / 8, l = i % 8;
  float t = 0.f;
  for (int sp = 0; sp < S; ++sp) t += partG[((size_t)e * S + sp) * 8 + l];
  gout[i] = t;
}

// partB [B][S][Mp][Mp], partA [B][S][Mp], partT [B][S] and
// ws [B][S][Mp][GS_PW] are scratch from the wrapper.
extern "C" int gp_sgpr_stream1_launch(const float* xt, const float* yt,
                                      const float* zt, const float* p,
                                      const float* Wu, float* Bsum, float* at,
                                      float* trA2, float* partB, float* partA,
                                      float* partT, float* ws, int B, int Np,
                                      int Mp, int D, int S, int kernel_id,
                                      void* stream) {
  const size_t smem = sizeof(float) * gs_smem_floats(D, Mp);
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(B, S);
  int code;
  GP_DISPATCH(gp_sgpr_stream1_kernel, xt, yt, zt, p, Wu, partB, partA, partT,
              ws, Np, Mp, D)
  if (code != 0) return code;
  gp_sgpr_stream1_reduce<<<dim3(B, Mp), GP_THREADS, 0, st>>>(
      partB, partA, partT, Bsum, at, trA2, Mp, S);
  return (int)cudaGetLastError();
}

// partG [B][Np / GS_PW][8] and ws [G][2][Mp][GS_PW] are scratch from the
// wrapper; G is the number of blocks.
extern "C" int gp_sgpr_stream2_launch(const float* xt, const float* yt,
                                      const float* zt, const float* p,
                                      const float* Wu, const float* Pm,
                                      const float* dd, float* gout,
                                      float* partG, float* ws, int B, int Np,
                                      int Mp, int D, int G, int kernel_id,
                                      void* stream) {
  const size_t smem = sizeof(float) * gs2_smem_floats(D, Mp);
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(G);
  int code;
  GP_DISPATCH(gp_sgpr_stream2_kernel, xt, yt, zt, p, Wu, Pm, dd, partG, ws,
              B, Np, Mp, D)
  if (code != 0) return code;
  gp_sgpr_stream2_reduce<<<(B * 8 + 255) / 256, 256, 0, st>>>(
      partG, gout, B, Np / GS_PW);
  return (int)cudaGetLastError();
}
