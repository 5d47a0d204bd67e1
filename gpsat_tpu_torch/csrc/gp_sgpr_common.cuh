// Device code shared by the SGPR kernels (gp_sgpr_stream.cu, gp_sgpr_vg.cu):
// the staging of inducing points and data panels, and the routines that
// build one Kuf panel and one A~ = W_u^T Kuf panel.
//
// Replaces the shared pieces of gpsat_tpu/ops/pallas_sgpr.py:
// _build_kuf_at_tiles (:600) and the dot_general tiles of its kernels.
//
// One tile product serves every SGPR kernel: gp_mma_pipe of gp_common.cuh,
// 128x128 outputs with 8x8 micro-tiles (4 float4 shared reads per 64 FMAs)
// in stream1 and stream2, 64x64 outputs with 4x4 micro-tiles in the four P6
// products of gp_sgpr_vg.cu (more resident blocks an SM). Operands are staged without bank conflicts, the next 32-deep
// chunk in flight by cp.async (or in registers, for an operand read across
// its rows) while this one is multiplied. FP32 FMA on the CUDA cores bounds
// them: the products are ~M^2 N or ~M^3 flops against ~M^2 bytes per
// expert.
#pragma once

#include "gp_common.cuh"

#define GS_PW 128  // panel width (data columns per pass); Np is a multiple

struct GsShared {
  float* zs;    // [D][Mp] inducing coordinates / lengthscales
  float* zm;    // [Mp] inducing mask
  float* vec;   // [Mp] stream2: dd
  float* xs;    // [D][GS_PW] panel coordinates / lengthscales
  float* mx;    // [GS_PW] panel data mask
  float* yv;    // [GS_PW] panel ybar
  float* beta;  // [GS_PW] stream2: beta of the panel
};

// floats of dynamic shared memory of the stream kernels: gp_mma_pipe<128>'s
// stage, 32 for block reductions, then the GsShared fields (gs_carve)
static inline __host__ __device__ int gs_smem_floats(int D, int Mp) {
  return GP_PIPE_STAGE_FLOATS(GS_PW) + 32 + (D + 2) * Mp + (D + 3) * GS_PW;
}

// The GsShared fields from `base` on: (D + 2) Mp + (D + 3) GS_PW floats.
static __device__ __forceinline__ GsShared gs_carve(float* base, int D,
                                                    int Mp) {
  GsShared g;
  g.zs = base;
  g.zm = g.zs + D * Mp;
  g.vec = g.zm + Mp;
  g.xs = g.vec + Mp;
  g.mx = g.xs + D * GS_PW;
  g.yv = g.mx + GS_PW;
  g.beta = g.yv + GS_PW;
  return g;
}

static __device__ void gs_stage_inducing(const GsShared& g, const float* zt,
                                         const float* pe, int D, int Mp) {
  for (int i = threadIdx.x; i < Mp; i += GP_THREADS) {
    for (int d = 0; d < D; ++d) g.zs[d * Mp + i] = zt[d * Mp + i] / pe[d];
    g.zm[i] = zt[7 * Mp + i];
  }
}

static __device__ void gs_stage_panel(const GsShared& g, const float* xt,
                                      const float* yt, const float* pe, int D,
                                      int Np, int n0) {
  for (int i = threadIdx.x; i < GS_PW; i += GP_THREADS) {
    for (int d = 0; d < D; ++d)
      g.xs[d * GS_PW + i] = xt[d * Np + n0 + i] / pe[d];
    g.mx[i] = xt[7 * Np + n0 + i];
    g.yv[i] = yt[n0 + i];
  }
  __syncthreads();
}

// pan [Mp][GS_PW] <- Kuf of the staged panel (data mask and inducing mask
// applied).
template <int KID>
static __device__ void gs_build_kuf_panel(const GsShared& g, float* pan,
                                          int Mp, int D, float sf2) {
  const float scale = gp_scale<KID>();
  for (int i = threadIdx.x; i < Mp * GS_PW; i += GP_THREADS) {
    const int m = i / GS_PW, n = i % GS_PW;
    float r2 = 0.f;
    for (int d = 0; d < D; ++d) {
      const float dd = g.zs[d * Mp + m] - g.xs[d * GS_PW + n];
      r2 += dd * dd;
    }
    pan[i] = sf2 * gp_phi<KID>(r2 * scale) * (g.zm[m] * g.mx[n]);
  }
  __syncthreads();
}

// pan [Mp][GS_PW] <- Kuf of the staged panel, then A~ = W_u^T Kuf in place,
// by 128 x 128 output tiles through gp_mma_pipe (`stage` is its shared
// memory). Tile rows run in descending order: row i of W_u^T Kuf reads only
// Kuf rows <= i, so the rows a tile overwrites are read by no later tile.
template <int KID>
static __device__ void gs_build_at_panel(float* stage, const GsShared& g,
                                         const float* Wu, float* pan, int Mp,
                                         int D, float sf2) {
  constexpr int T = GS_PW, TM = T / 16;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  gs_build_kuf_panel<KID>(g, pan, Mp, D, sf2);
  for (int iT = Mp - T; iT >= 0; iT -= T) {
    // A~[iT + r][c] = sum_{q < iT + T} W_u[q][iT + r] Kuf[q][c]
    float acc[TM][TM] = {};
    gp_mma_pipe<T, true, false>(acc, Wu + iT, Mp, pan, GS_PW, iT + T, stage);
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < TM; ++b)
        pan[(size_t)(iT + gp_pipe_at(a, ty)) * GS_PW + gp_pipe_at(b, tx)] =
            acc[a][b];
  }
  __syncthreads();
}
