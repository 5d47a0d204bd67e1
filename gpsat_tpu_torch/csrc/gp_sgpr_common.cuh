// Device code shared by the SGPR kernels (gp_sgpr_stream.cu, gp_sgpr_vg.cu):
// the 64x64 tile product gs_mma64, the staging of inducing points and data
// panels, and the routines that build one Kuf panel and one A~ = W_u^T Kuf
// panel.
//
// Replaces the shared pieces of gpsat_tpu/ops/pallas_sgpr.py:
// _build_kuf_at_tiles (:600) and the dot_general tiles of its kernels.
//
// Two tile products serve these kernels. gs_mma64 (64x64 outputs, 4x4
// micro-tiles, float4 shared-memory reads) loads a 32-deep chunk, waits for
// it and multiplies it: nothing overlaps the global loads. The four product
// kernels of gp_sgpr_vg.cu run on it. stream1 and stream2 run on
// gp_mma_pipe<128> of gp_common.cuh: 128x128 outputs with 8x8 micro-tiles
// (4 float4 reads per 64 FMAs instead of 2 per 16, so each operand byte
// feeds twice the FMAs), operands staged without bank conflicts, the next
// 32-deep chunk in flight by cp.async (or in registers, for an operand read
// across its rows) while this one is multiplied. Both are FP32 FMA on the
// CUDA cores and bound by it: the products are ~M^2 N flops against ~M^2
// bytes per expert.
#pragma once

#include "gp_common.cuh"

#define GS_PW 128  // panel width (data columns per pass); Np is a multiple
#define GS_T 64    // output tile edge of gs_mma64; divides GS_PW and Mp
#define GS_KC 32   // depth of one staged chunk
#define GS_TS 68   // padded row stride of a staged chunk (16-byte multiple)

static_assert(GS_TS % 4 == 0 && GS_TS >= GS_T && GS_PW % GS_T == 0,
              "staged rows are read as float4 and hold one tile row");
#define GS_STAGE_FLOATS (2 * GS_KC * GS_TS)  // gs_mma64's shared memory

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

// acc (this thread's 4x4 micro-tile of a GS_T x GS_T output) +=
//   sum_{p < K} opA(r, p) * opB(p, c)
// opA(r, p) = TA ? A[p*lda + r] : A[r*lda + p]
// opB(p, c) = TB ? B[c*ldb + p] : B[p*ldb + c]
// K is a multiple of GS_KC. Both operands stream through `stage` (2 x GS_KC
// x GS_TS floats of shared memory, 16-byte aligned) in chunks of GS_KC.
template <bool TA, bool TB>
static __device__ void gs_mma64(float acc[4][4], const float* A, int lda,
                                const float* B, int ldb, int K,
                                float* stage) {
  float* As = stage;                  // As[p][r]
  float* Bs = stage + GS_KC * GS_TS;  // Bs[p][c]
  const int tid = threadIdx.x;
  const int r0 = (tid >> 4) * 4, c0 = (tid & 15) * 4;
  for (int k0 = 0; k0 < K; k0 += GS_KC) {
    for (int e = tid; e < GS_T * GS_KC; e += GP_THREADS) {
      if (TA) {
        const int p = e / GS_T, r = e % GS_T;
        As[p * GS_TS + r] = A[(size_t)(k0 + p) * lda + r];
      } else {
        const int r = e / GS_KC, p = e % GS_KC;
        As[p * GS_TS + r] = A[(size_t)r * lda + k0 + p];
      }
      if (TB) {
        const int c = e / GS_KC, p = e % GS_KC;
        Bs[p * GS_TS + c] = B[(size_t)c * ldb + k0 + p];
      } else {
        const int p = e / GS_T, c = e % GS_T;
        Bs[p * GS_TS + c] = B[(size_t)(k0 + p) * ldb + c];
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int q = 0; q < GS_KC; ++q) {
      const float4 a4 = *reinterpret_cast<const float4*>(As + q * GS_TS + r0);
      const float4 b4 = *reinterpret_cast<const float4*>(Bs + q * GS_TS + c0);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
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
