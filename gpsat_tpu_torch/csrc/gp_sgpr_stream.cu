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
// Design. The data axis is cut into panels of GS_PW columns, and every
// product is a 128 x 128 output tile through gp_mma_pipe (8x8 micro-tiles,
// the next 32-deep chunk in flight while one is multiplied). Sums run in a
// fixed order with no atomics, so a second launch repeats the first bit for
// bit.
// stream1 runs in slabs of at most Ns data columns (the wrapper's slab
// width; the bench's N = 2000 and route mega's whole gate, N <= 4096, are
// one slab), three launches a slab:
//   (a) build   a grid of G blocks (one per SM) takes the (expert, panel)
//               items of the slab in turn: Kuf of the panel into the block's
//               own [Mp][GS_PW] buffer, A~ = W_u^T Kuf tile by tile into the
//               slab, stored data-major [B][Ns][Mp] (so that both operands
//               of (b) are copied by cp.async), and the item's partials of
//               a~ and of |A~|_F^2 from the tiles in registers (the squares
//               of A~ summed, not s2 tr Bsum: the value's trace term
//               sf2 n - |A~|_F^2 cancels, so every rounding of it shows);
//   (b) gram    a grid of (upper 128 x 128 tile pair, expert) items, each
//               one product over the slab's whole depth: it writes its tile
//               of A~ A~^T / s2 and the mirror (first slab) or adds them
//               (later slabs), so Bsum crosses device memory once a slab;
//   (c) reduce  a~ and trA2 from the items' partials, added in order.
// The workspace is one slab, the partials of its panels and G Kuf panels,
// whatever N (201 MB + 35 MB at B = 48, Np = 2048, Mp = 512, G = 132).
// stream2: a grid of G blocks (one per SM, from the wrapper: the 8x8
// micro-tiles take ~220 registers a thread, so a second block of 256 threads
// would not fit beside it) takes the (expert, panel) items in turn, one
// partial per item, so every SM gets the same number of panels within one
// and the workspace is G panel pairs (G x 2 Mp GS_PW floats: 69 MB at
// G = 132, Mp = 512) whatever B and N; P is read once per panel and A~ and
// v Mp / 128 times.
// Bound on an H100: FP32 operations against ~6 M^2 bytes per expert. stream1
// needs 2 M^2 N (the triangular W_u^T Kuf and the symmetric A~ A~^T, M^2 N
// each), stream2 4 M^2 N (A~ again, the dense P A~ at 2 M^2 N, the
// triangular W_u v). The tile products run on the CUDA cores in FP32.
#include "gp_sgpr_common.cuh"

#define GS2_T 128  // output tile edge of the stream kernels' products
static_assert(GS_PW == GS2_T, "a panel is one output tile wide");

// stream1 (a): block b takes the items w = b, b + G, ... of the B x nps
// (expert, panel) pairs of the slab that starts at data column n0; slab
// [B][Ns][Mp] gets A~^T of the slab's columns (row n0' of expert e's slab
// is data column n0 + n0'), partA [B][nps][Mp] and partT [B][nps] the
// item's partials of a~ and |A~|_F^2; pans holds G Kuf panels.
template <int KID>
__global__ void __launch_bounds__(GP_THREADS, 1)
gp_sgpr_stream1_build(const float* xt, const float* yt, const float* zt,
                      const float* p, const float* Wu, float* slab,
                      float* partA, float* partT, float* pans, int B, int Np,
                      int Mp, int D, int n0, int nps, int Ns) {
  constexpr int TM = GS2_T / 16;
  extern __shared__ __align__(16) float sm[];
  float* stage = sm;
  float* red = sm + GP_PIPE_STAGE_FLOATS(GS2_T);
  const GsShared g = gs_carve(red + 32, D, Mp);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  float* kuf = pans + (size_t)blockIdx.x * Mp * GS_PW;

  int staged = -1;
  for (int w = blockIdx.x; w < B * nps; w += gridDim.x) {
    const int e = w / nps, j = w % nps;
    const float* pe = p + (size_t)e * 8;
    const float* Wue = Wu + (size_t)e * Mp * Mp;
    float* At = slab + ((size_t)e * Ns + (size_t)j * GS_PW) * Mp;
    __syncthreads();  // the last item's readers of g are done
    if (e != staged) {
      gs_stage_inducing(g, zt + (size_t)e * 8 * Mp, pe, D, Mp);
      staged = e;
    }
    gs_stage_panel(g, xt + (size_t)e * 8 * Np, yt + (size_t)e * Np, pe, D, Np,
                   n0 + j * GS_PW);
    gs_build_kuf_panel<KID>(g, kuf, Mp, D, pe[5]);

    float tr = 0.f;
    for (int iT = 0; iT < Mp; iT += GS2_T) {
      // A~[iT + r][c] = sum_{q < iT + T} W_u[q][iT + r] Kuf[q][c]
      float acc[TM][TM] = {};
      gp_mma_pipe<GS2_T, true, false>(acc, Wue + iT, Mp, kuf, GS_PW,
                                      iT + GS2_T, stage);
#pragma unroll
      for (int a = 0; a < TM; ++a) {
        // a~ partial of row m over the panel: this thread's eight columns,
        // then the sixteen threads of the row (one half-warp), in order
        float s = 0.f;
#pragma unroll
        for (int b = 0; b < TM; ++b) {
          s += acc[a][b] * g.yv[gp_pipe_at(b, tx)];
          tr += acc[a][b] * acc[a][b];
        }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (tx == 0)
          partA[(size_t)w * Mp + iT + gp_pipe_at(a, ty)] = s;
      }
      // the tile transposed into the slab: four adjacent rows m of one
      // column n are one float4
#pragma unroll
      for (int b = 0; b < TM; ++b)
#pragma unroll
        for (int h = 0; h < TM / 4; ++h)
          *reinterpret_cast<float4*>(At + (size_t)gp_pipe_at(b, tx) * Mp +
                                     iT + h * 64 + ty * 4) =
              make_float4(acc[4 * h + 0][b], acc[4 * h + 1][b],
                          acc[4 * h + 2][b], acc[4 * h + 3][b]);
    }
    tr = gp_block_sum(tr, red);
    if (tid == 0) partT[w] = tr;
  }
}

// stream1 (b): block (t, e) forms tile (i, j), the t-th upper pair i <= j in
// row order, of A~ A~^T / s2 over the slab's depth K and writes it and its
// mirror into Bsum, or adds them where `first` is 0. A diagonal tile is
// symmetric bit for bit (the same products in the same order), so it is
// written once.
__global__ void __launch_bounds__(GP_THREADS, 1)
gp_sgpr_stream1_gram(const float* slab, const float* p, float* Bsum, int Mp,
                     int Ns, int K, int first) {
  constexpr int TM = GS2_T / 16;
  extern __shared__ __align__(16) float stage[];
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int e = blockIdx.y, nt = Mp / GS2_T;
  int t = blockIdx.x, i = 0;
  while (t >= nt - i) {
    t -= nt - i;
    ++i;
  }
  const int iT = i * GS2_T, jT = (i + t) * GS2_T;
  const float* At = slab + (size_t)e * Ns * Mp;
  float acc[TM][TM] = {};
  gp_mma_pipe<GS2_T, true, false>(acc, At + iT, Mp, At + jT, Mp, K, stage);
  const float inv_s2 = 1.f / p[(size_t)e * 8 + 6];
  float* Be = Bsum + (size_t)e * Mp * Mp;
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TM; ++b) {
      const int r = iT + gp_pipe_at(a, ty), c = jT + gp_pipe_at(b, tx);
      float v = acc[a][b] * inv_s2;
      if (!first) v += Be[(size_t)r * Mp + c];
      Be[(size_t)r * Mp + c] = v;
      if (iT != jT) Be[(size_t)c * Mp + r] = v;
    }
}

// stream1 (c): at and trA2 <- the slab's partials added in order, to the
// earlier slabs' sums where `first` is 0. One block per expert.
__global__ void __launch_bounds__(GP_THREADS)
gp_sgpr_stream1_reduce(const float* partA, const float* partT, float* at,
                       float* trA2, int Mp, int nps, int first) {
  const int e = blockIdx.x;
  for (int c = threadIdx.x; c < Mp; c += GP_THREADS) {
    float a = first ? 0.f : at[(size_t)e * Mp + c];
    for (int j = 0; j < nps; ++j) a += partA[((size_t)e * nps + j) * Mp + c];
    at[(size_t)e * Mp + c] = a;
  }
  if (threadIdx.x == 0) {
    float t = first ? 0.f : trA2[e];
    for (int j = 0; j < nps; ++j) t += partT[(size_t)e * nps + j];
    trA2[e] = t;
  }
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
    gs_build_at_panel<KID>(stage, g, Wue, pan, Mp, D, sf2);

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

// slab [B][Ns][Mp], partA [B][Ns / GS_PW][Mp], partT [B][Ns / GS_PW] and
// pans [G][Mp][GS_PW] are scratch from the wrapper; Ns (a multiple of
// GS_PW) is the slab width, G the number of blocks of the build.
extern "C" int gp_sgpr_stream1_launch(const float* xt, const float* yt,
                                      const float* zt, const float* p,
                                      const float* Wu, float* Bsum, float* at,
                                      float* trA2, float* slab, float* partA,
                                      float* partT, float* pans, int B,
                                      int Np, int Mp, int D, int Ns, int G,
                                      int kernel_id, void* stream) {
  const size_t smem = sizeof(float) * gs_smem_floats(D, Mp);
  const size_t gsmem = sizeof(float) * GP_PIPE_STAGE_FLOATS(GS2_T);
  cudaStream_t st = (cudaStream_t)stream;
  const int nt = Mp / GS2_T;
  for (int n0 = 0; n0 < Np; n0 += Ns) {
    const int K = Np - n0 < Ns ? Np - n0 : Ns, nps = K / GS_PW;
    const int first = n0 == 0;
    int code;
    {
      const dim3 grid(B * nps < G ? B * nps : G);
      GP_DISPATCH(gp_sgpr_stream1_build, xt, yt, zt, p, Wu, slab, partA,
                  partT, pans, B, Np, Mp, D, n0, nps, Ns)
      if (code != 0) return code;
    }
    code = gp_launch(gp_sgpr_stream1_gram, dim3(nt * (nt + 1) / 2, B), gsmem,
                     st, (const float*)slab, p, Bsum, Mp, Ns, K, first);
    if (code != 0) return code;
    gp_sgpr_stream1_reduce<<<B, GP_THREADS, 0, st>>>(partA, partT, at, trA2,
                                                     Mp, nps, first);
    code = (int)cudaGetLastError();
    if (code != 0) return code;
  }
  return 0;
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
  const size_t smem = sizeof(float) * gs_smem_floats(D, Mp);
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
