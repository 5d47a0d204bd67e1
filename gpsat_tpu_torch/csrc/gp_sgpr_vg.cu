// The whole SGPR collapsed negative-ELBO value and gradient in one launch
// entry: packed inputs in, [B][8] lanes out, no host work in between.
//
// Replaces gpsat_tpu/ops/pallas_sgpr.py:_sgpr_vg_kernel (:880, called through
// _sgpr_vg_call :1218 by sgpr_vg_batched :1255 under its monolithic-kernel
// switch), phases P1-P8. Inputs (all f32, as gp_sgpr_stream.cu):
//   xt [B][8][Np]  data coordinates (dims 0..D-1), float mask in row 7
//   yt [B][Np]     masked observations ybar
//   zt [B][8][Mp]  inducing coordinates, float mask in row 7
//   p  [B][8]      ls_0..ls_{D-1}, sf2 @5, s2 @6
//   out [B][8]     0: value, 1..D: d/dlog ls_j, 6: d/dlog sf2, 7: d/ds2
//   ws             scratch of gp_sgpr_vg_ws_floats(B, Np, Mp, G) floats
// Np is a multiple of 128, at most 4096 (one slab of the first streamed
// pass), and Mp of 128; G is the number of blocks of the streamed passes'
// item grids.
//
// Design. The TPU kernel walks its phases in one program because its grid
// runs in order on one core with every factor resident in VMEM. Here one
// host call enqueues a fixed sequence of kernels on the caller's stream, each
// with the grid that fills the card for its phase:
//   P1  gv_kuu_kernel       Kuu, masked, jitter on the valid diagonal and a
//                           unit diagonal on padded rows     grid (B, Mp)
//   P2  gp_cholinv_launch   W_u = U_u^{-1}                   grid (B)
//   P3  gp_sgpr_stream1_launch  Bsum = A~A~^T/s2, a~, |A~|^2 grids (G),
//                           (tile pairs, B), (B)
//   P4  gv_add_identity, gp_cholinv_launch  B = I + Bsum -> W_B, log det
//   P5  gv_small_kernel     c, dd = B^{-1} a~, e = W_u dd, the scalars, the
//                           value and d/ds2 (P8)             grid (B)
//   P6  gv_t1/gv_p/gv_t2/gv_kbar_uu  the M^3-sized products and the Kbar_uu
//                           reductions, one 64x64 tile per block
//                                                    grid (B, Mp/64, Mp/64)
//   P7  gp_sgpr_stream2_launch  the Kbar_uf reductions       grid (G)
//       gv_finish_kernel    the lanes of out
// P = I - B^{-1} is formed as B^{-1} Bsum = W_B (W_B^T Bsum) (eigenvalues in
// [0, 1), no subtraction from I). The three W_u-sandwiched terms of Kbar_uu
// collapse with B - 2I + B^{-1} = Bsum - P into
//   Kbar_uu = 0.5 [W_u (Bsum - P) W_u^T + e e^T / s2^2],
// two triangular products instead of the TPU kernel's Gamma1^T Gamma1,
// W_u W_u^T and Gamma2 Gamma2^T, and U_B is never read. Kbar_uu and dKuu are
// symmetric, so only upper tile pairs are reduced (weight 2 off the
// diagonal). Every sum has a fixed order (no atomics): a second launch
// repeats the first bit for bit.
// Bound on an H100: FP32 operations: 6 M^2 N for the two streamed passes,
// 4 M^3 / 3 for the two factor-inverses and ~3.7 M^3 for the P6 products,
// against ~9 N + 10 M floats of input per expert.
#include "gp_sgpr_common.cuh"

extern "C" int gp_cholinv_launch(const float* A, float* W, float* ld,
                                 float* ws, int B, int M, void* stream);
extern "C" int gp_sgpr_stream1_launch(const float* xt, const float* yt,
                                      const float* zt, const float* p,
                                      const float* Wu, float* Bsum, float* at,
                                      float* trA2, float* slab, float* partA,
                                      float* partT, float* pans, int B,
                                      int Np, int Mp, int D, int Ns, int G,
                                      int kernel_id, void* stream);
extern "C" int gp_sgpr_stream2_launch(const float* xt, const float* yt,
                                      const float* zt, const float* p,
                                      const float* Wu, const float* Pm,
                                      const float* dd, float* gout,
                                      float* partG, float* ws, int B, int Np,
                                      int Mp, int D, int G, int kernel_id,
                                      void* stream);

// P1: one block per row of Kuu. The other two routes build Kuu in torch
// (ops/cuda_sgpr._kuu), one rounding per operation. With jitter 1e-6 and a
// few hundred inducing points Kuu sits at the edge of what f32 can factor, so
// whether a pivot stays positive can turn on the last bit of an entry: the
// intrinsics below keep the compiler from contracting a multiply and an add
// into one fused operation, so that every route factors the same matrix.
template <int KID>
__global__ void __launch_bounds__(GP_THREADS)
gv_kuu_kernel(const float* zt, const float* p, float* Kuu, int Mp, int D,
              float jitter) {
  const int e = blockIdx.x, r = blockIdx.y;
  const float* ze = zt + (size_t)e * 8 * Mp;
  const float* pe = p + (size_t)e * 8;
  const float sf2 = pe[5], scale = gp_scale<KID>();
  const float zmr = ze[7 * Mp + r];
  float zr[5];
  for (int d = 0; d < 5; ++d) zr[d] = d < D ? ze[d * Mp + r] / pe[d] : 0.f;
  float* row = Kuu + ((size_t)e * Mp + r) * Mp;
  for (int c = threadIdx.x; c < Mp; c += GP_THREADS) {
    float r2 = 0.f;
    for (int d = 0; d < D; ++d) {
      const float df = __fsub_rn(zr[d], ze[d * Mp + c] / pe[d]);
      const float sq = __fmul_rn(df, df);
      r2 = d == 0 ? sq : __fadd_rn(r2, sq);
    }
    const float k = __fmul_rn(__fmul_rn(sf2, gp_phi<KID>(__fmul_rn(r2, scale))),
                              __fmul_rn(zmr, ze[7 * Mp + c]));
    const float diag = __fadd_rn(__fmul_rn(zmr, jitter - 1.f), 1.f);
    row[c] = r == c ? __fadd_rn(k, diag) : k;
  }
}

// P4: Bm = I + Bsum, one block per row.
__global__ void __launch_bounds__(GP_THREADS)
gv_add_identity(const float* Bsum, float* Bm, int Mp) {
  const int r = blockIdx.y;
  const size_t o = ((size_t)blockIdx.x * Mp + r) * Mp;
  for (int c = threadIdx.x; c < Mp; c += GP_THREADS)
    Bm[o + c] = Bsum[o + c] + (r == c ? 1.f : 0.f);
}

// P5 and P8: the M-sized rows and the scalars, one block per expert.
//   c = a~^T W_B, dd = W_B c = B^{-1} a~, e = W_u dd
//   scal[e][0] = value, [1] = d/ds2, [2] = the trKff term of d/dlog sf2
// W_B and W_u are upper triangular with exact zeros below the diagonal.
// The constant M of d/ds2 is the padded one: tr B^{-1} and M cancel row by
// row on the padded inducing rows.
__global__ void __launch_bounds__(GP_THREADS)
gv_small_kernel(const float* xt, const float* yt, const float* p,
                const float* Wu, const float* WB, const float* at,
                const float* trA2, const float* ldB, float* dd, float* ev,
                float* scal, int Np, int Mp) {
  extern __shared__ float sm[];
  float* a_s = sm;           // [Mp] a~
  float* c_s = sm + Mp;      // [Mp] c
  float* d_s = sm + 2 * Mp;  // [Mp] dd
  float* red = sm + 3 * Mp;  // [32]
  const int e = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* Wue = Wu + (size_t)e * Mp * Mp;
  const float* WBe = WB + (size_t)e * Mp * Mp;
  for (int i = tid; i < Mp; i += GP_THREADS) a_s[i] = at[(size_t)e * Mp + i];
  __syncthreads();
  for (int j = tid; j < Mp; j += GP_THREADS) {
    float a = 0.f;
    for (int q = 0; q <= j; ++q) a += a_s[q] * WBe[(size_t)q * Mp + j];
    c_s[j] = a;
  }
  __syncthreads();
  for (int i = warp; i < Mp; i += GP_THREADS / 32) {
    float a = 0.f;
    for (int q = i + lane; q < Mp; q += 32) a += WBe[(size_t)i * Mp + q] * c_s[q];
    a = gp_warp_sum(a);
    if (lane == 0) d_s[i] = a;
  }
  __syncthreads();
  for (int i = warp; i < Mp; i += GP_THREADS / 32) {
    float a = 0.f;
    for (int q = i + lane; q < Mp; q += 32) a += Wue[(size_t)i * Mp + q] * d_s[q];
    a = gp_warp_sum(a);
    if (lane == 0) ev[(size_t)e * Mp + i] = a;
  }

  float trb = 0.f, atdd = 0.f, dddd = 0.f, ydoty = 0.f, n = 0.f;
  for (int i = tid; i < Mp * Mp; i += GP_THREADS) trb += WBe[i] * WBe[i];
  for (int i = tid; i < Mp; i += GP_THREADS) {
    atdd += a_s[i] * d_s[i];
    dddd += d_s[i] * d_s[i];
    dd[(size_t)e * Mp + i] = d_s[i];
  }
  for (int i = tid; i < Np; i += GP_THREADS) {
    const float y = yt[(size_t)e * Np + i];
    ydoty += y * y;
    n += xt[((size_t)e * 8 + 7) * Np + i];
  }
  trb = gp_block_sum(trb, red);
  atdd = gp_block_sum(atdd, red);
  dddd = gp_block_sum(dddd, red);
  ydoty = gp_block_sum(ydoty, red);
  n = gp_block_sum(n, red);
  if (tid == 0) {
    const float sf2 = p[(size_t)e * 8 + 5], s2 = p[(size_t)e * 8 + 6];
    const float tA = trA2[e];
    float* o = scal + (size_t)e * 4;
    o[0] = 0.5f * n * 1.8378770664093453f + ldB[e] + 0.5f * n * logf(s2) +
           0.5f * ydoty / s2 - 0.5f * atdd / (s2 * s2) +
           0.5f * (sf2 * n - tA) / s2;
    o[1] = 0.5f / s2 * (n - (float)Mp + trb) -
           0.5f / (s2 * s2) * (ydoty - atdd / s2 - dddd / s2) -
           0.5f / (s2 * s2) * (sf2 * n - tA);
    o[2] = 0.5f * sf2 * n / s2;
    o[3] = 0.f;
  }
}

// The P6 products: block (e, i, j) computes the 64x64 tile (i, j) of one
// [Mp][Mp] product of expert e, skipping the zero half of a triangular
// operand.
#define GV_TILE_PROLOGUE                                      \
  __shared__ __align__(16) float stage[GS_STAGE_FLOATS];      \
  const int tid = threadIdx.x;                                \
  const int r0 = (tid >> 4) * 4, c0 = (tid & 15) * 4;         \
  const int iT = blockIdx.y * GS_T, jT = blockIdx.z * GS_T;   \
  const size_t off = (size_t)blockIdx.x * Mp * Mp;            \
  float acc[4][4] = {};

// T1 = W_B^T Bsum: T1[i][j] = sum_{q <= i} W_B[q][i] Bsum[q][j]
__global__ void __launch_bounds__(GP_THREADS)
gv_t1_kernel(const float* WB, const float* Bsum, float* T1, int Mp) {
  GV_TILE_PROLOGUE
  gs_mma64<true, false>(acc, WB + off + iT, Mp, Bsum + off + jT, Mp,
                        iT + GS_T, stage);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      T1[off + (size_t)(iT + r0 + a) * Mp + jT + c0 + b] = acc[a][b];
}

// P = W_B T1 = B^{-1} Bsum: P[i][j] = sum_{q >= i} W_B[i][q] T1[q][j];
// Bsum becomes C = Bsum - P in place (no other block reads this tile).
__global__ void __launch_bounds__(GP_THREADS)
gv_p_kernel(const float* WB, const float* T1, float* Pm, float* BsumC,
            int Mp) {
  GV_TILE_PROLOGUE
  gs_mma64<false, false>(acc, WB + off + (size_t)iT * Mp + iT, Mp,
                         T1 + off + (size_t)iT * Mp + jT, Mp, Mp - iT, stage);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const size_t o = off + (size_t)(iT + r0 + a) * Mp + jT + c0 + b;
      Pm[o] = acc[a][b];
      BsumC[o] -= acc[a][b];
    }
}

// T2 = C W_u^T: T2[i][j] = sum_{q >= j} C[i][q] W_u[j][q]
__global__ void __launch_bounds__(GP_THREADS)
gv_t2_kernel(const float* C, const float* Wu, float* T2, int Mp) {
  GV_TILE_PROLOGUE
  gs_mma64<false, true>(acc, C + off + (size_t)iT * Mp + jT, Mp,
                        Wu + off + (size_t)jT * Mp + jT, Mp, Mp - jT, stage);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      T2[off + (size_t)(iT + r0 + a) * Mp + jT + c0 + b] = acc[a][b];
}

// Kbar_uu tile (i, j), j >= i, = 0.5 [W_u T2 + e e^T / s2^2], reduced on the
// fly against sf2 phi and sf2 F q2_d of Kuu (elementwise, never the rank-1
// expansion) into partU [B][nt][nt][8]: lanes 1..D the uu part of d/dlog
// ls_d, lane 6 the uu part of d/dlog sf2. Lower tile pairs write nothing.
template <int KID>
__global__ void __launch_bounds__(GP_THREADS)
gv_kbar_uu_kernel(const float* zt, const float* p, const float* Wu,
                  const float* T2, const float* ev, float* partU, int Mp,
                  int D) {
  GV_TILE_PROLOGUE
  __shared__ float zr[5][GS_T], zc[5][GS_T], mr[GS_T], mc[GS_T], er[GS_T],
      ec[GS_T], red[32];
  if (jT < iT) return;
  const int e = blockIdx.x;
  const float* ze = zt + (size_t)e * 8 * Mp;
  const float* pe = p + (size_t)e * 8;
  const float sf2 = pe[5], inv_s4 = 1.f / (pe[6] * pe[6]);
  const float scale = gp_scale<KID>();
  if (tid < GS_T) {
    for (int d = 0; d < D; ++d) {
      zr[d][tid] = ze[d * Mp + iT + tid] / pe[d];
      zc[d][tid] = ze[d * Mp + jT + tid] / pe[d];
    }
    mr[tid] = ze[7 * Mp + iT + tid];
    mc[tid] = ze[7 * Mp + jT + tid];
    er[tid] = ev[(size_t)e * Mp + iT + tid];
    ec[tid] = ev[(size_t)e * Mp + jT + tid];
  }
  // W_u T2: sum_{q >= i} W_u[i][q] T2[q][j] (gs_mma64 synchronises the block
  // before the staged rows above are read)
  gs_mma64<false, false>(acc, Wu + off + (size_t)iT * Mp + iT, Mp,
                         T2 + off + (size_t)iT * Mp + jT, Mp, Mp - iT, stage);
  const float wsym = (iT == jT) ? 1.f : 2.f;
  float gls[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  float gsf2 = 0.f;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = r0 + a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = c0 + b;
      const float kbar = 0.5f * (acc[a][b] + er[r] * ec[c] * inv_s4);
      float q2[5];
      float r2 = 0.f;
      for (int d = 0; d < 5; ++d) {
        if (d < D) {
          const float df = zr[d][r] - zc[d][c];
          q2[d] = df * df * scale;
          r2 += q2[d];
        } else {
          q2[d] = 0.f;
        }
      }
      const float mm = mr[r] * mc[c];
      gsf2 += kbar * (sf2 * gp_phi<KID>(r2) * mm);
      const float qf = kbar * (sf2 * gp_phi_grad<KID>(r2) * mm);
#pragma unroll
      for (int d = 0; d < 5; ++d) gls[d] += qf * q2[d];
    }
  }
  gsf2 = gp_block_sum(gsf2, red);
  for (int d = 0; d < 5; ++d) gls[d] = gp_block_sum(gls[d], red);
  if (tid == 0) {
    float* o = partU + (((size_t)e * gridDim.y + blockIdx.y) * gridDim.z +
                        blockIdx.z) * 8;
    o[0] = 0.f;
    for (int d = 0; d < 5; ++d) o[1 + d] = d < D ? wsym * gls[d] : 0.f;
    o[6] = wsym * gsf2;
    o[7] = 0.f;
  }
}

// out [B][8] <- value and d/ds2 from scal, the uu partials of the upper tile
// pairs added in order, the uf lanes of the second streamed pass and the
// trKff term.
__global__ void gv_finish_kernel(const float* scal, const float* partU,
                                 const float* gout, float* out, int B,
                                 int nt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * 8) return;
  const int e = i / 8, l = i % 8;
  if (l == 0 || l == 7) {
    out[i] = scal[(size_t)e * 4 + (l == 0 ? 0 : 1)];
    return;
  }
  float t = 0.f;
  for (int a = 0; a < nt; ++a)
    for (int b = a; b < nt; ++b)
      t += partU[(((size_t)e * nt + a) * nt + b) * 8 + l];
  t += gout[i];
  if (l == 6) t += scal[(size_t)e * 4 + 2];
  out[i] = t;
}

// The scratch layout: offsets in floats, in this order.
struct GvWorkspace {
  size_t A0;    // [B][Mp][Mp] Kuu, then I + Bsum, then T1, then T2
  size_t Wu;    // [B][Mp][Mp]
  size_t Uw;    // [B][Mp][Mp] cholinv's U of both factorisations, then P
  size_t Bs;    // [B][Mp][Mp] Bsum, then C = Bsum - P
  size_t WB;    // [B][Mp][Mp]
  size_t at, dd, ev;        // [B][Mp]
  size_t trA2, ldu, ldB;    // [B]
  size_t scal;              // [B][4]
  size_t gout;              // [B][8]
  size_t partU;             // [B][Mp/64][Mp/64][8]
  size_t stream;            // the streamed passes' partials and panels
  size_t floats;            // the whole
};

static GvWorkspace gv_layout(int B, int Np, int Mp, int G) {
  const size_t b = B, m = Mp, m2 = m * m, nt = m / GS_T;
  const size_t np = Np / GS_PW, g = G;
  GvWorkspace w;
  size_t q = 0;
  w.A0 = q; q += b * m2;
  w.Wu = q; q += b * m2;
  w.Uw = q; q += b * m2;
  w.Bs = q; q += b * m2;
  w.WB = q; q += b * m2;
  w.at = q; q += b * m;
  w.dd = q; q += b * m;
  w.ev = q; q += b * m;
  w.trA2 = q; q += b;
  w.ldu = q; q += b;
  w.ldB = q; q += b;
  w.scal = q; q += b * 4;
  w.gout = q; q += b * 8;
  w.partU = q; q += b * nt * nt * 8;
  q = (q + 63) / 64 * 64;  // gp_mma_pipe reads the panels by 16-byte copies
  w.stream = q;
  // pass 1: Kuf panels [G][Mp][GS_PW], the slab [B][Np][Mp], partA
  // [B][Np / GS_PW][Mp], partT [B][Np / GS_PW]; pass 2: partG
  // [B][Np / GS_PW][8], panels [G][2][Mp][GS_PW], over the same floats
  const size_t s1 = g * m * GS_PW + b * Np * m + b * np * (m + 1);
  const size_t s2 = b * np * 8 + g * 2 * m * GS_PW;
  w.floats = q + (s1 > s2 ? s1 : s2);
  return w;
}

extern "C" long long gp_sgpr_vg_ws_floats(int B, int Np, int Mp, int G) {
  return (long long)gv_layout(B, Np, Mp, G).floats;
}

extern "C" int gp_sgpr_vg_launch(const float* xt, const float* yt,
                                 const float* zt, const float* p, float* out,
                                 float* ws, int B, int Np, int Mp, int D,
                                 int G, float jitter, int kernel_id,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const GvWorkspace w = gv_layout(B, Np, Mp, G);
  const size_t b = B, m = Mp, g = G;
  const int nt = Mp / GS_T;
  const dim3 rows(B, Mp), tiles(B, nt, nt);
  float *A0 = ws + w.A0, *Wu = ws + w.Wu, *Uw = ws + w.Uw, *Bs = ws + w.Bs,
        *WB = ws + w.WB, *at = ws + w.at, *dd = ws + w.dd, *ev = ws + w.ev,
        *trA2 = ws + w.trA2, *ldu = ws + w.ldu, *ldB = ws + w.ldB,
        *scal = ws + w.scal, *gout = ws + w.gout, *partU = ws + w.partU;
  int code;
  {
    const dim3 grid = rows;
    const size_t smem = 0;
    GP_DISPATCH(gv_kuu_kernel, zt, p, A0, Mp, D, jitter)
    if (code != 0) return code;
  }
  code = gp_cholinv_launch(A0, Wu, ldu, Uw, B, Mp, stream);
  if (code != 0) return code;
  {
    float* pans = ws + w.stream;
    float* slab = pans + g * m * GS_PW;
    float* partA = slab + b * Np * m;
    float* partT = partA + b * (Np / GS_PW) * m;
    code = gp_sgpr_stream1_launch(xt, yt, zt, p, Wu, Bs, at, trA2, slab,
                                  partA, partT, pans, B, Np, Mp, D, Np, G,
                                  kernel_id, stream);
    if (code != 0) return code;
  }
  gv_add_identity<<<rows, GP_THREADS, 0, st>>>(Bs, A0, Mp);
  code = (int)cudaGetLastError();
  if (code != 0) return code;
  code = gp_cholinv_launch(A0, WB, ldB, Uw, B, Mp, stream);
  if (code != 0) return code;
  gv_small_kernel<<<B, GP_THREADS, sizeof(float) * (3 * Mp + 32), st>>>(
      xt, yt, p, Wu, WB, at, trA2, ldB, dd, ev, scal, Np, Mp);
  code = (int)cudaGetLastError();
  if (code != 0) return code;
  gv_t1_kernel<<<tiles, GP_THREADS, 0, st>>>(WB, Bs, A0, Mp);
  gv_p_kernel<<<tiles, GP_THREADS, 0, st>>>(WB, A0, Uw, Bs, Mp);
  gv_t2_kernel<<<tiles, GP_THREADS, 0, st>>>(Bs, Wu, A0, Mp);
  code = (int)cudaGetLastError();
  if (code != 0) return code;
  {
    const dim3 grid = tiles;
    const size_t smem = 0;
    GP_DISPATCH(gv_kbar_uu_kernel, zt, p, Wu, A0, ev, partU, Mp, D)
    if (code != 0) return code;
  }
  {
    float* partG = ws + w.stream;
    float* pan = partG + b * (Np / GS_PW) * 8;
    code = gp_sgpr_stream2_launch(xt, yt, zt, p, Wu, Uw, dd, gout, partG, pan,
                                  B, Np, Mp, D, G, kernel_id, stream);
    if (code != 0) return code;
  }
  gv_finish_kernel<<<(B * 8 + 255) / 256, 256, 0, st>>>(scal, partU, gout,
                                                       out, B, nt);
  return (int)cudaGetLastError();
}
