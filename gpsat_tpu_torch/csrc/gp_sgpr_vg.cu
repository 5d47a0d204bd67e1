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
//                           unit diagonal on padded rows  grid (B, Mp/32)
//   P2  gp_cholinv_launch   W_u = U_u^{-1}                   grid (B)
//   P3  gp_sgpr_stream1_launch  Bsum = A~A~^T/s2, a~, |A~|^2 grids (G),
//                           (tile pairs, B), (B)
//   P4  gv_add_identity, gp_cholinv_launch  B = I + Bsum -> W_B, log det
//   P5  gv_c_kernel, gv_upper_matvec_kernel (twice), gv_scalars_kernel
//                           c = a~^T W_B with |W_B|_F^2, dd = W_B c =
//                           B^{-1} a~ with a~.dd and dd.dd, e = W_u dd, by
//                           64-row or 64-column tiles   grids (B, Mp/64);
//                           then the value and d/ds2 (P8) from vectors and
//                           the tiles' partials                 grid (B)
//   P6  gv_t1/gv_p/gv_t2/gv_kbar_uu  the M^3-sized products on
//                           gp_mma_pipe<64>, one 64 x 64 tile a block, the
//                           deepest tiles first     grid (B, Mp/64, Mp/64);
//                           Kbar_uu's reductions over the upper tile pairs
//                           only                        grid (B, pairs)
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

// P1: one warp per row of Kuu, GV_KR rows a block, grid (B, Mp/GV_KR); the
// block first stages every column's z / ls and mask in shared memory. The
// other two routes build Kuu in torch (ops/cuda_sgpr._kuu), one rounding per
// operation. With jitter 1e-6 and a few hundred inducing points Kuu sits at
// the edge of what f32 can factor, so whether a pivot stays positive can
// turn on the last bit of an entry: the intrinsics below keep the compiler
// from contracting a multiply and an add into one fused operation, so that
// every route factors the same matrix (a staged quotient is the quotient
// each entry computed before: IEEE division rounds the same anywhere).
#define GV_KR 32  // rows of Kuu a block
template <int KID>
__global__ void __launch_bounds__(GP_THREADS)
gv_kuu_kernel(const float* zt, const float* p, float* Kuu, int Mp, int D,
              float jitter) {
  __shared__ float zs[5][1024], zm[1024];  // Mp <= 1024 (the gate)
  const int e = blockIdx.x, lane = threadIdx.x & 31;
  const float* ze = zt + (size_t)e * 8 * Mp;
  const float* pe = p + (size_t)e * 8;
  const float sf2 = pe[5], scale = gp_scale<KID>();
  for (int c = threadIdx.x; c < Mp; c += GP_THREADS) {
    for (int d = 0; d < D; ++d) zs[d][c] = ze[d * Mp + c] / pe[d];
    zm[c] = ze[7 * Mp + c];
  }
  __syncthreads();
  for (int r = blockIdx.y * GV_KR + (threadIdx.x >> 5);
       r < (blockIdx.y + 1) * GV_KR; r += GP_THREADS / 32) {
    const float zmr = zm[r];
    float* row = Kuu + ((size_t)e * Mp + r) * Mp;
    for (int c = lane; c < Mp; c += 32) {
      float r2 = 0.f;
      for (int d = 0; d < D; ++d) {
        const float df = __fsub_rn(zs[d][r], zs[d][c]);
        const float sq = __fmul_rn(df, df);
        r2 = d == 0 ? sq : __fadd_rn(r2, sq);
      }
      const float k =
          __fmul_rn(__fmul_rn(sf2, gp_phi<KID>(__fmul_rn(r2, scale))),
                    __fmul_rn(zmr, zm[c]));
      const float diag = __fadd_rn(__fmul_rn(zmr, jitter - 1.f), 1.f);
      row[c] = r == c ? __fadd_rn(k, diag) : k;
    }
  }
}

// P4: Bm = I + Bsum, one warp per row (four columns a lane at a time),
// grid (B, Mp/8).
__global__ void __launch_bounds__(GP_THREADS)
gv_add_identity(const float* Bsum, float* Bm, int Mp) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.y * (GP_THREADS / 32) + (threadIdx.x >> 5);
  const size_t o = ((size_t)blockIdx.x * Mp + r) * Mp;
  for (int c = 4 * lane; c < Mp; c += 128) {
    float4 v = *reinterpret_cast<const float4*>(Bsum + o + c);
    v.x += r == c ? 1.f : 0.f;
    v.y += r == c + 1 ? 1.f : 0.f;
    v.z += r == c + 2 ? 1.f : 0.f;
    v.w += r == c + 3 ? 1.f : 0.f;
    *reinterpret_cast<float4*>(Bm + o + c) = v;
  }
}

// P5: the M-sized rows and, in (d), the scalars (P8). W_B and W_u are upper
// triangular with exact zeros below the diagonal. Every launch but (d) has a
// block per 64-row or 64-column tile of every expert; partS [B][Mp/64][4]
// holds each tile's shares of |W_B|_F^2 (lane 0), a~.dd (1) and dd.dd (2).
#define GV_VT 64  // row / column tile of the P5 matvecs

// P5 (a): c = a~^T W_B, c_j = sum_{q <= j} a~_q W_B[q][j], by 64-column
// tiles, and the tile's share of |W_B|_F^2 taken from the entries it reads
// (the rows q <= j of its columns hold every nonzero of W_B). Block (e, t):
// thread (g, l) = (tid / 64, tid % 64) takes rows g, g + 4, ... of column
// jT + l, so each warp reads 128 contiguous bytes of a row; the four row
// groups are added in order.
__global__ void __launch_bounds__(GP_THREADS)
gv_c_kernel(const float* WB, const float* at, float* c, float* partS,
            int Mp) {
  __shared__ float rc[GP_THREADS / GV_VT][GV_VT], red[32];
  const int e = blockIdx.x, tid = threadIdx.x;
  const int g = tid / GV_VT, l = tid % GV_VT, j = blockIdx.y * GV_VT + l;
  const float* W = WB + (size_t)e * Mp * Mp;
  const float* a = at + (size_t)e * Mp;
  float s = 0.f, w2 = 0.f;
  for (int q = g; q <= j; q += GP_THREADS / GV_VT) {
    const float w = W[(size_t)q * Mp + j];
    s += a[q] * w;
    w2 += w * w;
  }
  rc[g][l] = s;
  w2 = gp_block_sum(w2, red);  // its barriers publish rc
  if (tid < GV_VT)
    c[(size_t)e * Mp + j] = ((rc[0][l] + rc[1][l]) + rc[2][l]) + rc[3][l];
  if (tid == 0) partS[((size_t)e * gridDim.y + blockIdx.y) * 4] = w2;
}

// P5 (b), (c): out = W v for an upper triangular W, out_i = sum_{q >= i}
// W[i][q] v_q, by 64-row tiles: in block (e, t) warp w takes rows iT + w,
// iT + w + 8, ..., its lanes the columns i + lane, i + lane + 32, ... in
// order (rows read coalesced), added across the lanes by gp_warp_sum. With
// `at` given (dd = W_B c), the tile's shares of a~.dd and dd.dd go to partS
// lanes 1 and 2, its rows added in order.
__global__ void __launch_bounds__(GP_THREADS)
gv_upper_matvec_kernel(const float* W, const float* v, float* out,
                       const float* at, float* partS, int Mp) {
  __shared__ float v_s[1024], o_s[GV_VT];  // Mp <= 1024 (the gate)
  const int e = blockIdx.x, iT = blockIdx.y * GV_VT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* We = W + (size_t)e * Mp * Mp;
  for (int q = iT + threadIdx.x; q < Mp; q += GP_THREADS)
    v_s[q] = v[(size_t)e * Mp + q];
  __syncthreads();
  for (int r = warp; r < GV_VT; r += GP_THREADS / 32) {
    const int i = iT + r;
    float a = 0.f;
    for (int q = i + lane; q < Mp; q += 32)
      a += We[(size_t)i * Mp + q] * v_s[q];
    a = gp_warp_sum(a);
    if (lane == 0) {
      out[(size_t)e * Mp + i] = a;
      o_s[r] = a;
    }
  }
  if (at == nullptr) return;
  __syncthreads();
  if (warp == 0) {
    float x = 0.f, y = 0.f;
    for (int r = lane; r < GV_VT; r += 32) {
      x += at[(size_t)e * Mp + iT + r] * o_s[r];
      y += o_s[r] * o_s[r];
    }
    x = gp_warp_sum(x);
    y = gp_warp_sum(y);
    if (lane == 0) {
      float* o = partS + ((size_t)e * gridDim.y + blockIdx.y) * 4;
      o[1] = x;
      o[2] = y;
    }
  }
}

// P5 (d) and P8: the scalars of each expert from vectors and partS (nv tiles
// added in order), one block per expert:
//   scal[e][0] = value, [1] = d/ds2, [2] = the trKff term of d/dlog sf2
// The constant M of d/ds2 is the padded one: tr B^{-1} and M cancel row by
// row on the padded inducing rows.
__global__ void __launch_bounds__(GP_THREADS)
gv_scalars_kernel(const float* xt, const float* yt, const float* p,
                  const float* trA2, const float* ldB, const float* partS,
                  float* scal, int Np, int nv) {
  __shared__ float red[32];
  const int e = blockIdx.x, tid = threadIdx.x;
  float ydoty = 0.f, n = 0.f;
  for (int i = tid; i < Np; i += GP_THREADS) {
    const float y = yt[(size_t)e * Np + i];
    ydoty += y * y;
    n += xt[((size_t)e * 8 + 7) * Np + i];
  }
  ydoty = gp_block_sum(ydoty, red);
  n = gp_block_sum(n, red);
  if (tid == 0) {
    float trb = 0.f, atdd = 0.f, dddd = 0.f;
    for (int t = 0; t < nv; ++t) {
      const float* s = partS + ((size_t)e * nv + t) * 4;
      trb += s[0];
      atdd += s[1];
      dddd += s[2];
    }
    const float sf2 = p[(size_t)e * 8 + 5], s2 = p[(size_t)e * 8 + 6];
    const float tA = trA2[e];
    float* o = scal + (size_t)e * 4;
    o[0] = 0.5f * n * 1.8378770664093453f + ldB[e] + 0.5f * n * logf(s2) +
           0.5f * ydoty / s2 - 0.5f * atdd / (s2 * s2) +
           0.5f * (sf2 * n - tA) / s2;
    o[1] = 0.5f / s2 * (n - (float)(nv * GV_VT) + trb) -
           0.5f / (s2 * s2) * (ydoty - atdd / s2 - dddd / s2) -
           0.5f / (s2 * s2) * (sf2 * n - tA);
    o[2] = 0.5f * sf2 * n / s2;
    o[3] = 0.f;
  }
}

// The P6 products, each a GV_T x GV_T output tile a block through
// gp_mma_pipe<GV_T>, skipping the zero half of the triangular operand. A grid
// (B, nt, nt) of a full product runs the expert fastest and ranks the tiles
// by depth in z, the slowest index, so the deepest tiles are issued first
// and the shallow ones fill the last wave. GV_T = 64 (4x4 micro-tiles, three
// or four blocks an SM): measured on an H100 against 128-tiles (8x8
// micro-tiles, one block an SM) with each edge forced, the 64-tiles win at
// every Mp <= 512 and every B from 4 to 128 (PERF.md section 6), and every
// SGPR configuration of the repo has Mp = 512; 128-tiles won by 2-12 % only
// at Mp >= 768.
#define GV_T 64
// the stage of gp_mma_pipe<GV_T>, 32 KiB: static, under the 48 KiB a block
// gets without opting in
#define GV_STAGE \
  __shared__ __align__(16) float stage[GP_PIPE_STAGE_FLOATS(GV_T)]

// Tile (iT, jT) of a [Mp][Mp] matrix X <- acc, four adjacent columns a
// float4.
static __device__ __forceinline__ void gv_store(
    float* X, int Mp, int iT, int jT,
    const float (&acc)[GV_T / 16][GV_T / 16]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int a = 0; a < GV_T / 16; ++a)
    *reinterpret_cast<float4*>(X + (size_t)(iT + gp_pipe_at(a, ty)) * Mp +
                               jT + gp_pipe_at(0, tx)) =
        make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
}

// T1 = W_B^T Bsum: T1[i][j] = sum_{q <= i} W_B[q][i] Bsum[q][j]; tile row
// iT = (nt - 1 - z) GV_T, depth iT + GV_T.
__global__ void __launch_bounds__(GP_THREADS)
gv_t1_kernel(const float* WB, const float* Bsum, float* T1, int Mp) {
  GV_STAGE;
  float acc[GV_T / 16][GV_T / 16] = {};
  const int iT = (gridDim.z - 1 - blockIdx.z) * GV_T, jT = blockIdx.y * GV_T;
  const size_t off = (size_t)blockIdx.x * Mp * Mp;
  gp_mma_pipe<GV_T, true, false>(acc, WB + off + iT, Mp, Bsum + off + jT,
                                 Mp, iT + GV_T, stage);
  gv_store(T1 + off, Mp, iT, jT, acc);
}

// P = W_B T1 = B^{-1} Bsum: P[i][j] = sum_{q >= i} W_B[i][q] T1[q][j]; tile
// row iT = z GV_T, depth Mp - iT. Bsum becomes C = Bsum - P in place (no other
// block reads this tile).
__global__ void __launch_bounds__(GP_THREADS)
gv_p_kernel(const float* WB, const float* T1, float* Pm, float* BsumC,
            int Mp) {
  GV_STAGE;
  float acc[GV_T / 16][GV_T / 16] = {};
  const int iT = blockIdx.z * GV_T, jT = blockIdx.y * GV_T;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t off = (size_t)blockIdx.x * Mp * Mp;
  gp_mma_pipe<GV_T, false, false>(acc, WB + off + (size_t)iT * Mp + iT, Mp,
                                  T1 + off + (size_t)iT * Mp + jT, Mp,
                                  Mp - iT, stage);
#pragma unroll
  for (int a = 0; a < GV_T / 16; ++a) {
    const size_t o =
        off + (size_t)(iT + gp_pipe_at(a, ty)) * Mp + jT + gp_pipe_at(0, tx);
    const float4 pv = make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    float4 cv = *reinterpret_cast<const float4*>(BsumC + o);
    cv.x -= pv.x;
    cv.y -= pv.y;
    cv.z -= pv.z;
    cv.w -= pv.w;
    *reinterpret_cast<float4*>(Pm + o) = pv;
    *reinterpret_cast<float4*>(BsumC + o) = cv;
  }
}

// T2 = C W_u^T: T2[i][j] = sum_{q >= j} C[i][q] W_u[j][q]; tile column
// jT = z GV_T, depth Mp - jT.
__global__ void __launch_bounds__(GP_THREADS)
gv_t2_kernel(const float* C, const float* Wu, float* T2, int Mp) {
  GV_STAGE;
  float acc[GV_T / 16][GV_T / 16] = {};
  const int iT = blockIdx.y * GV_T, jT = blockIdx.z * GV_T;
  const size_t off = (size_t)blockIdx.x * Mp * Mp;
  gp_mma_pipe<GV_T, false, true>(acc, C + off + (size_t)iT * Mp + jT, Mp,
                                 Wu + off + (size_t)jT * Mp + jT, Mp,
                                 Mp - jT, stage);
  gv_store(T2 + off, Mp, iT, jT, acc);
}

// Kbar_uu tile (i, j), j >= i, = 0.5 [W_u T2 + e e^T / s2^2], reduced on the
// fly against sf2 phi and sf2 F q2_d of Kuu (elementwise, never the rank-1
// expansion) into partU [B][npairs][8]: lanes 1..D the uu part of d/dlog
// ls_d, lane 6 the uu part of d/dlog sf2, weight 2 off the diagonal (Kbar_uu
// and dKuu are symmetric). Grid (B, npairs): y is the pair's index among the
// upper pairs in row order, so rows i = 0, 1, ... (depth Mp - iT) come
// deepest first and no block is idle.
template <int KID>
__global__ void __launch_bounds__(GP_THREADS)
gv_kbar_uu_kernel(const float* zt, const float* p, const float* Wu,
                  const float* T2, const float* ev, float* partU, int Mp,
                  int D) {
  GV_STAGE;
  __shared__ float zr[5][GV_T], zc[5][GV_T], mr[GV_T], mc[GV_T], er[GV_T],
      ec[GV_T], red[32];
  float acc[GV_T / 16][GV_T / 16] = {};
  const int e = blockIdx.x, nt = Mp / GV_T, tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  int t = blockIdx.y, i = 0;
  while (t >= nt - i) {
    t -= nt - i;
    ++i;
  }
  const int iT = i * GV_T, jT = (i + t) * GV_T;
  const size_t off = (size_t)e * Mp * Mp;
  const float* ze = zt + (size_t)e * 8 * Mp;
  const float* pe = p + (size_t)e * 8;
  const float sf2 = pe[5], inv_s4 = 1.f / (pe[6] * pe[6]);
  const float scale = gp_scale<KID>();
  if (tid < GV_T) {
    for (int d = 0; d < D; ++d) {
      zr[d][tid] = ze[d * Mp + iT + tid] / pe[d];
      zc[d][tid] = ze[d * Mp + jT + tid] / pe[d];
    }
    mr[tid] = ze[7 * Mp + iT + tid];
    mc[tid] = ze[7 * Mp + jT + tid];
    er[tid] = ev[(size_t)e * Mp + iT + tid];
    ec[tid] = ev[(size_t)e * Mp + jT + tid];
  }
  // W_u T2: sum_{q >= i} W_u[i][q] T2[q][j] (gp_mma_pipe synchronises the
  // block before the rows staged above are read)
  gp_mma_pipe<GV_T, false, false>(acc, Wu + off + (size_t)iT * Mp + iT, Mp,
                                  T2 + off + (size_t)iT * Mp + jT, Mp,
                                  Mp - iT, stage);
  const float wsym = (iT == jT) ? 1.f : 2.f;
  float gls[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  float gsf2 = 0.f;
#pragma unroll
  for (int a = 0; a < GV_T / 16; ++a) {
    const int r = gp_pipe_at(a, ty);
#pragma unroll
    for (int b = 0; b < GV_T / 16; ++b) {
      const int c = gp_pipe_at(b, tx);
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
    float* o = partU + ((size_t)e * gridDim.y + blockIdx.y) * 8;
    o[0] = 0.f;
    for (int d = 0; d < 5; ++d) o[1 + d] = d < D ? wsym * gls[d] : 0.f;
    o[6] = wsym * gsf2;
    o[7] = 0.f;
  }
}

// out [B][8] <- value and d/ds2 from scal, the uu partials of the npairs
// upper tile pairs added in order, the uf lanes of the second streamed pass
// and the trKff term.
__global__ void gv_finish_kernel(const float* scal, const float* partU,
                                 const float* gout, float* out, int B,
                                 int npairs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * 8) return;
  const int e = i / 8, l = i % 8;
  if (l == 0 || l == 7) {
    out[i] = scal[(size_t)e * 4 + (l == 0 ? 0 : 1)];
    return;
  }
  float t = 0.f;
  for (int a = 0; a < npairs; ++a) t += partU[((size_t)e * npairs + a) * 8 + l];
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
  size_t at, c, dd, ev;     // [B][Mp]
  size_t trA2, ldu, ldB;    // [B]
  size_t scal;              // [B][4]
  size_t gout;              // [B][8]
  size_t partS;             // [B][Mp/64][4]
  size_t partU;             // [B][npairs][8]
  size_t stream;            // the streamed passes' partials and panels
  size_t floats;            // the whole
};

static GvWorkspace gv_layout(int B, int Np, int Mp, int G) {
  const size_t b = B, m = Mp, m2 = m * m, nv = m / GV_VT, nt = m / GV_T;
  const size_t np = Np / GS_PW, g = G;
  GvWorkspace w;
  size_t q = 0;
  w.A0 = q; q += b * m2;
  w.Wu = q; q += b * m2;
  w.Uw = q; q += b * m2;
  w.Bs = q; q += b * m2;
  w.WB = q; q += b * m2;
  w.at = q; q += b * m;
  w.c = q; q += b * m;
  w.dd = q; q += b * m;
  w.ev = q; q += b * m;
  w.trA2 = q; q += b;
  w.ldu = q; q += b;
  w.ldB = q; q += b;
  w.scal = q; q += b * 4;
  w.gout = q; q += b * 8;
  w.partS = q; q += b * nv * 4;
  w.partU = q; q += b * nt * (nt + 1) / 2 * 8;
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
  const int nt = Mp / GV_T, npairs = nt * (nt + 1) / 2;
  const dim3 vtiles(B, Mp / GV_VT), tiles(B, nt, nt);
  float *A0 = ws + w.A0, *Wu = ws + w.Wu, *Uw = ws + w.Uw, *Bs = ws + w.Bs,
        *WB = ws + w.WB, *at = ws + w.at, *cv = ws + w.c, *dd = ws + w.dd,
        *ev = ws + w.ev, *trA2 = ws + w.trA2, *ldu = ws + w.ldu,
        *ldB = ws + w.ldB, *scal = ws + w.scal, *gout = ws + w.gout,
        *partS = ws + w.partS, *partU = ws + w.partU;
  int code;
  {
    const dim3 grid(B, Mp / GV_KR);
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
  gv_add_identity<<<dim3(B, Mp / (GP_THREADS / 32)), GP_THREADS, 0, st>>>(
      Bs, A0, Mp);
  code = (int)cudaGetLastError();
  if (code != 0) return code;
  code = gp_cholinv_launch(A0, WB, ldB, Uw, B, Mp, stream);
  if (code != 0) return code;
  gv_c_kernel<<<vtiles, GP_THREADS, 0, st>>>(WB, at, cv, partS, Mp);
  gv_upper_matvec_kernel<<<vtiles, GP_THREADS, 0, st>>>(WB, cv, dd, at,
                                                        partS, Mp);
  gv_upper_matvec_kernel<<<vtiles, GP_THREADS, 0, st>>>(Wu, dd, ev, nullptr,
                                                        partS, Mp);
  gv_scalars_kernel<<<B, GP_THREADS, 0, st>>>(xt, yt, p, trA2, ldB, partS,
                                              scal, Np, Mp / GV_VT);
  code = (int)cudaGetLastError();
  if (code != 0) return code;
  // P6: T1 into A0, P into Uw and C into Bs, T2 into A0, then Kbar_uu's
  // partials
  gv_t1_kernel<<<tiles, GP_THREADS, 0, st>>>(WB, Bs, A0, Mp);
  gv_p_kernel<<<tiles, GP_THREADS, 0, st>>>(WB, A0, Uw, Bs, Mp);
  gv_t2_kernel<<<tiles, GP_THREADS, 0, st>>>(Bs, Wu, A0, Mp);
  code = (int)cudaGetLastError();
  if (code != 0) return code;
  {
    const dim3 grid(B, npairs);
    const size_t smem = 0;
    GP_DISPATCH(gv_kbar_uu_kernel, zt, p, (const float*)Wu, (const float*)A0,
                (const float*)ev, partU, Mp, D)
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
                                                       out, B, npairs);
  return (int)cudaGetLastError();
}
