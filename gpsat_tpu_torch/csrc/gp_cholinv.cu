// Batched Cholesky + full triangular inverse of masked SPD matrices, spread
// over many thread blocks per matrix, with an optional border of right-hand
// sides solved along the way.
//
// Replaces gpsat_tpu/ops/pallas_cholinv.py:_cholinv_kernel (:86), called
// through _cholinv_call (:162) by cholinv_batched (:189):
//   A  [B][M][M]  masked SPD input (padded rows/columns zero, unit diagonal);
//                 read only, never written
//   W  [B][M][M]  U^{-1}, upper triangular with exact zeros below the
//                 diagonal (A = U^T U)
//   ld [B]        sum log diag U = 0.5 log det A; NaN or -inf when a pivot is
//                 not positive, for that matrix only
//   ws [B][M][M]  workspace: A's upper tiles, factored in place into U
//                 (U_kk included), and U_kj^T in the mirror tile (j, k)
//                 below the diagonal
// M is a multiple of CI_T.
// The same schedule is the device routine of the exact-GPR kernels
// (gp_vg.cu, gp_value.cu, gp_predict.cu; pallas_gpr.py's
// _factor_tile_and_invert, :157), through gp_cholinv_kernel_launch: A is the
// masked noisy kernel matrix, rebuilt from the coordinates where step 0
// reads it, and a border of right-hand sides rides along to the right of it,
// as in the TPU kernels' bordered Cholesky:
//   z  [B][M]     the y column, solved into U^{-T} y by the diag and panel
//                 steps (a vector needs no tile of its own)
//   Z  [B][M][Pk] K* = sf2 phi(x_r, xp_c) m_r for prediction, built where it
//                 is read, solved into U^{-T} K* by a border step
// and W is formed only for the caller that asks for it (vg).
//
// Design. A right-looking blocked algorithm on CI_T x CI_T tiles (nt = M /
// CI_T tile columns); the launch enqueues a fixed sequence of launches on the
// caller's stream, every grid (matrices, tiles of the step):
//   for k = 0 .. nt-1:
//     diag    U_kk (and W_kk = U_kk^{-1} when W is asked for) and log diag
//             of the updated tile (k, k), one block per matrix: 32-row halves
//             factored on one warp in registers, the coupling blocks on all
//             eight warps; with z, z_k = U_kk^{-T} r_k on one more warp
//                                                                   grid B
//     border  Z_kj = U_kk^{-T} (K*_kj - sum_{q<k} U_qk^T Z_qj) for the
//             Pk/64 tiles of row k: left-looking, one full-depth product and
//             a triangular solve a tile                   grid B x Pk/64
//     panel   U_kj = U_kk^{-T} A_kj for j > k, a triangular solve; with z,
//             r_j -= U_kj^T z_k (r = y at k = 0)       grid B x (nt-k-1)
//     update  A_ij -= U_ki^T U_kj for k < i <= j          grid B x pairs
//   for d = 1 .. nt-1 (only when W is asked for):
//     inverse W_{i,i+d} = -W_ii sum_{i<q<=i+d} U_iq W_{q,i+d}
//                                                           grid B x (nt-d)
// (tiles of one offset d need only smaller offsets). Step 0 reads A where a
// later step reads ws, and the border step reads K*, so neither is stored
// beforehand. The step kernels take where they find A and K* as template
// parameters: a matrix in device memory (CiMatrix, gp_cholinv_launch, no
// border) or the kernel matrix and K* rebuilt entry by entry from the
// coordinates (CiKernel, CiBorderKernel): every upper tile of A and every
// tile of K* is read exactly once. The border is left-looking where the
// matrix is right-looking: a border tile is written once, where a
// right-looking border would read and write it again at every step, and y
// rides in the diag step where a 64-wide tile of its own would cost a launch
// and a 64-row solve a step (both measured slower on an H100: PERF.md). The
// update, the border's product and the inverse are products by
// gp_mma_pipe<64> (gp_common.cuh): 4x4 micro-tiles, float4 reads, the next
// 32-deep chunk in flight while this one is multiplied; the panel writes
// U_kj and its transpose, so that every product reads both operands along
// rows by cp.async. The sums run in a fixed order with no atomics: a second launch
// repeats the first bit for bit, and U, ld and z do not depend on W or K*
// (the value kernel and vg's value agree bit for bit). FP32 FMA on the CUDA
// cores.
// Bound on an H100: FP32 operations (2 M^3 / 3 per matrix against 8 M^2
// bytes; M^2 Pk more for the border). The critical path is nt diagonal
// steps, each two 32-column factorisations (with W, two 32 x 32 inverses;
// with z, a 64-row solve) on single warps, nt - 1 panel solves of 64
// dependent rows (and nt border solves), and 3 nt - 2 launches (nt more
// with K*, nt - 1 more with W).
#include <type_traits>

#include "gp_common.cuh"

#define CI_T 64           // tile edge
#define CI_LD (CI_T + 1)  // padded row stride of a tile in shared memory
#define CI_LU (CI_T + 4)  // row stride of U_kk in the panel: float4 reads

// Where a step finds entry (r, c) of matrix b: a [B][M][M] matrix in device
// memory (A at step 0 of gp_cholinv_launch, ws at every later step) ...
struct CiMatrix {
  const float* A;
  int M;
  __device__ __forceinline__ float operator()(int b, int r, int c) const {
    return A[((size_t)b * M + r) * M + c];
  }
};

// ... or the masked noisy kernel matrix of expert b, rebuilt from xs
// [B][8][M] (coordinates already divided by the lengthscales in rows
// 0..D-1, y in row 6, mask in row 7) and p [B][8] (sf2 @5, noise @6) as
// gp_vg.cu's gradient pass rebuilds it: sf2 phi(r2) m_r m_c, plus
// m_r (noise - 1) + 1 on the diagonal (a padded row factors to the
// identity).
template <int KID>
struct CiKernel {
  const float* xs;
  const float* p;
  int M, D;
  __device__ __forceinline__ float operator()(int b, int r, int c) const {
    const float* x = xs + (size_t)b * 8 * M;
    float r2 = 0.f;
    for (int d = 0; d < D; ++d) {
      const float dd = x[d * M + r] - x[d * M + c];
      r2 += dd * dd * gp_scale<KID>();
    }
    const float mr = x[7 * M + r];
    float v = p[(size_t)b * 8 + 5] * gp_phi<KID>(r2) * (mr * x[7 * M + c]);
    if (r == c) v += mr * (p[(size_t)b * 8 + 6] - 1.f) + 1.f;
    return v;
  }
};

// Where the border step finds entry (r, c) of matrix b's border B before it
// is solved: none (cholinv) ...
struct CiNoBorder {
  __device__ __forceinline__ float operator()(int, int, int) const {
    return 0.f;
  }
};

// ... or the exact-GPR border K*_rc = sf2 phi(x_r, xp_c) m_r rebuilt from
// the coordinates where the border step reads it (each tile once), xp
// [B][8][Pk] the scaled prediction coordinates.
template <int KID>
struct CiBorderKernel {
  const float* xs;
  const float* xp;
  const float* p;
  int M, Pk, D;
  __device__ __forceinline__ float operator()(int b, int r, int c) const {
    const float* x = xs + (size_t)b * 8 * M;
    const float* q = xp + (size_t)b * 8 * Pk;
    float r2 = 0.f;
    for (int d = 0; d < D; ++d) {
      const float dd = x[d * M + r] - q[d * Pk + c];
      r2 += dd * dd * gp_scale<KID>();
    }
    return p[(size_t)b * 8 + 5] * gp_phi<KID>(r2) * x[7 * M + r];
  }
};

// The y column of the border (none where z is null): y of matrix b at
// y[b ys + r]; z [B][M] = U^{-T} y, solved tile by tile by the diag steps;
// r [B][M] the residual y - U^T z of the rows below the step, kept by the
// panels.
struct CiRhs {
  const float* y;
  int ys;
  float* z;
  float* r;
};

template <typename Bsrc>
__host__ __device__ constexpr bool ci_bordered() {
  return !std::is_same<Bsrc, CiNoBorder>::value;
}

// Rows r0 .. r0+31 of the updated tile S (stride CI_LD) factored on one
// warp, right-looking, with lane j holding column r0 + j (and, with PANEL,
// column r0 + 32 + j) in registers: U_cc = sqrt(S_cc), U_cj = S_cj / U_cc,
// then S_ij -= U_ci U_cj for c < i. Writes U (zeros below the diagonal) back
// and returns sum log U_cc in every lane. A non-positive pivot gives NaN
// (or -inf), which spreads through this matrix's outputs only.
template <bool PANEL>
static __device__ float ci_chol32(float* S, int r0) {
  const int lane = threadIdx.x & 31;
  float a[32], b[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    a[i] = S[(r0 + i) * CI_LD + r0 + lane];
    if (PANEL) b[i] = S[(r0 + i) * CI_LD + r0 + 32 + lane];
  }
  float lsum = 0.f;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const float piv = sqrtf(__shfl_sync(0xffffffffu, a[c], c));
    const float u = lane == c ? piv : a[c] / piv;
    a[c] = u;
    if (PANEL) b[c] /= piv;
#pragma unroll
    for (int i = c + 1; i < 32; ++i) {
      const float ui = __shfl_sync(0xffffffffu, u, i);
      a[i] -= ui * u;
      if (PANEL) b[i] -= ui * b[c];
    }
    lsum += logf(piv);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    S[(r0 + i) * CI_LD + r0 + lane] = i <= lane ? a[i] : 0.f;
    if (PANEL) S[(r0 + i) * CI_LD + r0 + 32 + lane] = b[i];
  }
  return lsum;
}

// Wo = U^{-1} of the upper-triangular 32 x 32 block U (both stride CI_LD)
// on one warp, lane j solving U w = e_j in registers from the bottom row up:
// once w_i is final, its column of U is taken off the rows above, so the
// chain through the 32 rows is one multiply and one FMA a row (the
// reciprocals of the diagonal are formed first, all at once). Exact zeros
// below the diagonal.
static __device__ void ci_inv32(const float* U, float* Wo) {
  const int lane = threadIdx.x & 31;
  float w[32], rd[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    w[i] = i == lane ? 1.f : 0.f;
    rd[i] = 1.f / U[i * CI_LD + i];
  }
#pragma unroll
  for (int i = 31; i >= 0; --i) {
    w[i] = i <= lane ? w[i] * rd[i] : 0.f;
#pragma unroll
    for (int q = 0; q < i; ++q) w[q] -= U[q * CI_LD + i] * w[i];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) Wo[i * CI_LD + lane] = w[i];
}

// Step (a): factor (and, where W is non-null, invert) the updated diagonal
// tile (k, k) of `src` (A at k = 0, ws after), write U_kk to tile (k, k) of
// ws, W_kk to W and add its log diag to ld. The tile splits into 32 x 32
// blocks: warp 0 factors the top rows (U00, U01), all warps update S11 -=
// U01^T U01, warp 0 factors S11 while warp 1 inverts U00, then W11 and
// W01 = -W00 (U01 W11). One kernel for both (W a runtime choice), so that U
// and ld come out of the same instructions whether W is formed or not.
// Where rhs.z is non-null, the y column of the border rides along: warp 2
// solves U_kk^T z_k = r_k by forward substitution once U_kk is factored,
// lane l holding rows l and l + 32, beside warp 0's inverse; r_k is y_k at
// k = 0 and the residual the panels of the earlier steps left in rhs.r (see
// gp_cholinv_panel_kernel). A border of one column costs no launch of its
// own and no global traffic beyond its vectors.
template <typename Src>
__global__ void __launch_bounds__(GP_THREADS, 2)
gp_cholinv_diag_kernel(const Src src, float* W, float* ws, float* ld,
                       const CiRhs rhs, int M, int k) {
  const bool inv = W != nullptr;
  __shared__ float S[CI_T * CI_LD];   // the tile, then U_kk; U01 W11 below
  __shared__ float Wd[CI_T * CI_LD];  // W_kk
  __shared__ float lsum[2];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int r = tid >> 3, c0 = (tid & 7) * 4;  // a 32 x 32 block, 4 a thread
  const size_t off = (size_t)blockIdx.x * M * M + (size_t)k * CI_T * (M + 1);
  for (int e = tid; e < CI_T * CI_T; e += GP_THREADS) {
    const int i = e / CI_T, j = e % CI_T;
    S[i * CI_LD + j] = src(blockIdx.x, k * CI_T + i, k * CI_T + j);
    if (inv) Wd[i * CI_LD + j] = 0.f;
  }
  __syncthreads();
  if (warp == 0) {
    const float v = ci_chol32<true>(S, 0);
    if (tid == 0) lsum[0] = v;
  }
  __syncthreads();
  {  // S11 -= U01^T U01
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    for (int p = 0; p < 32; ++p) {
      const float u = S[p * CI_LD + 32 + r];
#pragma unroll
      for (int x = 0; x < 4; ++x) t[x] += u * S[p * CI_LD + 32 + c0 + x];
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) S[(32 + r) * CI_LD + 32 + c0 + x] -= t[x];
  }
  __syncthreads();
  if (warp == 0) {
    const float v = ci_chol32<false>(S, 32);
    if (tid == 0) lsum[1] = v;
  } else if (inv && warp == 1) {
    ci_inv32(S, Wd);
  }
  __syncthreads();
  if (inv && warp == 0) ci_inv32(S + 32 * CI_LD + 32, Wd + 32 * CI_LD + 32);
  if (rhs.z && warp == 2) {  // U_kk^T z_k = r_k by forward substitution
    const int lane = tid & 31, kT = k * CI_T;
    const float* re = k == 0 ? rhs.y + (size_t)blockIdx.x * rhs.ys + kT
                             : rhs.r + (size_t)blockIdx.x * M + kT;
    float v[2] = {re[lane], re[lane + 32]};
#pragma unroll
    for (int i = 0; i < CI_T; ++i) {
      const float zi =
          __shfl_sync(0xffffffffu, v[i >> 5], i & 31) / S[i * CI_LD + i];
      if (lane == (i & 31)) v[i >> 5] = zi;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (lane + 32 * h > i) v[h] -= S[i * CI_LD + lane + 32 * h] * zi;
    }
    float* ze = rhs.z + (size_t)blockIdx.x * M + kT;
    ze[lane] = v[0];
    ze[lane + 32] = v[1];
  }
  if (tid == 0) ld[blockIdx.x] = (k == 0 ? 0.f : ld[blockIdx.x]) + lsum[0] +
                                 lsum[1];
  // U_kk for the panel step; the lower-left block of S still holds A's
  for (int e = tid; e < CI_T * CI_T; e += GP_THREADS) {
    const int i = e / CI_T, j = e % CI_T;
    ws[off + (size_t)i * M + j] = i >= 32 && j < 32 ? 0.f : S[i * CI_LD + j];
  }
  if (!inv) return;
  __syncthreads();
  {  // U01 W11 into the free lower-left block of S
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q = 0; q < 32; ++q) {
      const float u = S[r * CI_LD + 32 + q];
#pragma unroll
      for (int x = 0; x < 4; ++x)
        t[x] += u * Wd[(32 + q) * CI_LD + 32 + c0 + x];
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) S[(32 + r) * CI_LD + c0 + x] = t[x];
  }
  __syncthreads();
  {  // W01 = -W00 (U01 W11)
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    for (int p = r; p < 32; ++p) {
      const float w = Wd[r * CI_LD + p];
#pragma unroll
      for (int x = 0; x < 4; ++x) t[x] += w * S[(32 + p) * CI_LD + c0 + x];
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) Wd[r * CI_LD + 32 + c0 + x] = -t[x];
  }
  __syncthreads();
  for (int e = tid; e < CI_T * CI_T; e += GP_THREADS) {
    const int i = e / CI_T, j = e % CI_T;
    W[off + (size_t)i * M + j] = Wd[i * CI_LD + j];
  }
}

// X <- U_kk^{-T} X for the 64 x 64 tile X (stride CI_LD) and U_kk in Uk
// (stride CI_LU) in shared memory, by forward substitution down the tile's
// rows, a triangular solve as LAPACK's trsm does it: multiplied by the
// explicit W_kk instead, the panel loses the accuracy of a matrix that is
// near singular in f32 (Kuu at long lengthscales: the collapsed bound came
// out hundreds of nats high). Lane 4c' + g of warp w holds rows 16g ..
// 16g+15 of column c = 8w + c' in registers; once row r is final, a shuffle
// hands it to the other three lanes of its column. Each column's arithmetic
// is its own. The caller synchronises before and after.
static __device__ __forceinline__ void ci_forward_subst(const float* Uk,
                                                        float* X) {
  const int lane = threadIdx.x & 31;
  const int c = (threadIdx.x >> 5) * 8 + (lane >> 2), g = lane & 3;
  float x[16];
#pragma unroll
  for (int q = 0; q < 16; ++q) x[q] = X[(16 * g + q) * CI_LD + c];
#pragma unroll
  for (int r = 0; r < CI_T; ++r) {
    if (g == (r >> 4)) x[r & 15] /= Uk[r * CI_LU + r];
    const float xr =
        __shfl_sync(0xffffffffu, x[r & 15], (lane & ~3) | (r >> 4));
    const float4* u4 =
        reinterpret_cast<const float4*>(Uk + r * CI_LU + 16 * g);
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float4 u = u4[h];
      const float uh[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int z = 0; z < 4; ++z)
        if (16 * g + 4 * h + z > r) x[4 * h + z] -= uh[z] * xr;
    }
  }
#pragma unroll
  for (int q = 0; q < 16; ++q) X[(16 * g + q) * CI_LD + c] = x[q];
}

// Step (b): U_kj = U_kk^{-T} A_kj (ci_forward_subst) into tile (k, j) of ws
// and its transpose into tile (j, k); j = k + 1 + blockIdx.y. In place when
// src is ws: the block reads its whole tile before it writes. Where rhs.z is
// non-null, the block also takes row k's part off the y column's residual
// on the rows of tile j, right-looking: r_j = (k == 0 ? y_j : r_j) -
// U_kj^T z_k, four threads a column over 16 rows each, the four parts in
// order (z_k is the diag step's, U_kj still in shared memory).
template <typename Src>
__global__ void __launch_bounds__(GP_THREADS)
gp_cholinv_panel_kernel(const Src src, const CiRhs rhs, float* ws, int M,
                        int k) {
  __shared__ __align__(16) float Uk[CI_T * CI_LU];  // U_kk
  __shared__ float X[CI_T * CI_LD];                  // A_kj, then U_kj
  __shared__ float zs[4][CI_T];                      // parts of U_kj^T z_k
  const int tid = threadIdx.x;
  const size_t off = (size_t)blockIdx.x * M * M;
  const int kT = k * CI_T, jT = (k + 1 + blockIdx.y) * CI_T;
  for (int e = tid; e < CI_T * CI_T; e += GP_THREADS) {
    const int i = e / CI_T, j = e % CI_T;
    Uk[i * CI_LU + j] = ws[off + (size_t)(kT + i) * M + kT + j];
    X[i * CI_LD + j] = src(blockIdx.x, kT + i, jT + j);
  }
  __syncthreads();
  ci_forward_subst(Uk, X);
  __syncthreads();
  for (int e = tid; e < CI_T * CI_T; e += GP_THREADS) {
    const int i = e / CI_T, j = e % CI_T;
    ws[off + (size_t)(kT + i) * M + jT + j] = X[i * CI_LD + j];
    ws[off + (size_t)(jT + i) * M + kT + j] = X[j * CI_LD + i];
  }
  if (rhs.z) {
    const int c = tid % CI_T, part = tid / CI_T;
    const float* zk = rhs.z + (size_t)blockIdx.x * M + kT + 16 * part;
    float a = 0.f;
#pragma unroll
    for (int q = 0; q < 16; ++q) a += X[(16 * part + q) * CI_LD + c] * zk[q];
    zs[part][c] = a;
    __syncthreads();
    if (tid < CI_T) {
      float* re = rhs.r + (size_t)blockIdx.x * M + jT + tid;
      const float base =
          k == 0 ? rhs.y[(size_t)blockIdx.x * rhs.ys + jT + tid] : *re;
      *re = base - (zs[0][tid] + zs[1][tid] + zs[2][tid] + zs[3][tid]);
    }
  }
}

// The border step k: border tile (k, j), j = blockIdx.y, of Z [B][M][Pk]
// <- U_kk^{-T} (K*_kj - sum_{q<k} U_qk^T Z_qj), left-looking: the rows of Z
// above k are final, so each border tile is read from `bsrc` once and
// written once, and its product runs to full depth k CI_T by
// gp_mma_pipe<64> (U_qk from the upper tiles of ws, column block k; Z_qj
// from rows 0 .. kT-1 of Z, both along rows by cp.async) instead of k
// read-modify-writes of depth 64. The stage of the product and the tiles of
// the solve share one buffer.
template <typename Bsrc>
__global__ void __launch_bounds__(GP_THREADS)
gp_cholinv_border_kernel(const Bsrc bsrc, const float* ws, float* Z, int M,
                         int Pk, int k) {
  constexpr int kSolve = CI_T * CI_LU + CI_T * CI_LD;
  constexpr int kStage = GP_PIPE_STAGE_FLOATS(CI_T);
  __shared__ __align__(16) float sm[kSolve > kStage ? kSolve : kStage];
  float* Uk = sm;               // U_kk, after the product
  float* X = sm + CI_T * CI_LU;  // K*_kj - sum U^T Z, then Z_kj
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t off = (size_t)blockIdx.x * M * M;
  const size_t offz = (size_t)blockIdx.x * M * Pk;
  const int kT = k * CI_T, jT = blockIdx.y * CI_T;
  float acc[4][4] = {};
  if (k > 0)  // synchronises the block before it returns
    gp_mma_pipe<CI_T, true, false>(acc, ws + off + kT, M, Z + offz + jT, Pk,
                                   kT, sm);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int r = gp_pipe_at(a, ty), c = gp_pipe_at(b, tx);
      X[r * CI_LD + c] = bsrc(blockIdx.x, kT + r, jT + c) - acc[a][b];
    }
  for (int e = tid; e < CI_T * CI_T; e += GP_THREADS) {
    const int i = e / CI_T, j = e % CI_T;
    Uk[i * CI_LU + j] = ws[off + (size_t)(kT + i) * M + kT + j];
  }
  __syncthreads();
  ci_forward_subst(Uk, X);
  __syncthreads();
  for (int e = tid; e < CI_T * CI_T; e += GP_THREADS) {
    const int i = e / CI_T, j = e % CI_T;
    Z[offz + (size_t)(kT + i) * Pk + jT + j] = X[i * CI_LD + j];
  }
}

// Step (c): tile (i, j) of ws <- tile (i, j) of src - U_ki^T U_kj for the
// blockIdx.y-th pair k < i <= j in row order.
template <typename Src>
__global__ void __launch_bounds__(GP_THREADS)
gp_cholinv_update_kernel(const Src src, float* ws, int M, int k, int nt) {
  __shared__ __align__(16) float stage[GP_PIPE_STAGE_FLOATS(CI_T)];
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t off = (size_t)blockIdx.x * M * M;
  int t = blockIdx.y, i = k + 1;
  while (t >= nt - i) {
    t -= nt - i;
    ++i;
  }
  const int kT = k * CI_T, iT = i * CI_T, jT = (i + t) * CI_T;
  float acc[4][4] = {};
  gp_mma_pipe<CI_T, true, false>(acc, ws + off + (size_t)kT * M + iT, M,
                                 ws + off + (size_t)kT * M + jT, M, CI_T,
                                 stage);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int r = iT + gp_pipe_at(a, ty), c = jT + gp_pipe_at(b, tx);
      ws[off + (size_t)r * M + c] = src(blockIdx.x, r, c) - acc[a][b];
    }
}

// The inverse at tile offset d: W_ij for i = blockIdx.y, j = i + d, from
// the U^T tiles below the diagonal of ws and the W tiles of smaller offsets;
// the block also writes the zeros of tile (j, i).
__global__ void __launch_bounds__(GP_THREADS)
gp_cholinv_inverse_kernel(const float* ws, float* W, int M, int d) {
  __shared__ __align__(16) float stage[GP_PIPE_STAGE_FLOATS(CI_T)];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t off = (size_t)blockIdx.x * M * M;
  const int iT = blockIdx.y * CI_T, jT = iT + d * CI_T;
  for (int e = tid; e < CI_T * CI_T; e += GP_THREADS)
    W[off + (size_t)(jT + e / CI_T) * M + iT + e % CI_T] = 0.f;

  // acc = sum_{i<q<=j} U_iq W_qj: column block i of ws holds U_iq^T in
  // rows (i+1)T .. (j+1)T - 1
  float acc[4][4] = {};
  gp_mma_pipe<CI_T, true, false>(acc, ws + off + (size_t)(iT + CI_T) * M + iT,
                                 M, W + off + (size_t)(iT + CI_T) * M + jT, M,
                                 d * CI_T, stage);
  // W_ij = -W_ii acc, with W_ii^T and acc in the stage
  float* WT = stage;               // W_ii^T, swizzled as gp_pipe_park does
  float* X = stage + CI_T * CI_T;  // X[p][c] = acc
  const float* Wii = W + off + (size_t)iT * M + iT;
  float4 v[CI_T / 32];
  gp_pipe_fetch<CI_T>(v, Wii, M, 0);
  gp_pipe_park<CI_T>(WT, v);
  gp_pipe_fetch<CI_T>(v, Wii, M, GP_PIPE_KC);
  gp_pipe_park<CI_T>(WT + GP_PIPE_KC * CI_T, v);
#pragma unroll
  for (int a = 0; a < 4; ++a)
    *reinterpret_cast<float4*>(X + (ty * 4 + a) * CI_T + tx * 4) =
        make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
  __syncthreads();
  float o[4][4] = {};
  for (int p = ty * 4; p < CI_T; ++p) {  // W_ii[r][p] = 0 for p < r
    const float4 w4 = *reinterpret_cast<const float4*>(
        WT + p * CI_T + ((ty * 4) ^ (p & 28)));
    const float4 x4 = *reinterpret_cast<const float4*>(X + p * CI_T + tx * 4);
    const float w[4] = {w4.x, w4.y, w4.z, w4.w};
    const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) o[a][b] += w[a] * x[b];
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      W[off + (size_t)(iT + ty * 4 + a) * M + jT + tx * 4 + b] = -o[a][b];
}

// Step k's launches, reading the updated tiles through `src`; W_kk only
// where W is asked for (non-null); the border step where Bsrc is a border.
template <typename Src, typename Bsrc>
static void ci_step(const Src& src, const Bsrc& bsrc, const CiRhs& rhs,
                    float* W, float* ld, float* ws, float* Z, int B, int M,
                    int Pk, int k, cudaStream_t st) {
  const int nt = M / CI_T, n = nt - k - 1;
  gp_cholinv_diag_kernel<<<B, GP_THREADS, 0, st>>>(src, W, ws, ld, rhs, M,
                                                   k);
  if constexpr (ci_bordered<Bsrc>())
    gp_cholinv_border_kernel<<<dim3(B, Pk / CI_T), GP_THREADS, 0, st>>>(
        bsrc, ws, Z, M, Pk, k);
  if (n > 0) {
    gp_cholinv_panel_kernel<<<dim3(B, n), GP_THREADS, 0, st>>>(src, rhs, ws,
                                                               M, k);
    gp_cholinv_update_kernel<<<dim3(B, n * (n + 1) / 2), GP_THREADS, 0, st>>>(
        src, ws, M, k, nt);
  }
}

// The launch sequence: step 0 reads A through `src`, later steps ws; every
// border step reads its row of the border through `bsrc`; then W = U^{-1}
// if W is non-null.
template <typename Src, typename Bsrc>
static int ci_launch(const Src& src, const Bsrc& bsrc, const CiRhs& rhs,
                     float* W, float* ld, float* ws, float* Z, int B, int M,
                     int Pk, cudaStream_t st) {
  const int nt = M / CI_T;
  for (int k = 0; k < nt; ++k) {
    if (k == 0) ci_step(src, bsrc, rhs, W, ld, ws, Z, B, M, Pk, k, st);
    else ci_step(CiMatrix{ws, M}, bsrc, rhs, W, ld, ws, Z, B, M, Pk, k, st);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (W)
    for (int d = 1; d < nt; ++d)
      gp_cholinv_inverse_kernel<<<dim3(B, nt - d), GP_THREADS, 0, st>>>(
          ws, W, M, d);
  return (int)cudaGetLastError();
}

extern "C" int gp_cholinv_launch(const float* A, float* W, float* ld,
                                 float* ws, int B, int M, void* stream) {
  return ci_launch(CiMatrix{A, M}, CiNoBorder{},
                   CiRhs{nullptr, 0, nullptr, nullptr}, W, ld, ws, nullptr, B,
                   M, 0, (cudaStream_t)stream);
}

template <int KID>
static int ci_kernel_launch(const float* xs, const float* xp, const float* p,
                            float* W, float* ld, float* ws, float* Z,
                            float* z, int B, int M, int Pk, int D,
                            cudaStream_t st) {
  const CiKernel<KID> src{xs, p, M, D};
  const CiRhs rhs{xs + 6 * M, 8 * M, z, z ? z + (size_t)B * M : nullptr};
  if (Z && Pk > 0)
    return ci_launch(src, CiBorderKernel<KID>{xs, xp, p, M, Pk, D}, rhs, W,
                     ld, ws, Z, B, M, Pk, st);
  return ci_launch(src, CiNoBorder{}, rhs, W, ld, ws, nullptr, B, M, 0, st);
}

// The factor of the masked noisy kernel matrices of scaled exact-GPR inputs
// (xs [B][8][M] with y in row 6, p [B][8], see CiKernel), never stored:
// U in ws as gp_cholinv_launch's and ld = 0.5 log det K; W = U^{-1} where W
// is non-null; z [B][M] = U^{-T} y where z is non-null (z has 2 B M floats:
// the residual of the panels follows it); and, where Z is
// non-null and Pk > 0, the border Z [B][M][Pk] = U^{-T} K* (K* from xp
// [B][8][Pk], see CiBorderKernel; Pk a multiple of CI_T).
extern "C" int gp_cholinv_kernel_launch(const float* xs, const float* xp,
                                        const float* p, float* W, float* ld,
                                        float* ws, float* Z, float* z, int B,
                                        int M, int Pk, int D, int kernel_id,
                                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (kernel_id) {
    case GP_MATERN12:
      return ci_kernel_launch<GP_MATERN12>(xs, xp, p, W, ld, ws, Z, z, B, M,
                                           Pk, D, st);
    case GP_MATERN32:
      return ci_kernel_launch<GP_MATERN32>(xs, xp, p, W, ld, ws, Z, z, B, M,
                                           Pk, D, st);
    case GP_MATERN52:
      return ci_kernel_launch<GP_MATERN52>(xs, xp, p, W, ld, ws, Z, z, B, M,
                                           Pk, D, st);
    case GP_RBF:
      return ci_kernel_launch<GP_RBF>(xs, xp, p, W, ld, ws, Z, z, B, M, Pk, D,
                                      st);
    case GP_EXPONENTIAL:
      return ci_kernel_launch<GP_EXPONENTIAL>(xs, xp, p, W, ld, ws, Z, z, B,
                                              M, Pk, D, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
