// Device code shared by the exact-GPR kernels (gp_vg.cu, gp_predict.cu).
//
// Replaces the shared pieces of gpsat_tpu/ops/pallas_gpr.py: the correlation
// functions _phi / _phi_grad (:64, :80) and the blocked factor + inverse
// routine _factor_tile_and_invert (:157) together with the off-diagonal
// W = U^{-1} block recurrence that _vg_kernel and _predict_kernel both run.
//
// Layout (per expert, one thread block of GP_THREADS threads):
//   * the wrapper hands each block a workspace in device memory, row-major
//     with leading dimension `ld`: U (A = U^T U, upper tiles only) at column
//     offset 0 and W = U^{-1} (upper tiles only) at column offset Np. A 512x512
//     f32 factor is 1 MiB, far beyond the 227 KB of shared memory an SM has,
//     so the matrices live in device memory (mostly L2) and only GP_T x GP_T
//     tiles are staged through shared memory.
//   * the masked kernel matrix A is never stored: each tile of it is rebuilt
//     from the coordinates in shared memory when the left-looking Cholesky
//     reaches it.
//   * every product is a GP_T x GP_T output tile accumulated over a
//     multiple of GP_T by `tile_mma`; each thread owns a 2x2 micro-tile.
//
// What bounds it on an H100: FP32 operations (the vg kernel does ~N^3 flops
// per expert against ~20 N bytes of input). This first version runs on the
// CUDA cores at a low share of the FP32 peak: the tile products are
// shared-memory bound and the 32x32 diagonal factor runs on one warp.
#pragma once

#include <cuda_runtime.h>

#define GP_T 32             // tile edge
#define GP_TS 33            // padded shared-memory row stride of a tile
#define GP_THREADS 256      // threads per block (8 warps)
#define GP_TILE_ELEMS (GP_T * GP_TS)

// kernel ids: the order of cuda_gpr._KERNEL_IDS
enum GpKernelId { GP_MATERN12 = 0, GP_MATERN32 = 1, GP_MATERN52 = 2,
                  GP_RBF = 3, GP_EXPONENTIAL = 4 };

template <int KID>
__device__ __forceinline__ float gp_scale() {
  return KID == GP_MATERN32 ? 3.f : (KID == GP_MATERN52 ? 5.f : 1.f);
}

// correlation phi(r2), r2 already carrying the kernel's scale factor
template <int KID>
__device__ __forceinline__ float gp_phi(float r2) {
  const float r = sqrtf(fmaxf(r2, 1e-36f));
  if (KID == GP_MATERN12) return expf(-r);
  if (KID == GP_MATERN32) return (1.f + r) * expf(-r);
  if (KID == GP_MATERN52) return (1.f + r + r * r * (1.f / 3.f)) * expf(-r);
  if (KID == GP_RBF) return expf(-0.5f * r2);
  return expf(-0.5f * r);  // Exponential
}

// F(r2) with d phi / d log ls_j = F * q2_j (q2_j includes the scale factor)
template <int KID>
__device__ __forceinline__ float gp_phi_grad(float r2) {
  const float r = sqrtf(fmaxf(r2, 1e-36f));
  if (KID == GP_MATERN12) return expf(-r) / r;
  if (KID == GP_MATERN32) return expf(-r);
  if (KID == GP_MATERN52) return (1.f + r) * (1.f / 3.f) * expf(-r);
  if (KID == GP_RBF) return expf(-0.5f * r2);
  return expf(-0.5f * r) / (2.f * r);  // Exponential
}

// Views into the block's dynamic shared memory.
struct GpShared {
  float* As;     // [GP_T][GP_TS] tile_mma operand A (transposed: As[p][r])
  float* Bs;     // [GP_T][GP_TS] tile_mma operand B (Bs[p][c])
  float* St;     // [GP_T][GP_TS] diagonal tile being factored
  float* Wt;     // [GP_T][GP_TS] inverse of the current diagonal tile
  float* Ct;     // [GP_T][GP_TS] staging tile
  float* red;    // [16][GP_TS] reductions
  float* scal;   // [32] scalars (scal[0] = log det)
  float* xs;     // [D][Np] coordinates / lengthscales
  float* m;      // [Np] float mask
  float* y;      // [Np] masked observations
  float* t1;     // [Np] W^T y
  float* alpha;  // [Np] W W^T y
  float* xp;     // [D][Pp] prediction coordinates / lengthscales (predict)
};

// floats of dynamic shared memory for D dims, Np data and Pp prediction
// points; the host computes the same number (gp_smem_bytes)
static inline __host__ __device__ int gp_smem_floats(int D, int Np, int Pp) {
  return 6 * GP_TILE_ELEMS + 32 + (D + 4) * Np + D * Pp;
}

static __device__ __forceinline__ GpShared gp_carve(float* sm, int D, int Np) {
  GpShared s;
  s.As = sm;
  s.Bs = s.As + GP_TILE_ELEMS;
  s.St = s.Bs + GP_TILE_ELEMS;
  s.Wt = s.St + GP_TILE_ELEMS;
  s.Ct = s.Wt + GP_TILE_ELEMS;
  s.red = s.Ct + GP_TILE_ELEMS;
  s.scal = s.red + GP_TILE_ELEMS;
  s.xs = s.scal + 32;
  s.m = s.xs + D * Np;
  s.y = s.m + Np;
  s.t1 = s.y + Np;
  s.alpha = s.t1 + Np;
  s.xp = s.alpha + Np;
  return s;
}

// Stage one expert's inputs: xt [8][Np] (dims 0..D-1, mask in row 7),
// yt [Np], p [8] (ls_0..ls_{D-1}, sf2 @5, noise @6).
static __device__ __forceinline__ void gp_stage(const GpShared& s,
                                                const float* xt,
                                                const float* yt,
                                                const float* p, int D,
                                                int Np) {
  for (int i = threadIdx.x; i < Np; i += GP_THREADS) {
    for (int d = 0; d < D; ++d) s.xs[d * Np + i] = xt[d * Np + i] / p[d];
    s.m[i] = xt[7 * Np + i];
    s.y[i] = yt[i];
  }
  if (threadIdx.x == 0) s.scal[0] = 0.f;
  __syncthreads();
}

static __device__ __forceinline__ float gp_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block; the result is valid in every thread.
static __device__ float gp_block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = gp_warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < GP_THREADS / 32 ? red[lane] : 0.f;
  t = gp_warp_sum(t);
  return t;
}

// acc (this thread's 2x2 micro-tile of a GP_T x GP_T output) +=
//   sum_{p < K} opA(r, p) * opB(p, c)
// opA(r, p) = TA ? A[p*lda + r] : A[r*lda + p]
// opB(p, c) = TB ? B[c*ldb + p] : B[p*ldb + c]
// K is a multiple of GP_T. Both operands stream through shared memory in
// GP_T x GP_T chunks with coalesced global reads.
template <bool TA, bool TB>
static __device__ void tile_mma(float acc[2][2], const float* A, int lda,
                                const float* B, int ldb, int K,
                                const GpShared& s) {
  const int tid = threadIdx.x;
  const int r0 = (tid >> 4) * 2, c0 = (tid & 15) * 2;
  for (int k0 = 0; k0 < K; k0 += GP_T) {
    for (int e = tid; e < GP_T * GP_T; e += GP_THREADS) {
      const int i = e / GP_T, j = e % GP_T;
      if (TA) s.As[i * GP_TS + j] = A[(size_t)(k0 + i) * lda + j];
      else    s.As[j * GP_TS + i] = A[(size_t)i * lda + k0 + j];
      if (TB) s.Bs[j * GP_TS + i] = B[(size_t)i * ldb + k0 + j];
      else    s.Bs[i * GP_TS + j] = B[(size_t)(k0 + i) * ldb + j];
    }
    __syncthreads();
#pragma unroll 8
    for (int q = 0; q < GP_T; ++q) {
      const float a0 = s.As[q * GP_TS + r0], a1 = s.As[q * GP_TS + r0 + 1];
      const float b0 = s.Bs[q * GP_TS + c0], b1 = s.Bs[q * GP_TS + c0 + 1];
      acc[0][0] += a0 * b0;
      acc[0][1] += a0 * b1;
      acc[1][0] += a1 * b0;
      acc[1][1] += a1 * b1;
    }
    __syncthreads();
  }
}

// Upper Cholesky of the GP_T x GP_T tile St in place (St = U^T U), zeros
// below the diagonal; run by one warp, lane j owning column j. Adds
// sum log diag U to *logdet. A non-positive pivot gives NaN, which spreads
// through the expert's outputs (the linesearch reads NaN as a rejection).
static __device__ void gp_chol_tile(float* St, float* logdet) {
  const int lane = threadIdx.x & 31;
  for (int c = 0; c < GP_T; ++c) {
    const float piv = sqrtf(St[c * GP_TS + c]);
    __syncwarp();
    float v = 0.f;
    if (lane > c) v = St[c * GP_TS + lane] / piv;
    else if (lane == c) v = piv;
    __syncwarp();
    St[c * GP_TS + lane] = v;
    __syncwarp();
    for (int i = c + 1; i <= lane; ++i)
      St[i * GP_TS + lane] -= St[c * GP_TS + i] * v;
    __syncwarp();
    if (lane == 0) *logdet += logf(piv);
  }
}

// Wt = St^{-1} for the upper-triangular tile St (back substitution, lane j
// solving column j); zeros below the diagonal.
static __device__ void gp_inv_tile(const float* St, float* Wt) {
  const int lane = threadIdx.x & 31;
  for (int i = GP_T - 1; i >= 0; --i) {
    float acc = (i == lane) ? 1.f : 0.f;
    for (int q = i + 1; q <= lane; ++q)
      acc -= St[i * GP_TS + q] * Wt[q * GP_TS + lane];
    Wt[i * GP_TS + lane] = (i <= lane) ? acc / St[i * GP_TS + i] : 0.f;
  }
}

// Masked noisy kernel matrix entry A[r][c] (ops/gpr.py _build_A):
// sf2 phi(r2) m_r m_c, plus m_r (noise - 1) + 1 on the diagonal.
template <int KID>
static __device__ __forceinline__ float gp_kval(const GpShared& s, int r,
                                                int c, int D, int Np,
                                                float sf2, float noise) {
  float r2 = 0.f;
  for (int d = 0; d < D; ++d) {
    const float dd = s.xs[d * Np + r] - s.xs[d * Np + c];
    r2 += dd * dd;
  }
  r2 *= gp_scale<KID>();
  float v = sf2 * gp_phi<KID>(r2) * (s.m[r] * s.m[c]);
  if (r == c) v += s.m[r] * (noise - 1.f) + 1.f;
  return v;
}

// Blocked left-looking Cholesky A = U^T U with the diagonal tiles inverted
// on the way (tile row k of U is W_kk^T (A_k. - sum_{p<k} U_pk^T U_p.)),
// then the off-diagonal tiles of W = U^{-1} by the block recurrence
// W_ij = -W_ii sum_{i<q<=j} U_iq W_qj. U and W are Np x Np row-major views
// with leading dimension ld; only their upper tiles are written (diagonal
// tiles with explicit zeros below the diagonal) and only those are read.
// Returns sum log diag U in every thread.
template <int KID>
static __device__ float gp_factor_invert(const GpShared& s, float* U,
                                         float* W, int ld, int D, int Np,
                                         float sf2, float noise) {
  const int tid = threadIdx.x;
  const int r0 = (tid >> 4) * 2, c0 = (tid & 15) * 2;
  const int nb = Np / GP_T;
  for (int k = 0; k < nb; ++k) {
    const int kT = k * GP_T;
    for (int j = k; j < nb; ++j) {
      const int jT = j * GP_T;
      float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      if (k > 0) tile_mma<true, false>(acc, U + kT, ld, U + jT, ld, kT, s);
      float* C = (j == k) ? s.St : s.Ct;
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
          C[(r0 + a) * GP_TS + c0 + b] =
              gp_kval<KID>(s, kT + r0 + a, jT + c0 + b, D, Np, sf2, noise) -
              acc[a][b];
      __syncthreads();
      if (j == k) {
        if (tid < 32) {
          gp_chol_tile(s.St, s.scal);
          gp_inv_tile(s.St, s.Wt);
        }
        __syncthreads();
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const size_t o = (size_t)(kT + r0 + a) * ld + kT + c0 + b;
            U[o] = s.St[(r0 + a) * GP_TS + c0 + b];
            W[o] = s.Wt[(r0 + a) * GP_TS + c0 + b];
          }
      } else {
        // U_kj = W_kk^T C (W_kk upper: rows q <= r contribute)
        float o[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
        for (int q = 0; q < GP_T; ++q) {
          const float w0 = s.Wt[q * GP_TS + r0], w1 = s.Wt[q * GP_TS + r0 + 1];
          const float x0 = s.Ct[q * GP_TS + c0], x1 = s.Ct[q * GP_TS + c0 + 1];
          o[0][0] += w0 * x0;
          o[0][1] += w0 * x1;
          o[1][0] += w1 * x0;
          o[1][1] += w1 * x1;
        }
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b)
            U[(size_t)(kT + r0 + a) * ld + jT + c0 + b] = o[a][b];
      }
      __syncthreads();
    }
  }

  for (int j = 1; j < nb; ++j) {
    const int jT = j * GP_T;
    for (int i = j - 1; i >= 0; --i) {
      const int iT = i * GP_T;
      float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      tile_mma<false, false>(acc, U + (size_t)iT * ld + iT + GP_T, ld,
                             W + (size_t)(iT + GP_T) * ld + jT, ld,
                             jT - iT, s);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
          s.Ct[(r0 + a) * GP_TS + c0 + b] = acc[a][b];
      for (int e = tid; e < GP_T * GP_T; e += GP_THREADS) {
        const int r = e / GP_T, c = e % GP_T;
        s.Wt[r * GP_TS + c] = W[(size_t)(iT + r) * ld + iT + c];
      }
      __syncthreads();
      float o[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      for (int q = 0; q < GP_T; ++q) {
        const float w0 = s.Wt[r0 * GP_TS + q], w1 = s.Wt[(r0 + 1) * GP_TS + q];
        const float x0 = s.Ct[q * GP_TS + c0], x1 = s.Ct[q * GP_TS + c0 + 1];
        o[0][0] += w0 * x0;
        o[0][1] += w0 * x1;
        o[1][0] += w1 * x0;
        o[1][1] += w1 * x1;
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
          W[(size_t)(iT + r0 + a) * ld + jT + c0 + b] = -o[a][b];
      __syncthreads();
    }
  }
  return s.scal[0];
}

// t1 = W^T y and alpha = W t1 = A^{-1} y into shared memory.
static __device__ void gp_alpha(const GpShared& s, const float* W, int ld,
                                int Np) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int c = tid; c < Np; c += GP_THREADS) {
    float a = 0.f;
    for (int q = 0; q <= c; ++q) a += W[(size_t)q * ld + c] * s.y[q];
    s.t1[c] = a;
  }
  __syncthreads();
  for (int r = warp; r < Np; r += GP_THREADS / 32) {
    float a = 0.f;
    for (int q = r + lane; q < Np; q += 32) a += W[(size_t)r * ld + q] * s.t1[q];
    a = gp_warp_sum(a);
    if (lane == 0) s.alpha[r] = a;
  }
  __syncthreads();
}

// Common launch plumbing: opt in to the dynamic shared memory the block
// needs, launch, and report the launch status.
template <typename KernelT, typename... Args>
static int gp_launch(KernelT kernel, int blocks, size_t smem,
                     cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, GP_THREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}
