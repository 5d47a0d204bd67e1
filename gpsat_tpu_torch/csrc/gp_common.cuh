// Device code shared by the GP kernels (gp_cholinv.cu, gp_vg.cu,
// gp_value.cu, gp_predict.cu and, through gp_sgpr_common.cuh,
// gp_sgpr_stream.cu and gp_sgpr_vg.cu).
//
// Replaces the shared pieces of gpsat_tpu/ops/pallas_gpr.py: the correlation
// functions _phi / _phi_grad (:64, :80), the staging of one expert's scaled
// coordinates, and the fixed-order sums that finish a kernel. The blocked
// factor of _factor_tile_and_invert (:157) is gp_cholinv.cu's many-blocks
// schedule, which the three exact-GPR kernels share.
//
//   gp_phi, gp_phi_grad  the correlations and their lengthscale derivative
//   gp_gpr_scale_kernel  xs = x / ls padded from Nx to M columns, y in row 6
//                        and the mask in row 7: the layout every exact-GPR
//                        kernel reads
//   gp_nlml_warp         0.5 |z|^2 + ld + 0.5 n log 2 pi of one expert on
//                        one warp, in a fixed order: the value kernel and
//                        vg's value lane call it on the same factor, so the
//                        two agree bit for bit
//   gp_warp_sum, gp_block_sum  reductions over a warp and a block
//   gp_mma_pipe          the pipelined FP32 tile product (64x64 or 128x128
//                        outputs, chunks copied ahead by cp.async) of the
//                        factor, vg's gradient pass and every SGPR kernel
//   gp_launch, GP_DISPATCH  launch plumbing by kernel id
// What bounds these kernels on an H100: FP32 operations on the CUDA cores
// (~N^3 flops per expert against ~20 N bytes of input).
#pragma once

#include <cuda_runtime.h>

#define GP_THREADS 256  // threads per block (8 warps)

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

// xs [B][8][M] <- xt [B][8][Nx] / ls in rows 0..D-1, yt [B][Nx] in row 6
// (zeros where yt is null) and the mask (row 7 of xt) in row 7, all zero on
// the columns from Nx to M; rows D..5 are not written. p [B][8] holds ls in
// 0..D-1. One block per expert.
static __global__ void __launch_bounds__(GP_THREADS)
gp_gpr_scale_kernel(const float* xt, const float* yt, const float* p,
                    float* xs, int Nx, int M, int D) {
  const int e = blockIdx.x;
  const float* x = xt + (size_t)e * 8 * Nx;
  float* o = xs + (size_t)e * 8 * M;
  for (int i = threadIdx.x; i < M; i += GP_THREADS) {
    for (int d = 0; d < D; ++d)
      o[d * M + i] = i < Nx ? x[d * Nx + i] / p[(size_t)e * 8 + d] : 0.f;
    o[6 * M + i] = i < Nx && yt ? yt[(size_t)e * Nx + i] : 0.f;
    o[7 * M + i] = i < Nx ? x[7 * Nx + i] : 0.f;
  }
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

// The NLML 0.5 |z|^2 + ld + 0.5 n log 2 pi of one expert from its solved
// y column z (z[r * ldz], r < M) and mask m[r], computed by all 32 lanes of
// a warp: lane l takes rows l, l + 32, ... in order, then a butterfly over
// the lanes (every lane ends with the same sums: IEEE addition commutes).
// Rounded operations only (no contraction left to the compiler), so that
// every kernel that calls it on the same inputs gets the same bits.
static __device__ float gp_nlml_warp(const float* z, int ldz, const float* m,
                                     float ld, int M) {
  const int lane = threadIdx.x & 31;
  float q = 0.f, n = 0.f;
  for (int r = lane; r < M; r += 32) {
    const float v = z[(size_t)r * ldz];
    q = __fmaf_rn(v, v, q);
    n = __fadd_rn(n, m[r]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    q = __fadd_rn(q, __shfl_xor_sync(0xffffffffu, q, o));
    n = __fadd_rn(n, __shfl_xor_sync(0xffffffffu, n, o));
  }
  return __fadd_rn(__fadd_rn(__fmul_rn(0.5f, q), ld),
                   __fmul_rn(__fmul_rn(0.5f, n), 1.8378770664093453f));
}

// ---------------------------------------------------------------------------
// gp_mma_pipe: the pipelined tile product of gp_cholinv.cu, gp_vg.cu,
// gp_sgpr_stream.cu and gp_sgpr_vg.cu.
//
// acc (this thread's (T/16) x (T/16) micro-tile of a T x T output, T = 64 or
// 128, GP_THREADS threads) += sum_{p < K} opA(r, p) * opB(p, c)
//   opA(r, p) = TA ? A[p*lda + r] : A[r*lda + p]
//   opB(p, c) = TB ? B[c*ldb + p] : B[p*ldb + c]
// Thread (ty, tx) = (tid / 16, tid % 16) owns rows gp_pipe_at(i, ty) and
// columns gp_pipe_at(j, tx): groups of four adjacent rows (columns) 64
// apart, so that every shared-memory read is a float4 and a warp reads each
// operand row without bank conflicts.
// Both operands pass through shared memory in chunks of GP_PIPE_KC = 32
// depth, two buffers per operand: while chunk c is multiplied, chunk c+1 is
// in flight. An operand whose rows run along the output edge (opA with TA,
// opB without TB) is copied by cp.async, 16 bytes a thread, straight into
// its buffer; the other kind is read as float4 into registers (a warp reads
// 128 contiguous bytes of each of four rows) before chunk c is multiplied,
// and written transposed after it, at column r ^ (p & 28) of buffer row p:
// that swizzle keeps the transposed stores free of bank conflicts and every
// group of four columns together for the float4 reads. K is a multiple of
// GP_PIPE_KC; every row start and lda, ldb are 16-byte aligned. `stage`
// holds GP_PIPE_STAGE_FLOATS(T) floats of shared memory, 16-byte aligned;
// the block synchronises before it returns, so the stage may be reused at
// once. FP32 FMA only: the products the kernels need run at full f32
// precision.
// ---------------------------------------------------------------------------
#define GP_PIPE_KC 32                                    // depth of a chunk
#define GP_PIPE_STAGE_FLOATS(T) (4 * (T) * GP_PIPE_KC)  // 2 buffers x 2 ops

static __device__ __forceinline__ int gp_pipe_at(int i, int t16) {
  return (i >> 2) * 64 + t16 * 4 + (i & 3);
}

static __device__ __forceinline__ void gp_cp_async16(float* smem,
                                                     const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

static __device__ __forceinline__ void gp_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
static __device__ __forceinline__ void gp_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// buf[p][r] <- X[(k0 + p) * ld + r] for p < KC, r < T (rows along the edge)
template <int T>
static __device__ __forceinline__ void gp_pipe_copy(float* buf,
                                                    const float* X, int ld,
                                                    int k0) {
#pragma unroll
  for (int u = 0; u < T / 32; ++u) {
    const int f = threadIdx.x + u * GP_THREADS;
    const int p = f / (T / 4), r4 = f % (T / 4);
    gp_cp_async16(buf + p * T + 4 * r4, X + (size_t)(k0 + p) * ld + 4 * r4);
  }
}

// v <- X[r * ld + k0 + 4q .. +3] for r < T, q < KC / 4 (rows across the edge)
template <int T>
static __device__ __forceinline__ void gp_pipe_fetch(float4 (&v)[T / 32],
                                                     const float* X, int ld,
                                                     int k0) {
#pragma unroll
  for (int u = 0; u < T / 32; ++u) {
    const int f = threadIdx.x + u * GP_THREADS;
    const int q = f % (GP_PIPE_KC / 4), r = f / (GP_PIPE_KC / 4);
    v[u] = *reinterpret_cast<const float4*>(X + (size_t)r * ld + k0 + 4 * q);
  }
}

// buf[p][r ^ (p & 28)] <- the floats gp_pipe_fetch read (p = 4q + x)
template <int T>
static __device__ __forceinline__ void gp_pipe_park(
    float* buf, const float4 (&v)[T / 32]) {
#pragma unroll
  for (int u = 0; u < T / 32; ++u) {
    const int f = threadIdx.x + u * GP_THREADS;
    const int q = f % (GP_PIPE_KC / 4), r = f / (GP_PIPE_KC / 4);
    const int c = r ^ (4 * q);  // (p & 28) = 4q for p = 4q + x
    buf[(4 * q + 0) * T + c] = v[u].x;
    buf[(4 * q + 1) * T + c] = v[u].y;
    buf[(4 * q + 2) * T + c] = v[u].z;
    buf[(4 * q + 3) * T + c] = v[u].w;
  }
}

template <int T, bool TA, bool TB>
static __device__ void gp_mma_pipe(float (&acc)[T / 16][T / 16],
                                   const float* A, int lda, const float* B,
                                   int ldb, int K, float* stage) {
  static_assert(T == 64 || T == 128, "output tile edge 64 or 128");
  constexpr int TM = T / 16, KC = GP_PIPE_KC, OP = T * KC;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float4 ra[T / 32], rb[T / 32];
  const int nc = K / KC;

  // chunk 0 into buffer 0
  if (TA) gp_pipe_copy<T>(stage, A, lda, 0);
  else gp_pipe_fetch<T>(ra, A, lda, 0);
  if (!TB) gp_pipe_copy<T>(stage + OP, B, ldb, 0);
  else gp_pipe_fetch<T>(rb, B, ldb, 0);
  gp_cp_async_commit();
  if (!TA) gp_pipe_park<T>(stage, ra);
  if (TB) gp_pipe_park<T>(stage + OP, rb);

  for (int c = 0; c < nc; ++c) {
    const float* As = stage + (c & 1) * 2 * OP;
    const float* Bs = As + OP;
    float* An = stage + ((c + 1) & 1) * 2 * OP;
    float* Bn = An + OP;
    const bool more = c + 1 < nc;
    if (more) {
      // chunk c+1 into the other buffer, which chunk c-1 left before the
      // closing barrier of the last pass
      const int k0 = (c + 1) * KC;
      if (TA) gp_pipe_copy<T>(An, A, lda, k0);
      else gp_pipe_fetch<T>(ra, A, lda, k0);
      if (!TB) gp_pipe_copy<T>(Bn, B, ldb, k0);
      else gp_pipe_fetch<T>(rb, B, ldb, k0);
      gp_cp_async_commit();
      gp_cp_async_wait<1>();
    } else {
      gp_cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < KC; ++p) {
      const int sa = TA ? 0 : (p & 28), sb = TB ? (p & 28) : 0;
      float a[TM], b[TM];
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const float4 a4 = *reinterpret_cast<const float4*>(
            As + p * T + ((h * 64 + ty * 4) ^ sa));
        const float4 b4 = *reinterpret_cast<const float4*>(
            Bs + p * T + ((h * 64 + tx * 4) ^ sb));
        a[4 * h + 0] = a4.x; a[4 * h + 1] = a4.y;
        a[4 * h + 2] = a4.z; a[4 * h + 3] = a4.w;
        b[4 * h + 0] = b4.x; b[4 * h + 1] = b4.y;
        b[4 * h + 2] = b4.z; b[4 * h + 3] = b4.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] += a[i] * b[j];
    }
    if (more) {
      if (!TA) gp_pipe_park<T>(An, ra);
      if (TB) gp_pipe_park<T>(Bn, rb);
    }
    __syncthreads();
  }
}

// Common launch plumbing: opt in to the dynamic shared memory the block
// needs, launch, and report the launch status.
template <typename KernelT, typename... Args>
static int gp_launch(KernelT kernel, dim3 blocks, size_t smem,
                     cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, GP_THREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// code = gp_launch(KERNEL<kernel_id>, grid, smem, st, ...): the caller
// declares code, grid, smem, st and kernel_id.
#define GP_DISPATCH(KERNEL, ...)                                             \
  switch (kernel_id) {                                                       \
    case GP_MATERN12:                                                        \
      code = gp_launch(KERNEL<GP_MATERN12>, grid, smem, st, __VA_ARGS__);    \
      break;                                                                 \
    case GP_MATERN32:                                                        \
      code = gp_launch(KERNEL<GP_MATERN32>, grid, smem, st, __VA_ARGS__);    \
      break;                                                                 \
    case GP_MATERN52:                                                        \
      code = gp_launch(KERNEL<GP_MATERN52>, grid, smem, st, __VA_ARGS__);    \
      break;                                                                 \
    case GP_RBF:                                                             \
      code = gp_launch(KERNEL<GP_RBF>, grid, smem, st, __VA_ARGS__);         \
      break;                                                                 \
    case GP_EXPONENTIAL:                                                     \
      code = gp_launch(KERNEL<GP_EXPONENTIAL>, grid, smem, st, __VA_ARGS__); \
      break;                                                                 \
    default:                                                                 \
      code = (int)cudaErrorInvalidValue;                                     \
  }
