// Double-word matrix-vector products for Hopper (sm_90a), f32.
//
// Replace the Pallas TPU kernels of cholesky_is_magic_tpu/ops/dd_pallas.py:
//   dd_mv_kernel          <- _mv_kernel  (A @ x,  launched by _dd_mv_partials)
//   dd_rmv_partial_kernel <- _rmv_kernel (A^T @ x, launched by _dd_rmv_partials)
//   dd_rmv_reduce_kernel  <- the dd_sum over axis 0 that follows _rmv_kernel
//
// Every product a*x is split error-free into p + e with e = fma(a, x, -p)
// (the exact product error; the same value as the Dekker split of the JAX
// package, barring overflow), then added into a per-thread double-word
// accumulator with a compensated two_sum whose error is folded into the low
// word exactly as _dd_accumulate does.  Partial accumulators are combined
// with the accurate dd_add of ops/dd.py.
//
// Contraction must not touch the error-free transformations: every operation
// below is an explicit round-to-nearest intrinsic, and the library is built
// with --fmad=false besides.  Never build it with --use_fast_math.
//
// What bounds them on the H100: each element of A is read once (4 bytes) and
// costs ~10 flops, so both kernels are bound by device-memory bandwidth.
// The design keeps A's reads coalesced and reads A exactly once:
//   mv:  one block of 128 threads per row, threads striding over the columns
//        (neighbouring threads read neighbouring addresses), a warp-shuffle
//        dd_add tree and a shared-memory step across the block's 4 warps;
//        no partials array.
//   rmv: one thread per column reading A's rows in order (a warp reads 32
//        neighbouring floats of a row), row slabs on the grid's second
//        dimension so that enough blocks fill the card; (slabs, n) partials
//        are combined by a second small kernel.
// Both kernels mask the ragged edge themselves: any m, n >= 1.

#include <cuda_runtime.h>

namespace {

struct dd {
  float hi;
  float lo;
};

__device__ __forceinline__ dd two_sum(float a, float b) {
  float s = __fadd_rn(a, b);
  float bb = __fsub_rn(s, a);
  float err = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
  return {s, err};
}

__device__ __forceinline__ dd fast_two_sum(float a, float b) {
  float s = __fadd_rn(a, b);
  float err = __fsub_rn(b, __fsub_rn(s, a));
  return {s, err};
}

// ops/dd.py::dd_add (the accurate variant).
__device__ __forceinline__ dd dd_add(dd x, dd y) {
  dd s = two_sum(x.hi, y.hi);
  dd t = two_sum(x.lo, y.lo);
  float c = __fadd_rn(s.lo, t.hi);
  dd v = fast_two_sum(s.hi, c);
  float w = __fadd_rn(t.lo, v.lo);
  return fast_two_sum(v.hi, w);
}

// acc += a * x, as dd_pallas.py::_dd_accumulate: two_sum(acc.hi, p), then
// (two_sum error + product error) folded into the low word, renormalised.
__device__ __forceinline__ void dd_accumulate(dd& acc, float a, float x) {
  float p = __fmul_rn(a, x);
  float e = __fmaf_rn(a, x, -p);
  float s = __fadd_rn(acc.hi, p);
  float bb = __fsub_rn(s, acc.hi);
  float err = __fadd_rn(__fsub_rn(acc.hi, __fsub_rn(s, bb)), __fsub_rn(p, bb));
  float lo = __fadd_rn(acc.lo, __fadd_rn(err, e));
  float hi2 = __fadd_rn(s, lo);
  acc.hi = hi2;
  acc.lo = __fsub_rn(lo, __fsub_rn(hi2, s));
}

__device__ __forceinline__ dd warp_dd_sum(dd v) {
  for (int off = 16; off > 0; off >>= 1) {
    dd o;
    o.hi = __shfl_down_sync(0xffffffffu, v.hi, off);
    o.lo = __shfl_down_sync(0xffffffffu, v.lo, off);
    v = dd_add(v, o);
  }
  return v;
}

constexpr int kMvThreads = 128;
constexpr int kMvWarps = kMvThreads / 32;
constexpr int kRmvThreads = 256;

__global__ void __launch_bounds__(kMvThreads)
dd_mv_kernel(const float* __restrict__ A, const float* __restrict__ x,
             float* __restrict__ hi, float* __restrict__ lo, int n,
             long long lda) {
  const int row = blockIdx.x;
  const float* a = A + static_cast<long long>(row) * lda;
  dd acc = {0.0f, 0.0f};
  for (int j = threadIdx.x; j < n; j += kMvThreads) {
    dd_accumulate(acc, a[j], x[j]);
  }
  acc = warp_dd_sum(acc);
  __shared__ float warp_hi[kMvWarps];
  __shared__ float warp_lo[kMvWarps];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    warp_hi[warp] = acc.hi;
    warp_lo[warp] = acc.lo;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    dd t = {warp_hi[0], warp_lo[0]};
    for (int w = 1; w < kMvWarps; ++w) t = dd_add(t, dd{warp_hi[w], warp_lo[w]});
    hi[row] = t.hi;
    lo[row] = t.lo;
  }
}

__global__ void __launch_bounds__(kRmvThreads)
dd_rmv_partial_kernel(const float* __restrict__ A, const float* __restrict__ x,
                      float* __restrict__ part_hi, float* __restrict__ part_lo,
                      int m, int n, long long lda, int rows_per_slab) {
  const int col = blockIdx.x * kRmvThreads + threadIdx.x;
  if (col >= n) return;
  const int slab = blockIdx.y;
  const int r0 = slab * rows_per_slab;
  const int r1 = min(m, r0 + rows_per_slab);
  dd acc = {0.0f, 0.0f};
  for (int i = r0; i < r1; ++i) {
    dd_accumulate(acc, A[static_cast<long long>(i) * lda + col], x[i]);
  }
  const long long out = static_cast<long long>(slab) * n + col;
  part_hi[out] = acc.hi;
  part_lo[out] = acc.lo;
}

__global__ void __launch_bounds__(kRmvThreads)
dd_rmv_reduce_kernel(const float* __restrict__ part_hi,
                     const float* __restrict__ part_lo, float* __restrict__ hi,
                     float* __restrict__ lo, int n, int slabs) {
  const int col = blockIdx.x * kRmvThreads + threadIdx.x;
  if (col >= n) return;
  dd t = {part_hi[col], part_lo[col]};
  for (int s = 1; s < slabs; ++s) {
    const long long k = static_cast<long long>(s) * n + col;
    t = dd_add(t, dd{part_hi[k], part_lo[k]});
  }
  hi[col] = t.hi;
  lo[col] = t.lo;
}

}  // namespace

// C interface, loaded with ctypes.  Each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError() (0 = launched).

extern "C" int cim_dd_mv_f32(const float* A, const float* x, float* hi,
                             float* lo, int m, int n, long long lda,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dd_mv_kernel<<<m, kMvThreads, 0, s>>>(A, x, hi, lo, n, lda);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cim_dd_rmv_f32(const float* A, const float* x, float* hi,
                              float* lo, float* part_hi, float* part_lo, int m,
                              int n, long long lda, int slabs,
                              int rows_per_slab, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int col_blocks = (n + kRmvThreads - 1) / kRmvThreads;
  dd_rmv_partial_kernel<<<dim3(col_blocks, slabs), kRmvThreads, 0, s>>>(
      A, x, part_hi, part_lo, m, n, lda, rows_per_slab);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dd_rmv_reduce_kernel<<<col_blocks, kRmvThreads, 0, s>>>(part_hi, part_lo, hi,
                                                          lo, n, slabs);
  return static_cast<int>(cudaGetLastError());
}
