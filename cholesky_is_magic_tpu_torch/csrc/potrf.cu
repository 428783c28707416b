// Blocked Cholesky for Hopper (sm_90a), f32.
//
// Replaces the Pallas TPU kernel cholesky_is_magic_tpu/ops/pallas_chol.py
// _potrf_kernel (launched there by _potrf, reached from cholesky()), whose
// body is a right-looking loop over 128-column panels.  Its three steps
// become three kernels, driven by a host loop over the panels in global
// memory (ops/chol_cuda.py):
//
//   potrf_tile_kernel  <- _chol_fori + _tri_inv_fori: one CTA factors one
//                         (b, b) diagonal tile (b <= 128) held in shared
//                         memory and writes both the lower factor L and its
//                         lower-triangular inverse.  The tile engine
//                         (sparse/tiled.py) calls it once per panel on its
//                         diagonal tile.
//   potrf_panel_kernel <- P = A_panel . Minv^T, written in place, and the
//                         zeroing of the panel's upper strip.
//   potrf_schur_kernel <- the trailing update S -= P . P^T, lower triangle.
//
// Semantics kept from the TPU kernel and from jnp.linalg.cholesky: only the
// lower triangle of the input is read; the upper triangle of L and of the
// inverse is written as exact zeros; a non-positive (or NaN) pivot turns the
// whole tile's L and inverse into NaN, which the callers' finiteness checks
// report as a failed factorization (and the NaN spreads through the panel
// and the Schur update to the rest of the matrix).
//
// The library is built with --fmad=false (for the double-word kernels); the
// products here use explicit __fmaf_rn, so they keep the fused multiply-add.
//
// What bounds them on the H100:
//   tile:  b dependent column steps, two barriers each, a few thousand
//          flops per step on one SM: latency-bound.  The design keeps the
//          tile and its inverse in shared memory (2 b^2 floats, 128 KB at
//          b = 128, above the 48 KB default, so the attribute is raised),
//          builds the inverse in the same steps as the factor, walks each
//          region row by row with a warp's lanes on neighbouring columns
//          (no index division, no masked-off half of a square), and stages
//          the pivot column in a separate vector so that the updates read
//          shared memory without bank conflicts.
//   panel: (rows x b) . (b x b): a block owns 32 rows, staged in shared
//          memory with the transposed inverse, so the in-place write is safe.
//   schur: a SIMT product of depth b over the trailing lower triangle,
//          64 x 64 output tiles, 4 x 4 outputs per thread, depth staged in
//          shared memory 16 at a time; blocks above the diagonal exit.

#include <cuda_runtime.h>

namespace {

constexpr int kTileThreads = 512;
constexpr int kTileMax = 128;
constexpr int kPanelThreads = 256;
constexpr int kPanelRows = 32;
constexpr int kSchurTile = 64;
constexpr int kSchurDepth = 16;
constexpr int kSchurThreads = 256;

__global__ void __launch_bounds__(kTileThreads)
potrf_tile_kernel(float* __restrict__ A, long long lda, float* __restrict__ inv,
                  long long ldi, int b) {
  extern __shared__ float smem[];
  float* L = smem;          // b * b, row-major, leading dimension b
  float* X = L + b * b;     // b * b: the inverse, built in place of I
  float* col = X + b * b;   // b: the current column of L
  __shared__ int bad;
  const int tid = threadIdx.x;
  const int bb = b * b;
  if (tid == 0) bad = 0;
  for (int e = tid; e < bb; e += kTileThreads) {
    const int r = e / b, c = e - r * b;
    L[e] = (c <= r) ? A[r * lda + c] : 0.0f;
    X[e] = (r == c) ? 1.0f : 0.0f;
  }
  __syncthreads();

  // Right-looking unblocked factorization, one column per step, with the
  // inverse built alongside (L X = I by forward substitution, one row of X
  // per step).  Two barriers per step:
  //   A: the pivot column j of L (scaled into col[]), and row j of X, which
  //      every earlier step has finished updating, divided by L[j][j];
  //   B: column j stored; the trailing lower triangle of L loses
  //      col·colᵀ; the rows of X below j lose L[i][j]·X[j][:].
  // Threads form 16 rows of 32 lanes: a warp walks one row of a region,
  // its lanes on neighbouring columns.
  const int lane = tid & 31, wrow = tid >> 5;
  constexpr int kRows = kTileThreads / 32;
  for (int j = 0; j < b; ++j) {
    const float d = L[j * b + j];
    const float s = __fsqrt_rn(d);
    if (tid >= j && tid < b) {
      col[tid] = (tid == j) ? s : __fdiv_rn(L[tid * b + j], s);
    }
    if (tid <= j) X[j * b + tid] = __fdiv_rn(X[j * b + tid], s);
    if (tid == 0 && !(d > 0.0f)) bad = 1;
    __syncthreads();
    if (tid >= j && tid < b) L[tid * b + j] = col[tid];
    for (int i = j + 1 + wrow; i < b; i += kRows) {
      const float ci = col[i];
      for (int k = j + 1 + lane; k <= i; k += 32) {
        L[i * b + k] = __fmaf_rn(-ci, col[k], L[i * b + k]);
      }
      for (int c = lane; c <= j; c += 32) {
        X[i * b + c] = __fmaf_rn(-ci, X[j * b + c], X[i * b + c]);
      }
    }
    __syncthreads();
  }

  const bool fail = bad != 0;
  const float nan = __int_as_float(0x7fc00000);
  for (int e = tid; e < bb; e += kTileThreads) {
    const int r = e / b, c = e - r * b;
    float lv = (c <= r) ? L[e] : 0.0f;
    float xv = (c <= r) ? X[e] : 0.0f;
    if (fail) {
      lv = nan;
      xv = nan;
    }
    A[r * lda + c] = lv;
    inv[r * ldi + c] = xv;
  }
}

// P = A_panel . Minv^T for the `rows` rows below the diagonal block, in
// place; also zeroes the upper strip entries strip[c][row] (the transposed
// position of every panel entry), which the TPU kernel zeroes per panel.
__global__ void __launch_bounds__(kPanelThreads)
potrf_panel_kernel(float* __restrict__ A, long long lda,
                   const float* __restrict__ inv, long long ldi,
                   float* __restrict__ strip, int rows, int b) {
  extern __shared__ float smem[];
  float* invT = smem;                 // b * b: invT[k * b + c] = inv[c][k]
  float* R = invT + b * b;            // kPanelRows * b: this block's rows
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kPanelRows;
  const int nr = min(kPanelRows, rows - row0);
  for (int e = tid; e < b * b; e += kPanelThreads) {
    const int c = e / b, k = e - c * b;
    invT[k * b + c] = (k <= c) ? inv[c * ldi + k] : 0.0f;
  }
  for (int e = tid; e < nr * b; e += kPanelThreads) {
    const int r = e / b, k = e - r * b;
    R[e] = A[(row0 + r) * lda + k];
  }
  __syncthreads();
  for (int e = tid; e < nr * b; e += kPanelThreads) {
    const int r = e / b, c = e - r * b;
    float acc = 0.0f;
    for (int k = 0; k <= c; ++k) {
      acc = __fmaf_rn(R[r * b + k], invT[k * b + c], acc);
    }
    A[(row0 + r) * lda + c] = acc;
  }
  for (int e = tid; e < nr * b; e += kPanelThreads) {
    const int c = e / nr, r = e - c * nr;
    strip[c * lda + row0 + r] = 0.0f;
  }
}

// S -= P . P^T on the lower triangle of the (t, t) trailing block S, with P
// the (t, b) panel.  Blocks strictly above the diagonal exit at once.
__global__ void __launch_bounds__(kSchurThreads)
potrf_schur_kernel(float* __restrict__ S, long long lds,
                   const float* __restrict__ P, long long ldp, int t, int b) {
  const int bi = blockIdx.y, bj = blockIdx.x;
  if (bj > bi) return;
  __shared__ float Pa[kSchurDepth][kSchurTile + 1];
  __shared__ float Pb[kSchurDepth][kSchurTile + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int i0 = bi * kSchurTile, j0 = bj * kSchurTile;
  float acc[4][4];
  for (int p = 0; p < 4; ++p)
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.0f;
  for (int k0 = 0; k0 < b; k0 += kSchurDepth) {
    for (int e = threadIdx.x; e < kSchurTile * kSchurDepth; e += kSchurThreads) {
      const int r = e / kSchurDepth, k = e - r * kSchurDepth;
      const int gk = k0 + k, gi = i0 + r, gj = j0 + r;
      Pa[k][r] = (gi < t && gk < b) ? P[gi * ldp + gk] : 0.0f;
      Pb[k][r] = (gj < t && gk < b) ? P[gj * ldp + gk] : 0.0f;
    }
    __syncthreads();
    for (int k = 0; k < kSchurDepth; ++k) {
      float a[4], c[4];
      for (int p = 0; p < 4; ++p) a[p] = Pa[k][ty * 4 + p];
      for (int q = 0; q < 4; ++q) c[q] = Pb[k][tx * 4 + q];
      for (int p = 0; p < 4; ++p)
        for (int q = 0; q < 4; ++q) acc[p][q] = __fmaf_rn(a[p], c[q], acc[p][q]);
    }
    __syncthreads();
  }
  for (int p = 0; p < 4; ++p) {
    const int gi = i0 + ty * 4 + p;
    if (gi >= t) continue;
    for (int q = 0; q < 4; ++q) {
      const int gj = j0 + tx * 4 + q;
      if (gj < t && gj <= gi) {
        float* s = S + gi * lds + gj;
        *s = __fsub_rn(*s, acc[p][q]);
      }
    }
  }
}

size_t tile_smem(int b) { return (2 * static_cast<size_t>(b) * b + b) * sizeof(float); }
size_t panel_smem(int b) {
  return (static_cast<size_t>(b) * b + static_cast<size_t>(kPanelRows) * b) * sizeof(float);
}

}  // namespace

// C interface, loaded with ctypes.  Each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError() (0 = launched),
// or cudaErrorInvalidValue for a shape it does not take.

extern "C" int cim_potrf_tile_f32(float* A, long long lda, float* inv,
                                  long long ldi, int b, void* stream) {
  if (b < 1 || b > kTileMax) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        potrf_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(tile_smem(kTileMax)));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  potrf_tile_kernel<<<1, kTileThreads, tile_smem(b), s>>>(A, lda, inv, ldi, b);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cim_potrf_panel_f32(float* A, long long lda, const float* inv,
                                   long long ldi, float* strip, int rows, int b,
                                   void* stream) {
  if (b < 1 || b > kTileMax || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        potrf_panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(panel_smem(kTileMax)));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (rows + kPanelRows - 1) / kPanelRows;
  potrf_panel_kernel<<<blocks, kPanelThreads, panel_smem(b), s>>>(A, lda, inv, ldi,
                                                                   strip, rows, b);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cim_potrf_schur_f32(float* S, long long lds, const float* P,
                                   long long ldp, int t, int b, void* stream) {
  if (b < 1 || t < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (t + kSchurTile - 1) / kSchurTile;
  potrf_schur_kernel<<<dim3(tiles, tiles), kSchurThreads, 0, s>>>(S, lds, P, ldp, t, b);
  return static_cast<int>(cudaGetLastError());
}
