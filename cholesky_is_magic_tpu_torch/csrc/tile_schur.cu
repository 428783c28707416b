// The tile engine's Schur update for Hopper (sm_90a), f32.
//
// Replaces no TPU kernel: the JAX package's tile engine runs each panel's
// Schur update as plain jnp (cholesky_is_magic_tpu/sparse/tiled.py:367-373,
// a batched einsum of the gathered tiles and a scatter-add that XLA fuses on
// the TPU).  Run eagerly in PyTorch those are four launches a panel: both
// operands' tiles gathered into fresh buffers, a batched SGEMM into a third,
// and an index_add_ that reads it back into L.  On the QAP15 fleet (32
// lanes, block 128) the copies took 2.7 times the products' time.  This
// kernel does, for each pair p of one panel and each lane, on L's resident
// tile store:
//
//     L[dst[p]] -= L[a[p]] . L[b[p]]^T
//
// with nothing gathered, no product buffer and nothing scattered.  A panel's
// pairs have distinct destinations, and no destination is a tile of the
// panel (sparse/tiled.py), so the CTAs of one launch write disjoint tiles
// and read only tiles that none of them writes.
//
// What bounds it on the H100: 2 b^3 operations a product against each
// destination tile read and written once and the panel's tiles read once a
// lane.  At b = 128 a product is 4.2 MFLOP over 128 KB of its destination:
// 32 operations a byte against the card's 20 (67 TFLOP/s FP32 over 3.35
// TB/s), so the FP32 FMA rate bounds it, and what a SIMT product loses is
// issue slots to shared-memory loads, waits on staging, and the epilogue's
// read of the destination.
//
// Design:
// - One CTA per (128 x 128 block of a destination, pair, lane); the grid's x
//   runs over the pairs (and the blocks of a tile wider than 128), its y over
//   the lanes, so the CTAs in flight at once work on one lane's panel, whose
//   tiles (at most 35 at QAP15, 2.2 MB) stay in the L2 cache while every
//   pair of their row reads them.
// - 256 threads, 8 x 8 outputs a thread: a thread's rows and columns are 16
//   apart, and a warp covers 4 x 8 threads, so its 16-byte shared-memory
//   loads read 4 and 8 neighbouring rows, one conflict-free wavefront each.
//   16 loads feed 256 FMAs.
// - k in stages of 32 by 16-byte cp.async (4-byte where a row does not start
//   on a 16-byte boundary), a ring of three stages with two in flight; rows
//   padded to 36 floats.  110.6 KB of shared memory and at most 128
//   registers a thread put two CTAs on an SM, so one's staging and epilogue
//   run beside the other's products.
// - The destination's lines are sent toward the L2 cache as the CTA starts,
//   and the destination block itself comes by cp.async into the two ring
//   slots that the last stage leaves free, while its products run.  The
//   epilogue subtracts in shared memory and writes the block back in 16-byte
//   stores, so no thread waits on a read of device memory per entry.
//
// Fixed summation order, so the kernel is tested bit for bit: one
// accumulator an entry from zero, __fmaf_rn(A[i, t], B[j, t], acc) for t
// ascending (exactly b of them: a ragged last stage runs only its own k),
// then one __fsub_rn from the destination.  That is chol_cuda.schur_fma_plain's
// convention (K3, csrc/potrf.cu) on a whole tile with two operands, and
// chol_cuda.tile_schur_fma_plain computes it in plain PyTorch.  No TF32:
// the build has --fmad=false and every FMA is explicit.
//
// Lanes: the batched solvers vmap the tile engine over lanes that share its
// schedule; each lane's tiles lie at its own lane stride, each lane
// row-major.  A lane's CTAs run the single launch's code on the lane's
// tiles, so every lane is bit-equal to the single launch on it.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;             // a CTA's output rows and columns
constexpr int kR = 8;                  // a thread's outputs: kR x kR
constexpr int kT = kTile / kR;         // threads along a side; a thread's rows kT apart
constexpr int kK = 32;                 // k a stage
constexpr int kLd = kK + 4;            // staged row stride: 9 float4s, rows in other banks
constexpr int kRing = 3;               // stages held; two in flight
constexpr int kStageFloats = 2 * kTile * kLd;
constexpr size_t kSmem = kRing * kStageFloats * sizeof(float);
// The destination's staged row stride: the 4 rows a warp's threads read lie
// 8 banks apart.  Half the block's rows fill one ring slot.
constexpr int kSLd = kTile + 8;
static_assert(kTile / 2 * kSLd <= kStageFloats, "half a destination fits one slot");

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Copies `valid` (0 to 4) floats from src into the 16-byte chunk dst of
// shared memory by cp.async and zeroes the rest of the chunk; one 16-byte
// copy when the chunk is full and `vec` says src is 16-byte aligned.
__device__ __forceinline__ void stage_chunk(float* dst, const float* src, int valid,
                                            bool vec) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vec && valid == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < valid) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d + 4 * i),
                   "l"(src + i));
    } else {
      dst[i] = 0.0f;
    }
  }
}

// Stage s of both operands into ring slot s % kRing: k in [kK s, kK s + kK)
// of the rows [0, kTile) of A and B, rows past `rows_a` / `rows_b` and k past
// b as zeros; 8 neighbouring threads on one row's 128 bytes.
__device__ __forceinline__ void stage(float* sm, const float* A, const float* B, int b,
                                      int rows_a, int rows_b, int s, bool vec) {
  float* As = sm + (s % kRing) * kStageFloats;
  float* Bs = As + kTile * kLd;
  const int k0 = kK * s;
  for (int e = threadIdx.x; e < kTile * (kK / 4); e += kThreads) {
    const int r = e / (kK / 4), c = 4 * (e % (kK / 4));
    const int valid = max(0, min(4, b - k0 - c));
    const long long at = static_cast<long long>(r) * b + k0 + c;
    stage_chunk(As + r * kLd + c, A + at, r < rows_a ? valid : 0, vec);
    stage_chunk(Bs + r * kLd + c, B + at, r < rows_b ? valid : 0, vec);
  }
}

// Row r of the staged destination: rows [0, kTile / 2) in ring slot f0, the
// rest in slot f1.
__device__ __forceinline__ float* dst_row(float* sm, int f0, int f1, int r) {
  return sm + (r < kTile / 2 ? f0 : f1) * kStageFloats + (r % (kTile / 2)) * kSLd;
}

// The destination block S (rows x cols of row stride b) into ring slots f0
// and f1 by cp.async, 32 threads on one row's 512 bytes.
__device__ __forceinline__ void stage_dst(float* sm, int f0, int f1, const float* S, int b,
                                          int rows, int cols, bool vec) {
  for (int e = threadIdx.x; e < rows * (kTile / 4); e += kThreads) {
    const int r = e / (kTile / 4), c = 4 * (e % (kTile / 4));
    if (c < cols) {
      stage_chunk(dst_row(sm, f0, f1, r) + c, S + static_cast<long long>(r) * b + c,
                  min(4, cols - c), vec);
    }
  }
}

// acc[p][q] = fma(A[p][k], B[q][k], acc[p][q]) for the 4 k of chunk c, k
// ascending: the thread's rows Aw + p kT rows, its columns Bw + q kT rows.
__device__ __forceinline__ void chunk4(float (&acc)[kR][kR], const float* Aw,
                                       const float* Bw, int c) {
  float4 ra[kR];
#pragma unroll
  for (int p = 0; p < kR; ++p) ra[p] = lds4(Aw + p * kT * kLd + 4 * c);
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    const float4 rb = lds4(Bw + q * kT * kLd + 4 * c);
#pragma unroll
    for (int p = 0; p < kR; ++p) {
      acc[p][q] = __fmaf_rn(ra[p].x, rb.x, acc[p][q]);
      acc[p][q] = __fmaf_rn(ra[p].y, rb.y, acc[p][q]);
      acc[p][q] = __fmaf_rn(ra[p].z, rb.z, acc[p][q]);
      acc[p][q] = __fmaf_rn(ra[p].w, rb.w, acc[p][q]);
    }
  }
}

// The products of one stage of nk (1 to kK) k: whole chunks of 4, then the
// tail one k at a time, so that exactly nk FMAs reach each accumulator.
__device__ __forceinline__ void products(float (&acc)[kR][kR], const float* Aw,
                                         const float* Bw, int nk) {
  if (nk == kK) {
#pragma unroll
    for (int c = 0; c < kK / 4; ++c) chunk4(acc, Aw, Bw, c);
    return;
  }
  for (int c = 0; c < nk / 4; ++c) chunk4(acc, Aw, Bw, c);
  for (int k = nk & ~3; k < nk; ++k) {
#pragma unroll
    for (int p = 0; p < kR; ++p) {
#pragma unroll
      for (int q = 0; q < kR; ++q) {
        acc[p][q] = __fmaf_rn(Aw[p * kT * kLd + k], Bw[q * kT * kLd + k], acc[p][q]);
      }
    }
  }
}

// L[dst[p]] -= L[a[p]] . L[b[p]]^T for block (u, v) of pair p = blockIdx.x /
// nsub^2 (u, v = its remainder's row and column of nsub x nsub 128-blocks) in
// lane blockIdx.y, whose (b, b) tiles start at L + lane * lane_stride, each
// row-major.  vec says that every tile row starts on a 16-byte boundary.
__global__ void __launch_bounds__(kThreads, 2)
tile_schur_kernel(float* __restrict__ L, long long lane_stride, int b, int nsub,
                  const long long* __restrict__ pa, const long long* __restrict__ pb,
                  const long long* __restrict__ pd, int vec) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int nsub2 = nsub * nsub;
  const int pair = blockIdx.x / nsub2, sub = blockIdx.x - pair * nsub2;
  const int u = sub / nsub, v = sub - u * nsub;
  const long long bb = static_cast<long long>(b) * b;
  float* Ll = L + blockIdx.y * lane_stride;
  const float* A = Ll + pa[pair] * bb + static_cast<long long>(u) * kTile * b;
  const float* B = Ll + pb[pair] * bb + static_cast<long long>(v) * kTile * b;
  float* S = Ll + pd[pair] * bb + static_cast<long long>(u) * kTile * b + v * kTile;
  const int rows = min(kTile, b - u * kTile), cols = min(kTile, b - v * kTile);
  const int stages = (b + kK - 1) / kK;

  stage(sm, A, B, b, rows, cols, 0, vec);
  asm volatile("cp.async.commit_group;\n" ::);
  if (stages > 1) stage(sm, A, B, b, rows, cols, 1, vec);
  asm volatile("cp.async.commit_group;\n" ::);
  const int lines = (cols + 31) / 32;  // 128-byte lines of a destination row
  for (int e = threadIdx.x; e < rows * lines; e += kThreads) {
    const int r = e / lines;
    const float* line = S + static_cast<long long>(r) * b + min(32 * (e - r * lines), cols - 1);
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(line));
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ty = 4 * (warp >> 1) + (lane >> 3);  // warp w: 4 x 8 threads at (4 (w / 2), 8 (w % 2))
  const int tx = 8 * (warp & 1) + (lane & 7);
  float acc[kR][kR];
#pragma unroll
  for (int p = 0; p < kR; ++p) {
#pragma unroll
    for (int q = 0; q < kR; ++q) acc[p][q] = 0.0f;
  }
  const int last = stages - 1, f0 = (last + 1) % kRing, f1 = (last + 2) % kRing;
  for (int s = 0; s < stages; ++s) {
    // Stage s has landed (one group a step is committed, empty or not); every
    // thread is past stage s - 1's products, so its slot takes stage s + 2,
    // and at the last stage the two slots besides its own take the
    // destination.
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    if (s + 2 < stages) stage(sm, A, B, b, rows, cols, s + 2, vec);
    if (s == last) stage_dst(sm, f0, f1, S, b, rows, cols, vec);
    asm volatile("cp.async.commit_group;\n" ::);
    const float* As = sm + (s % kRing) * kStageFloats;
    products(acc, As + ty * kLd, As + kTile * kLd + tx * kLd, min(kK, b - kK * s));
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kR; ++p) {
    float* row = dst_row(sm, f0, f1, ty + kT * p);
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      row[tx + kT * q] = __fsub_rn(row[tx + kT * q], acc[p][q]);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rows * (kTile / 4); e += kThreads) {
    const int r = e / (kTile / 4), c = 4 * (e % (kTile / 4));
    const float* from = dst_row(sm, f0, f1, r) + c;
    float* to = S + static_cast<long long>(r) * b + c;
    if (vec && c + 4 <= cols) {
      *reinterpret_cast<float4*>(to) = lds4(from);
    } else {
      for (int i = 0; i < 4 && c + i < cols; ++i) to[i] = from[i];
    }
  }
}

}  // namespace

// C interface, loaded with ctypes.  Each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError() (0 =
// launched).  L holds each lane's (NT + 1, b, b) tiles row-major, lanes
// `lane_stride` floats apart; pa, pb and pd hold the panel's `pairs` tile
// indices; vec says that L, lane_stride and b put every tile row on a
// 16-byte boundary.  1 to 65535 lanes; no pairs launch nothing.
extern "C" int cim_tile_schur_f32_batched(float* L, long long lane_stride, int b,
                                          const long long* pa, const long long* pb,
                                          const long long* pd, int pairs, int lanes,
                                          int vec, void* stream) {
  if (b < 1 || pairs < 0 || lanes < 1 || lanes > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long nsub = (b + kTile - 1) / kTile;
  if (pairs * nsub * nsub > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (pairs == 0) return 0;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        tile_schur_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmem));
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(tile_schur_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tile_schur_kernel<<<dim3(static_cast<unsigned>(pairs * nsub * nsub), lanes), kThreads,
                      kSmem, s>>>(L, lane_stride, b, static_cast<int>(nsub), pa, pb, pd,
                                  vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cim_tile_schur_f32(float* L, int b, const long long* pa, const long long* pb,
                                  const long long* pd, int pairs, int vec, void* stream) {
  return cim_tile_schur_f32_batched(L, 0, b, pa, pb, pd, pairs, 1, vec, stream);
}
