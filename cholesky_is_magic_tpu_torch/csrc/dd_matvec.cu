// Double-word matrix-vector products for Hopper (sm_90a), f32.
//
// Replace the Pallas TPU kernels of cholesky_is_magic_tpu/ops/dd_pallas.py:
//   dd_mv_kernel  <- _mv_kernel  (A @ x,  launched by _dd_mv_partials)
//   dd_rmv_kernel <- _rmv_kernel (A^T @ x, launched by _dd_rmv_partials) and
//                    the dd_sum over axis 0 that follows it
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
//   mv:  the order of the sums is fixed by one block of 128 threads per row,
//        threads striding over the columns (neighbouring threads read
//        neighbouring addresses), a warp-shuffle dd_add tree and the block's
//        4 warp sums added in order; dd_mv_kernel is that block, no partials
//        array.  Rows of at most kMvShortMax columns take
//        dd_mv_short_kernel instead, the same sums in the same order (the
//        same bits): a warp per group of rows, each lane playing four of the
//        block's threads, and one butterfly of dd_adds reducing the group's
//        warp trees together.  A 128-thread block on a 64-column row (the
//        batched pdas shape) left half its threads idle and paid a block's
//        latency, a tree and a barrier per row; by
//        tools/probe_mv_kernel.py on an NVIDIA H100 80GB HBM3 at 700.00 W the
//        warp kernel takes (1024, 64, 64) from 0.0567 to 0.0201 ms (bound
//        0.0052, bytes) and (256, 64, 128) from 0.0211 to 0.0119 (bound
//        0.0026); the block kernel stays ahead on single launches from 512
//        columns on (with the short kernel, 1536 rows leave the card too few
//        warps), hence kMvShortMax = 384.
//   rmv: row slabs so that enough threads fill the card; a thread owns a
//        few neighbouring columns of one slab (one load per row where the
//        rows are aligned to that many floats, 4-byte loads otherwise), each
//        with its own accumulator chain, and loads a chunk of rows at a time,
//        the next chunk's loads started before the current one is
//        accumulated.  Every column adds its slab's rows in ascending order,
//        and the slabs' partials are added in slab order 0..S-1 with dd_add,
//        starting from slab 0's: the order, and so the bits, whichever of
//        the two kernels runs.
//        dd_rmv_kernel (more than kRmvShortSlabs slabs, the pilot's 27):
//        slabs on the grid's second dimension, kRmvCols columns a thread.
//        The (slabs, n) partials go through L2: the last block to arrive
//        for a column block (an integer ticket per column block,
//        __threadfence + atomicAdd, set back to 0 by that same block) adds
//        that block's partials, so one launch does it all and the sums do
//        not depend on which block came last.  No float atomics.
//        On an NVIDIA H100 80GB HBM3 at 700.00 W (tools/probe_rmv_kernel.py)
//        the kernel up to the tickets runs at the rate of a plain read of A
//        whatever the threads (64-256) and columns (1, 2, 4) per thread at 8
//        rows; what is left is the last block's combine (~2.6 us for 27
//        slabs: a batch's L2 latency and its chain of dd_adds, four times).
//        The registers decide the rest: all blocks must be resident at once.
//        dd_rmv_short_kernel (at most kRmvShortSlabs slabs: a 64-row lane's
//        2, afiro's (128, 128) 4; up to 512 rows on lanes narrower than
//        kRmvCtaCols): a block holds every slab of its column groups,
//        threads flattened over (slab, lane, column group) so that no
//        thread idles on a 64- or 128-column lane; each slab's partial goes
//        to shared memory and, after one barrier, slab 0's thread adds the
//        others in order.  No partials in device memory, no tickets, where
//        the long kernel would leave half or three quarters of its threads
//        without a column on such lanes and pay the tickets' fence, atomics
//        and L2 round trip to add two partials.  On an NVIDIA H100 80GB HBM3
//        at 700.00 W (tools/probe_rmv_kernel.py --short): threads 128 or
//        256, columns 1, 2 or 4 and rows 8 or 16 a chunk come within ~5% of
//        each other at the batch shapes (128 x 2 x 16 taken); the short
//        kernel beats the long one from 2 to 16 slabs ((256, 64, 128) 0.0101
//        against 0.0113 ms, (64, 512, 128) 0.0138 against 0.0175) but not at
//        (4096, 8192)'s 17 (0.0700 against 0.0526 ms), hence
//        kRmvShortSlabs = 16.  Its stamps at (256, 64, 128): a block's
//        first rows land ~2.2 us after it starts (the batch's 8 MB
//        streaming in), its chains end ~2.0 us later and the combine takes
//        ~0.3 us: ~5.1 us from the first block's start to the last one's
//        end, where CUDA events read ~10 us around a launch that a
//        one-element fill takes ~5.2 us by.
// Both kernels mask the ragged edge themselves: any m, n >= 1.
//
// Batches (the batched LP solves, where the JAX package vmaps the Pallas
// calls and pallas_call's batching rule adds a grid axis): one launch over
// B lanes of the same (m, n), a lane per blockIdx.y (mv) or blockIdx.z
// (rmv), each lane at its own strides for A and x (a stride of 0 shares one
// operand across the lanes).  A lane's arithmetic and order are those of
// the single launch, so each lane is bit-equal to the single call on it;
// the single call is the batch of one; the short-row kernel runs the rows,
// the short-lane kernel the column groups, of all lanes one after another.

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

// m ? a : b for a mask m of all ones or all zeros, by bit operations, which
// the compiler cannot turn into an index into an array of registers (and so
// into local memory) as it may a ?: between two of its elements.
__device__ __forceinline__ float select(unsigned m, float a, float b) {
  return __uint_as_float((__float_as_uint(a) & m) | (__float_as_uint(b) & ~m));
}

__device__ __forceinline__ dd select(unsigned m, dd a, dd b) {
  return {select(m, a.hi, b.hi), select(m, a.lo, b.lo)};
}

constexpr int kMvThreads = 128;
constexpr int kMvWarps = kMvThreads / 32;
// Short rows: rows of at most kMvShortMax columns take dd_mv_short_kernel,
// kShortWarps warps a block.
constexpr int kMvShortMax = 384;
constexpr int kShortWarps = 4;
constexpr int kShortThreads = 32 * kShortWarps;
constexpr int kShortFill = 132 * 16;  // warps the launch aims for: 16 an SM
constexpr int kShortTrees = 8;        // rows times virtual warps a warp reduces at once

// Aᵀ·x: threads per block, neighbouring columns per thread (one load per
// row), rows per load chunk, slabs per load batch of the combine.
// The fastest of tools/probe_rmv_kernel.py's sweep that keeps seven blocks
// resident on an SM (72 registers).
constexpr int kRmvThreads = 128;
constexpr int kRmvCols = 2;
constexpr int kRmvRows = 8;
constexpr int kRmvBatch = 8;
constexpr int kRmvCtaCols = kRmvThreads * kRmvCols;  // dd_cuda.RMV_CTA_COLS
// Short lanes: at most kRmvShortSlabs slabs (dd_cuda.RMV_SHORT_SLABS) take
// dd_rmv_short_kernel, kRmvShortThreads threads a block, kRmvShortCols
// columns a thread, kRmvShortRows rows per load chunk.
constexpr int kRmvShortSlabs = 16;
constexpr int kRmvShortThreads = 128;
constexpr int kRmvShortCols = 2;
constexpr int kRmvShortRows = 16;
static_assert(kRmvShortSlabs <= kRmvShortThreads, "a thread per slab at least");

// %globaltimer stamps of dd_rmv_short_kernel for tools/probe_rmv_kernel.py,
// which builds this file with -DCIM_RMV_PROBE: per block, thread 0 stamps
// its entry (slot 0), the arrival of its first chunk of rows (1), the end of
// its chain (2) and of the combine (3), each after the value it names
// (``dep``) is there; nothing otherwise.
#ifdef CIM_RMV_PROBE
constexpr int kRmvStampBlocks = 16384;
__device__ unsigned long long cim_rmv_stamps[4 * kRmvStampBlocks];
#define RMV_STAMP(slot, dep)                                                   \
  do {                                                                         \
    if (threadIdx.x == 0 && blockIdx.x < kRmvStampBlocks &&                    \
        __float_as_uint(dep) != 0xffffffffu) {                                 \
      unsigned long long t;                                                    \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));                   \
      cim_rmv_stamps[4 * blockIdx.x + (slot)] = t;                             \
    }                                                                          \
  } while (0)
#else
#define RMV_STAMP(slot, dep) \
  do {                       \
  } while (0)
#endif

__global__ void __launch_bounds__(kMvThreads)
dd_mv_kernel(const float* __restrict__ A, const float* __restrict__ x,
             float* __restrict__ hi, float* __restrict__ lo, int m, int n,
             long long lda, long long lane_a, long long lane_x) {
  const int row = blockIdx.x;
  const long long lane = blockIdx.y;
  x += lane * lane_x;
  hi += lane * m;
  lo += lane * m;
  const float* a = A + lane * lane_a + static_cast<long long>(row) * lda;
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

// The short-row kernel's butterfly on the HALF * 2 trees each lane holds:
// the lanes with bit H keep the upper half, trade the lower half with lane
// i ^ H and add the pair of positions (lower first) into acc[0 .. HALF); then
// the same with HALF / 2 at offset H / 2, down to one tree a lane.
template <int HALF, int H, int N>
__device__ __forceinline__ void butterfly(dd (&acc)[N], int i) {
  if constexpr (HALF > 0) {
    const unsigned up = (i & H) ? ~0u : 0u;  // keeps the upper half
#pragma unroll
    for (int u = 0; u < HALF; ++u) {
      const dd keep = select(up, acc[HALF + u], acc[u]);
      const dd send = select(up, acc[u], acc[HALF + u]);
      dd got;
      got.hi = __shfl_xor_sync(0xffffffffu, send.hi, H);
      got.lo = __shfl_xor_sync(0xffffffffu, send.lo, H);
      acc[u] = dd_add(select(up, got, keep), select(up, keep, got));
    }
    butterfly<HALF / 2, H / 2>(acc, i);
  }
}

// dd_mv_kernel's sums for short rows: a warp per R rows, rows of all lanes
// one after another (row g of lane g / m at g % m), kShortWarps warps a
// block.  Lane i plays the threads i, i + 32, i + 64 and i + 96 of
// dd_mv_kernel's block for each of its rows (that block's warps 0 to 3,
// here virtual warps), each with its own accumulator over the columns
// j = t, t + kMvThreads, ... in ascending order, loaded as those threads load
// them, every row's loads of a chunk of kMvThreads columns issued before any
// is added; V is the number of virtual warps with a column (1 for n <= 32,
// 2 for n <= 64, else 4), the rest sum zeros to {+0, +0}.  The warp then
// holds T = R V trees (row q, virtual warp v: tree q V + v), one value per
// position, and reduces all of them at once: at offsets h = 16, 8, ... while
// a lane holds more than one tree (a butterfly), each lane keeps half of its
// trees, trades the other half with lane i ^ h and adds the pair of
// positions p and p + h with dd_add, the lower position first; the
// remaining offsets add position p + h into p as a shuffle tree does.  Each
// tree's sum is dd_mv_kernel's shuffle tree for its lane 0, for T - 1 +
// log2(32 / T) dd_adds a lane where a tree at a time would take 5 T.  The
// lane holding row q's virtual warp 0 adds the row's four sums in order 0,
// 1, 2, 3, the all-zero ones included, and stores it: the single kernel's
// arithmetic in its order, so the same bits.
template <int V, int R>
__global__ void __launch_bounds__(kShortThreads)
dd_mv_short_kernel(const float* __restrict__ A, const float* __restrict__ x,
                   float* __restrict__ hi, float* __restrict__ lo, int m, int n,
                   long long lda, int lanes, long long lane_a, long long lane_x) {
  constexpr int T = R * V;                             // trees: 1 to 32
  constexpr int TB = T >= 32 ? 5 : T >= 16 ? 4 : T >= 8 ? 3 : T >= 4 ? 2 : T >= 2 ? 1 : 0;
  static_assert((1 << TB) == T, "a power of two of trees");
  constexpr int S = 32 >> TB;  // lanes per tree once the butterfly is done
  const int i = threadIdx.x & 31;
  const long long g0 =
      (static_cast<long long>(blockIdx.x) * kShortWarps + (threadIdx.x >> 5)) * R;
  const long long rows = static_cast<long long>(lanes) * m;
  if (g0 >= rows) return;
  // g0's lane and row (rows < 2^31: the launcher's condition).
  const int k0 = static_cast<int>(g0) / m, r0 = static_cast<int>(g0) % m;
  dd acc[T];
#pragma unroll
  for (int t = 0; t < T; ++t) acc[t] = {0.0f, 0.0f};
  for (int j0 = i; j0 < n; j0 += kMvThreads) {
    float av[R][V], xv[R][V];
    int k = k0, r = r0;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const bool in = g0 + q < rows;
      const float* a = A + k * lane_a + static_cast<long long>(r) * lda;
      const float* xk = x + k * lane_x;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int j = j0 + 32 * v;
        av[q][v] = in && j < n ? __ldg(a + j) : 0.0f;
        xv[q][v] = in && j < n ? __ldg(xk + j) : 0.0f;
      }
      if (++r == m) {
        r = 0;
        ++k;
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (j0 + 32 * v < n) dd_accumulate(acc[q * V + v], av[q][v], xv[q][v]);
      }
    }
  }
  butterfly<T / 2, 16>(acc, i);
  // Lane i now holds tree i >> (5 - TB) at position i mod S.
#pragma unroll
  for (int h = S / 2; h > 0; h >>= 1) {
    dd o;
    o.hi = __shfl_down_sync(0xffffffffu, acc[0].hi, h);
    o.lo = __shfl_down_sync(0xffffffffu, acc[0].lo, h);
    acc[0] = dd_add(acc[0], o);
  }
  // Tree t's sum is in lane t S; a row's virtual warps are V trees apart.
  dd t = acc[0];
#pragma unroll
  for (int v = 1; v < kMvWarps; ++v) {
    dd y = {0.0f, 0.0f};
    if (v < V) {
      y.hi = __shfl_down_sync(0xffffffffu, acc[0].hi, v * S);
      y.lo = __shfl_down_sync(0xffffffffu, acc[0].lo, v * S);
    }
    t = dd_add(t, y);
  }
  const int q = i / (S * V);
  if (i % (S * V) == 0 && g0 + q < rows) {
    hi[g0 + q] = t.hi;
    lo[g0 + q] = t.lo;
  }
}

// C neighbouring floats as one load.
template <int C>
struct floats;
template <>
struct floats<1> {
  using type = float;
};
template <>
struct floats<2> {
  using type = float2;
};
template <>
struct floats<4> {
  using type = float4;
};

// C neighbouring floats at ``p`` in one load (p aligned to their size):
// through the read-only path, or from L2 past L1 (``kFromL2``).
template <bool kFromL2, int C>
__device__ __forceinline__ void rmv_load_vec(const float* p, float (&v)[C]) {
  using vec = typename floats<C>::type;
  union {
    vec v;
    float f[C];
  } t;
  const vec* q = reinterpret_cast<const vec*>(p);
  t.v = kFromL2 ? __ldcg(q) : __ldg(q);
#pragma unroll
  for (int j = 0; j < C; ++j) v[j] = t.f[j];
}

template <int C>
__device__ __forceinline__ void rmv_store_vec(float* p, const float (&v)[C]) {
  using vec = typename floats<C>::type;
  union {
    vec v;
    float f[C];
  } t;
#pragma unroll
  for (int j = 0; j < C; ++j) t.f[j] = v[j];
  *reinterpret_cast<vec*>(p) = t.v;
}

// One row's columns of a thread from ``a`` (already at its first column):
// one load, or 4-byte loads with the ``left`` columns inside A and zeros
// past them.
template <bool kVec, int C>
__device__ __forceinline__ void rmv_load(const float* __restrict__ a, int left,
                                         float (&v)[C]) {
  if constexpr (kVec) {
    rmv_load_vec<false>(a, v);
  } else {
#pragma unroll
    for (int j = 0; j < C; ++j) v[j] = j < left ? __ldg(a + j) : 0.0f;
  }
}

// acc[j] += a[i][j] * x[i] for the rows r0 <= i < r1 (``a`` at row r0 and
// the thread's first column), rows ascending: rows in chunks of R, the next
// chunk's loads started before the current chunk is accumulated.  With
// kStamp, stamp 1 once the first chunk (or row) has landed, the next
// chunk's loads already issued.
template <bool kVec, int C, int R, bool kStamp = false>
__device__ __forceinline__ void rmv_chain(const float* __restrict__ a,
                                          const float* __restrict__ x, int r0, int r1,
                                          long long lda, int left, dd (&acc)[C]) {
  const int chunks = (r1 - r0) / R;
  float cur[R][C], nxt[R][C];
  float xc[R], xn[R];
  int i = r0;
  if (chunks > 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      rmv_load<kVec>(a + r * lda, left, cur[r]);
      xc[r] = __ldg(x + i + r);
    }
  }
  for (int c = 0; c < chunks; ++c) {
    a += R * lda;
    i += R;
    const bool more = c + 1 < chunks;
    if (more) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        rmv_load<kVec>(a + r * lda, left, nxt[r]);
        xn[r] = __ldg(x + i + r);
      }
    }
    if constexpr (kStamp) {
      if (c == 0) RMV_STAMP(1, cur[R - 1][C - 1] + xc[R - 1]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < C; ++j) dd_accumulate(acc[j], cur[r][j], xc[r]);
    }
    if (more) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        xc[r] = xn[r];
#pragma unroll
        for (int j = 0; j < C; ++j) cur[r][j] = nxt[r][j];
      }
    }
  }
  for (; i < r1; ++i, a += lda) {
    float v[C];
    rmv_load<kVec>(a, left, v);
    const float xi = __ldg(x + i);
    if constexpr (kStamp) {
      if (chunks == 0 && i == r0) RMV_STAMP(1, v[C - 1] + xi);
    }
#pragma unroll
    for (int j = 0; j < C; ++j) dd_accumulate(acc[j], v[j], xi);
  }
}

// kVec: every row of A starts on a boundary of kRmvCols floats and n is a
// multiple of kRmvCols.  part_hi / part_lo are (slabs, ldp) with ldp a
// multiple of 4 >= n; tickets holds one zero per column block on entry and
// on exit (the kernel traps on any other count).
template <bool kVec>
__global__ void __launch_bounds__(kRmvThreads)
dd_rmv_kernel(const float* __restrict__ A, const float* __restrict__ x,
              float* __restrict__ hi, float* __restrict__ lo,
              float* part_hi, float* part_lo, int* tickets, int m, int n,
              long long lda, long long ldp, int rows_per_slab,
              long long lane_a, long long lane_x) {
  const long long lane = blockIdx.z;
  A += lane * lane_a;
  x += lane * lane_x;
  hi += lane * n;
  lo += lane * n;
  part_hi += lane * gridDim.y * ldp;
  part_lo += lane * gridDim.y * ldp;
  tickets += lane * gridDim.x;
  const int col = (blockIdx.x * kRmvThreads + threadIdx.x) * kRmvCols;
  const int left = n - col;  // columns of this thread inside A, if > 0
  const int slab = blockIdx.y;
  const int slabs = gridDim.y;
  const int r0 = slab * rows_per_slab;
  const int r1 = min(m, r0 + rows_per_slab);
  __shared__ int last;
  dd acc[kRmvCols];
#pragma unroll
  for (int j = 0; j < kRmvCols; ++j) acc[j] = {0.0f, 0.0f};

  if (left > 0) {
    rmv_chain<kVec, kRmvCols, kRmvRows>(A + static_cast<long long>(r0) * lda + col, x, r0,
                                        r1, lda, left, acc);
  }

  if (slabs > 1) {
    if (left > 0) {
      float h[kRmvCols], l[kRmvCols];
#pragma unroll
      for (int j = 0; j < kRmvCols; ++j) { h[j] = acc[j].hi; l[j] = acc[j].lo; }
      const long long out = static_cast<long long>(slab) * ldp + col;
      rmv_store_vec(part_hi + out, h);
      rmv_store_vec(part_lo + out, l);
    }
    // The ticket: every thread's partials are visible device-wide before
    // thread 0 takes this block's ticket; the block that takes the last one
    // reads all of them back from L2, past its L1 (__ldcg), where they are
    // by then.
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      const int before = atomicAdd(tickets + blockIdx.x, 1);
      // A ticket that was not zero on entry ends past the slabs: stop the
      // launch with an error rather than combine partials not yet written.
      if (before >= slabs) __trap();
      last = before == slabs - 1;
    }
    __syncthreads();
    if (!last) return;
    if (threadIdx.x == 0) tickets[blockIdx.x] = 0;
    if (left <= 0) return;
    // Slab order 0..S-1.  The partials come in batches of kRmvBatch slabs,
    // a batch's loads all in flight before its chain of dd_adds starts: one L2
    // latency per batch, not per slab.
    const float* ph = part_hi + col;
    const float* pl = part_lo + col;
    for (int s0 = 0; s0 < slabs; s0 += kRmvBatch) {
      float h[kRmvBatch][kRmvCols], l[kRmvBatch][kRmvCols];
#pragma unroll
      for (int q = 0; q < kRmvBatch; ++q) {
        if (s0 + q < slabs) {
          rmv_load_vec<true>(ph + (s0 + q) * ldp, h[q]);
          rmv_load_vec<true>(pl + (s0 + q) * ldp, l[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < kRmvBatch; ++q) {
        if (s0 + q < slabs) {
#pragma unroll
          for (int j = 0; j < kRmvCols; ++j) {
            const dd p = {h[q][j], l[q][j]};
            acc[j] = s0 + q == 0 ? p : dd_add(acc[j], p);
          }
        }
      }
    }
  }
  if (left <= 0) return;
#pragma unroll
  for (int j = 0; j < kRmvCols; ++j) {
    if (j < left) {
      hi[col + j] = acc[j].hi;
      lo[col + j] = acc[j].lo;
    }
  }
}

// Aᵀ·x on short lanes, the sums of dd_rmv_kernel in its order: every slab
// of a column group in one block.  A unit is (lane, group of kRmvShortCols
// columns), units numbered lane after lane; a block takes U = T / slabs
// units (T = kRmvShortThreads) and thread t works on slab t / U of unit
// t % U, so neighbouring threads read neighbouring columns of one row and
// only T mod slabs threads idle.  Each slab's partial goes to shared memory;
// after one barrier, slab 0's thread adds slabs 1..S-1 into its own in
// order (dd_add, starting from slab 0's partial, never from zero: dd_add(v,
// 0) is not v when v.hi is -0) and stores the sum.  kVec as for
// dd_rmv_kernel, with kRmvShortCols floats.
template <bool kVec>
__global__ void __launch_bounds__(kRmvShortThreads)
dd_rmv_short_kernel(const float* __restrict__ A, const float* __restrict__ x,
                    float* __restrict__ hi, float* __restrict__ lo, int m, int n,
                    long long lda, int slabs, int rows_per_slab, int lanes,
                    long long lane_a, long long lane_x) {
  constexpr int C = kRmvShortCols;
  __shared__ float part_hi[C][kRmvShortThreads], part_lo[C][kRmvShortThreads];
  RMV_STAMP(0, 0.0f);
  const int units = kRmvShortThreads / slabs;
  const long long groups = (n + C - 1) / C;  // units of a lane
  const int slab = threadIdx.x / units;
  const int unit = threadIdx.x - slab * units;
  const long long u = static_cast<long long>(blockIdx.x) * units + unit;
  const bool live = slab < slabs && u < lanes * groups;
  const long long lane = live ? u / groups : 0;
  const int col = live ? static_cast<int>(u - lane * groups) * C : 0;
  const int left = n - col;  // columns of this thread inside A
  dd acc[C];
#pragma unroll
  for (int j = 0; j < C; ++j) acc[j] = {0.0f, 0.0f};
  if (live) {
    const int r0 = slab * rows_per_slab;
    const int r1 = min(m, r0 + rows_per_slab);
    rmv_chain<kVec, C, kRmvShortRows, true>(
        A + lane * lane_a + static_cast<long long>(r0) * lda + col, x + lane * lane_x, r0,
        r1, lda, left, acc);
  }
  RMV_STAMP(2, acc[0].hi);
  if (slabs > 1) {
    if (live && slab > 0) {
#pragma unroll
      for (int j = 0; j < C; ++j) {
        part_hi[j][threadIdx.x] = acc[j].hi;
        part_lo[j][threadIdx.x] = acc[j].lo;
      }
    }
    __syncthreads();
    if (live && slab == 0) {
      for (int s = 1; s < slabs; ++s) {
#pragma unroll
        for (int j = 0; j < C; ++j) {
          acc[j] = dd_add(acc[j], dd{part_hi[j][s * units + unit], part_lo[j][s * units + unit]});
        }
      }
    }
  }
  RMV_STAMP(3, acc[0].hi);
  if (!live || slab > 0) return;
  hi += lane * n;
  lo += lane * n;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    if (j < left) {
      hi[col + j] = acc[j].hi;
      lo[col + j] = acc[j].lo;
    }
  }
}

}  // namespace

// C interface, loaded with ctypes.  Each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError() (0 = launched).
// The batched entry points take ``lanes`` lanes of the same (m, n): lane k's
// A at A + k * lane_a, its x at x + k * lane_x, its outputs at row k of
// (lanes, m) or (lanes, n) hi / lo; lanes <= 65535 (the wrapper checks).

namespace {

int launch_mv(const float* A, const float* x, float* hi, float* lo, int m,
              int n, long long lda, int lanes, long long lane_a,
              long long lane_x, cudaStream_t s) {
  const long long rows = static_cast<long long>(m) * lanes;
  if (n <= kMvShortMax && rows < (1ll << 31)) {
    // Rows per warp: the most, up to 32 / V, that still gives every SM
    // kShortFill warps to run.
    const int V = n <= 32 ? 1 : (n <= 64 ? 2 : kMvWarps);
    int R = kShortTrees / V;
    while (R > 1 && (rows + R - 1) / R < kShortFill) R >>= 1;
    const dim3 grid(static_cast<unsigned>((rows + R * kShortWarps - 1) / (R * kShortWarps)));
    switch (V * 64 + R) {
#define CIM_SHORT(v, r)                                                               \
  case v * 64 + r:                                                                   \
    dd_mv_short_kernel<v, r><<<grid, kShortThreads, 0, s>>>(A, x, hi, lo, m, n, lda, \
                                                             lanes, lane_a, lane_x); \
    break;
      CIM_SHORT(1, 8) CIM_SHORT(1, 4) CIM_SHORT(1, 2) CIM_SHORT(1, 1)
      CIM_SHORT(2, 4) CIM_SHORT(2, 2) CIM_SHORT(2, 1) CIM_SHORT(4, 2) CIM_SHORT(4, 1)
#undef CIM_SHORT
    }
  } else {
    dd_mv_kernel<<<dim3(m, lanes), kMvThreads, 0, s>>>(A, x, hi, lo, m, n, lda, lane_a,
                                                       lane_x);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_rmv(const float* A, const float* x, float* hi, float* lo,
               float* part_hi, float* part_lo, int* tickets, int m, int n,
               long long lda, long long ldp, int slabs, int rows_per_slab,
               int lanes, long long lane_a, long long lane_x, cudaStream_t s) {
  const unsigned long long a_at = reinterpret_cast<unsigned long long>(A);
  if (slabs <= kRmvShortSlabs) {
    constexpr int C = kRmvShortCols;
    const long long units = static_cast<long long>(lanes) * ((n + C - 1) / C);
    const long long blocks = (units + kRmvShortThreads / slabs - 1) / (kRmvShortThreads / slabs);
    if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidConfiguration);
    const bool vec = a_at % (4 * C) == 0 && lda % C == 0 && n % C == 0 && lane_a % C == 0;
    if (vec) {
      dd_rmv_short_kernel<true><<<static_cast<unsigned>(blocks), kRmvShortThreads, 0, s>>>(
          A, x, hi, lo, m, n, lda, slabs, rows_per_slab, lanes, lane_a, lane_x);
    } else {
      dd_rmv_short_kernel<false><<<static_cast<unsigned>(blocks), kRmvShortThreads, 0, s>>>(
          A, x, hi, lo, m, n, lda, slabs, rows_per_slab, lanes, lane_a, lane_x);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (part_hi == nullptr || part_lo == nullptr || tickets == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + kRmvCtaCols - 1) / kRmvCtaCols, slabs, lanes);
  const bool vec = a_at % (4 * kRmvCols) == 0 && lda % kRmvCols == 0 && n % kRmvCols == 0 &&
                   lane_a % kRmvCols == 0;
  if (vec) {
    dd_rmv_kernel<true><<<grid, kRmvThreads, 0, s>>>(
        A, x, hi, lo, part_hi, part_lo, tickets, m, n, lda, ldp, rows_per_slab,
        lane_a, lane_x);
  } else {
    dd_rmv_kernel<false><<<grid, kRmvThreads, 0, s>>>(
        A, x, hi, lo, part_hi, part_lo, tickets, m, n, lda, ldp, rows_per_slab,
        lane_a, lane_x);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cim_dd_mv_f32(const float* A, const float* x, float* hi,
                             float* lo, int m, int n, long long lda,
                             void* stream) {
  return launch_mv(A, x, hi, lo, m, n, lda, 1, 0, 0,
                   static_cast<cudaStream_t>(stream));
}

extern "C" int cim_dd_mv_f32_batched(const float* A, const float* x, float* hi,
                                     float* lo, int m, int n, long long lda,
                                     int lanes, long long lane_a,
                                     long long lane_x, void* stream) {
  return launch_mv(A, x, hi, lo, m, n, lda, lanes, lane_a, lane_x,
                   static_cast<cudaStream_t>(stream));
}

// part_hi / part_lo: (slabs, ldp) scratch per lane, lane after lane, ldp a
// multiple of 4 >= n, both 16-byte aligned; tickets: one int per block of
// kRmvCtaCols columns per lane, all zero (the kernel leaves them zero).
// Neither is touched, and both may be null, when slabs <= kRmvShortSlabs
// (the short-lane kernel); a long launch without them is refused
// (cudaErrorInvalidValue).
extern "C" int cim_dd_rmv_f32(const float* A, const float* x, float* hi,
                              float* lo, float* part_hi, float* part_lo,
                              int* tickets, int m, int n, long long lda,
                              long long ldp, int slabs, int rows_per_slab,
                              void* stream) {
  return launch_rmv(A, x, hi, lo, part_hi, part_lo, tickets, m, n, lda, ldp,
                    slabs, rows_per_slab, 1, 0, 0,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int cim_dd_rmv_f32_batched(const float* A, const float* x,
                                      float* hi, float* lo, float* part_hi,
                                      float* part_lo, int* tickets, int m,
                                      int n, long long lda, long long ldp,
                                      int slabs, int rows_per_slab, int lanes,
                                      long long lane_a, long long lane_x,
                                      void* stream) {
  return launch_rmv(A, x, hi, lo, part_hi, part_lo, tickets, m, n, lda, ldp,
                    slabs, rows_per_slab, lanes, lane_a, lane_x,
                    static_cast<cudaStream_t>(stream));
}
