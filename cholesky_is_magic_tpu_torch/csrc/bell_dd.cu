// Double-word block-ELL product y = A·x for Hopper (sm_90a), f32.
//
// Replaces no TPU kernel: the JAX package's ops/bell.py computes dd_matvec
// in plain jnp, which XLA fuses on the TPU.  The port's plain form
// (ops/bell.py::_dd_matvec_plain) runs the same chain as eager PyTorch, where
// every step of two_prod and of both dd_sum trees writes a whole
// (lanes, block-rows, kb, 8, 128) intermediate to device memory: at the
// sparse fleet's shapes ~190 launches and gigabytes of traffic a call.  This
// kernel keeps every intermediate in registers.
//
// The bits are the plain form's, lane by lane:
//   - each element's product is Dekker's two_prod (ops/dd.py: the split by
//     4097, no fused multiply-add; every operation below is an explicit
//     round-to-nearest intrinsic, and the library is built with
//     --fmad=false besides);
//   - a tile row's 128 products are added by ops/dd.py::dd_sum's pow2 tree,
//     pairing (2i, 2i+1) at every level with dd_add;
//   - a block-row's kb tile sums are added by dd_sum's binary digits of kb:
//     a pow2 tree over each contiguous part, largest part first, the parts
//     combined left to right.
// Padded tiles are computed, not skipped, and columns past n_cols read 0,
// as the plain form's zero-padded gather does, so a NaN or Inf in x spreads
// exactly as there.
//
// Work: one warp per (block-row, lane).  A thread holds four neighbouring
// columns of the tile's eight rows (one 16-byte load a row), adds its four
// products of each row (the tree's first two levels), and the warp finishes
// the eight rows' trees together: at the next three levels each pair of
// threads swaps half of its rows, so that every dd_add is one the tree
// needs, and the last two levels are shuffles.  The tiles are added in
// order through a small stack, which gives dd_sum's trees.  Eight warps a
// block take consecutive (block-row, lane) items, lanes fastest, so a block
// reads one block-row's tiles for eight lanes: where the lanes share A
// (lane stride 0) the caches serve all but the first read.
//
// What bounds it on the H100: the operations.  Dekker's product costs 13
// float operations an element and the tree's dd_adds 20 per pair, ~36 a
// tile element a lane with the split of A done per lane; each tile element
// is read once a lane (4 bytes), far below the card's operations-to-bytes
// balance.  Tiles are dense 8 x 128 blocks, mostly zeros on a sparse LP:
// the padded work is the plain form's, which bit equality requires.  On an
// NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py phase 3), 64 lanes
// of the sparse fleet's Aᵀ (8166 block-rows, kb 2) take 1.51 ms shared and
// 1.73 ms with a copy a lane, against 132 ms for the plain form.

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

// ops/dd.py::_split: 4097·a, then hi = c - (c - a), lo = a - hi.
__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  float c = __fmul_rn(4097.0f, a);
  hi = __fsub_rn(c, __fsub_rn(c, a));
  lo = __fsub_rn(a, hi);
}

// ops/dd.py::two_prod(a, b) with b's split given.
__device__ __forceinline__ dd two_prod(float a, float b, float b_hi, float b_lo) {
  float p = __fmul_rn(a, b);
  float a_hi, a_lo;
  split(a, a_hi, a_lo);
  float err = __fadd_rn(__fsub_rn(__fmul_rn(a_hi, b_hi), p), __fmul_rn(a_hi, b_lo));
  err = __fadd_rn(err, __fmul_rn(a_lo, b_hi));
  err = __fadd_rn(err, __fmul_rn(a_lo, b_lo));
  return {p, err};
}

// m ? a : b for a mask m of all ones or all zeros, by bit operations, so
// that no register array is indexed at run time (as dd_matvec.cu).
__device__ __forceinline__ dd select(unsigned m, dd a, dd b) {
  return {__uint_as_float((__float_as_uint(a.hi) & m) | (__float_as_uint(b.hi) & ~m)),
          __uint_as_float((__float_as_uint(a.lo) & m) | (__float_as_uint(b.lo) & ~m))};
}

__device__ __forceinline__ dd shfl_xor(dd v, int m) {
  return {__shfl_xor_sync(0xffffffffu, v.hi, m), __shfl_xor_sync(0xffffffffu, v.lo, m)};
}

__device__ __forceinline__ dd shfl_down(dd v, int off) {
  return {__shfl_down_sync(0xffffffffu, v.hi, off), __shfl_down_sync(0xffffffffu, v.lo, off)};
}

// One level of the tree across the lane pair (t, t ^ bit) on rows v[0..N): the
// thread whose ``bit`` is clear keeps the first N/2 rows and takes its
// partner's, which hold the next columns; the other keeps the last N/2.
// Each dd_add takes the lower columns first, as dd_sum does.
template <int N>
__device__ __forceinline__ void swap_level(dd* v, int t, int bit) {
  const unsigned upper = (t & bit) ? 0xffffffffu : 0u;
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const dd send = select(upper, v[j], v[N / 2 + j]);
    const dd keep = select(upper, v[N / 2 + j], v[j]);
    const dd recv = shfl_xor(send, bit);
    v[j] = dd_add(select(upper, recv, keep), select(upper, keep, recv));
  }
}

constexpr int kBR = 8;          // rows of a tile (ops/bell.py BR)
constexpr int kBC = 128;        // columns of a tile (BC)
constexpr int kWarps = 8;       // warps a block, one (block-row, lane) each
constexpr int kStack = 32;      // the tile stack: log2(kb) + 1 entries at most

// hi, lo: (lanes, n_rows).  Thread t < 8 of a warp ends holding row
// 4·(t&1) + 2·((t>>1)&1) + ((t>>2)&1) of its block-row.
__global__ void __launch_bounds__(kWarps * 32, 2)
bell_dd_mv_kernel(const float* __restrict__ blocks, const long long* __restrict__ bcols,
                  const float* __restrict__ x, float* __restrict__ hi,
                  float* __restrict__ lo, int nbr, int kb, int n_rows, int n_cols,
                  int lanes, long long lane_blocks, long long lane_bcols,
                  long long lane_x) {
  const int t = threadIdx.x & 31;
  const long long item = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (item >= static_cast<long long>(nbr) * lanes) return;
  const int lane = static_cast<int>(item % lanes);
  const long long r = item / lanes;
  const float4* A = reinterpret_cast<const float4*>(
      blocks + lane * lane_blocks + r * kb * (kBR * kBC)) + t;
  const long long* bc = bcols + lane * lane_bcols + r * kb;
  const float* xl = x + lane * lane_x;

  dd stack[kStack];
  dd total = {0.0f, 0.0f};
  bool first = true;
  int k = 0;
  for (int rem = kb; rem > 0;) {
    const int part = 1 << (31 - __clz(rem));
    int depth = 0;
    for (int j = 1; j <= part; ++j, ++k) {
      float4 a[kBR];
#pragma unroll
      for (int i = 0; i < kBR; ++i) a[i] = __ldg(A + (static_cast<long long>(k) * kBR + i) * (kBC / 4));
      const long long j0 = __ldg(bc + k) * kBC + 4 * t;
      float xv[4], xh[4], xo[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        xv[c] = j0 + c < n_cols ? __ldg(xl + j0 + c) : 0.0f;
        split(xv[c], xh[c], xo[c]);
      }
      // The tree's levels 1 and 2 inside the thread: columns 4t .. 4t+3.
      dd v[kBR];
#pragma unroll
      for (int i = 0; i < kBR; ++i) {
        const dd p0 = two_prod(a[i].x, xv[0], xh[0], xo[0]);
        const dd p1 = two_prod(a[i].y, xv[1], xh[1], xo[1]);
        const dd p2 = two_prod(a[i].z, xv[2], xh[2], xo[2]);
        const dd p3 = two_prod(a[i].w, xv[3], xh[3], xo[3]);
        v[i] = dd_add(dd_add(p0, p1), dd_add(p2, p3));
      }
      // Levels 3 to 5: 8, then 16, then 32 columns, halving the rows.
      swap_level<8>(v, t, 1);
      swap_level<4>(v, t, 2);
      swap_level<2>(v, t, 4);
      // Levels 6 and 7: 64 and 128 columns.
      dd s = dd_add(v[0], shfl_down(v[0], 8));
      s = dd_add(s, shfl_down(s, 16));
      // dd_sum over the tiles: a pow2 tree inside the part.
      for (int m = j; (m & 1) == 0; m >>= 1) s = dd_add(stack[--depth], s);
      stack[depth++] = s;
    }
    total = first ? stack[0] : dd_add(total, stack[0]);
    first = false;
    rem -= part;
  }
  if (t < kBR) {
    const long long row = r * kBR + 4 * (t & 1) + 2 * ((t >> 1) & 1) + ((t >> 2) & 1);
    if (row < n_rows) {
      hi[static_cast<long long>(lane) * n_rows + row] = total.hi;
      lo[static_cast<long long>(lane) * n_rows + row] = total.lo;
    }
  }
}

}  // namespace

// C interface, loaded with ctypes.  Launches on the given stream, does not
// synchronise, and returns cudaGetLastError() (0 = launched).  ``lanes``
// lanes of one (nbr, kb) block-ELL shape: lane k's tiles at blocks + k *
// lane_blocks ((nbr, kb, 8, 128) row-major, 16-byte aligned), its tile
// columns at bcols + k * lane_bcols ((nbr, kb) int64), its x at x + k *
// lane_x (n_cols floats), its outputs at row k of (lanes, n_rows) hi / lo;
// a lane stride of 0 shares that operand.  A single product is the batch of
// one.  n_rows <= 8 * nbr.
extern "C" int cim_bell_dd_mv_f32(const float* blocks, const long long* bcols,
                                  const float* x, float* hi, float* lo, int nbr,
                                  int kb, int n_rows, int n_cols, int lanes,
                                  long long lane_blocks, long long lane_bcols,
                                  long long lane_x, void* stream) {
  const long long warps = static_cast<long long>(nbr) * lanes;
  const long long grid = (warps + kWarps - 1) / kWarps;
  if (grid > 0x7fffffffll || kb < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (grid == 0) return 0;
  bell_dd_mv_kernel<<<static_cast<unsigned>(grid), kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      blocks, bcols, x, hi, lo, nbr, kb, n_rows, n_cols, lanes, lane_blocks, lane_bcols,
      lane_x);
  return static_cast<int>(cudaGetLastError());
}
