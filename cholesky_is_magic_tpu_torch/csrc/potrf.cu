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
//                         diagonal tile (ops/chol.py splits wider tiles);
//                         the batched solvers once per panel on every
//                         lane's diagonal tile, a CTA per lane, in one
//                         launch (cim_potrf_tile_f32_batched).
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
//   tile:  one CTA on one SM.  The work is ~2 b^3 / 3 flops (factor plus
//          inverse: 1.4 MFLOP at b = 128), 2.8 us of FP32 FMA at one SM's
//          share of the card's 67 TFLOP/s, and a chain of b dependent pivots
//          (shuffle, square root, division, shuffle, FMA) that no width of
//          parallelism shortens.  An unblocked loop (one column per step, two
//          CTA barriers each, rank-1 updates read from and written back to
//          shared memory) spends ~2 us per step waiting on barriers and
//          shared-memory latency.
//          The kernel is right-looking over 32-column sub-panels instead:
//          one warp factors and inverts the 32 x 32 diagonal block in
//          registers (lane i holds row i of the block and column i of its
//          inverse; the pivot column travels by __shfl_sync, no barrier);
//          then all warps run register-tiled 4 x 4 products out of shared
//          memory: the sub-panel below (L21 = A21 . X11^T), the block row of
//          the inverse (X_pq = X_pp . Y_pq) and one fused trailing update
//          that lowers A22 by L21 . L21^T and the running sums
//          Y = -sum L . X of the inverse's later block rows by L21 . X_p.
//          Three barriers per sub-panel (13 at b = 128 instead of 256).
//          The tile, its inverse and one 32-row staging panel stay in
//          shared memory (157 KB at b = 128; rows padded by 4 floats so that
//          neighbouring rows fall in different banks), loaded by cp.async.
//          Measured with clock64() probes on an H100
//          (tools/probe_tile_kernel.py): the four diagonal blocks are half of
//          the kernel's cycles, ~430 cycles (0.2 us) per column step; only
//          the lanes that need a quotient divide, since __fdiv_rn of a zero
//          or stale entry takes its slow path.
//   panel: (rows x b) . (b x b)^T, b(b+1)/2 FMAs per row: at n = 1536 the
//          first step moves ~1.5 MB (0.0007 ms at 3.35 TB/s), so it is bound
//          by how fast its CTAs stage their operands, not by the card's
//          rates.  A CTA owns 4 to 32 whole rows (the wrapper takes 16), so
//          the in-place write is safe;
//          it stages its rows and the inverse's lower triangle as they lie
//          (both along k) with 16-byte cp.async where the pointers and
//          strides allow, in four k-stages whose products start as each
//          arrives, rows padded to 132 floats so that a warp's 16-byte
//          loads of 32 rows hit distinct banks; the entries above the
//          inverse's diagonal are staged as zeros, never read.  Two
//          warps share each 4 rows: lane l of the first takes the columns
//          l and l + 96, of the second l + 32 and l + 64, so both run the
//          same depth; a 4 x 2 register tile, float4 loads along k, each
//          column dropped after its own diagonal.  Measured on an NVIDIA
//          H100 80GB HBM3 at 700.00 W (tools/probe_panel_kernel.py, every
//          panel step of n = 1536 and 1441): a step takes about one CTA's
//          latency, whatever its rows (1408 down to 33), since each CTA
//          stages the whole inverse (33 KB) before its last products:
//          0.0091-0.0096 ms at 16 rows per CTA, 0.0095-0.0109 at 8,
//          0.0111-0.0117 at 32, 0.0126-0.0151 at 4; torch.matmul of the
//          panel takes 0.0066-0.0108.
//   schur: S -= P . P^T on the lower triangle, b FMAs per output: at
//          n = 1536 the first step is 127 M FMAs (0.0038 ms at 67 TFLOP/s)
//          over 8.7 MB, so the FP32 FMA rate bounds it, and what a SIMT product
//          loses is shared-memory loads per FMA, staging and idle SMs.
//          One CTA per square output tile on or below the diagonal, by a
//          linear block index (no CTA exits unused).  The whole depth of a
//          tile's operands (its rows' and its columns' rows of P, as they
//          lie, k contiguous; a diagonal tile stages its rows once) comes by
//          16-byte cp.async (4-byte where the rows are not aligned) in four
//          k-stages, the products of a stage running while the later ones
//          arrive; rows padded to 132 floats.  A thread's rows are kTY apart
//          and its columns kTX apart, so that the 4 x 8 threads of a warp
//          read 4 and 8 neighbouring rows: one conflict-free 16-byte load
//          per 4 k of a row.  One accumulator per output, k ascending,
//          __fmaf_rn, one __fsub_rn from S (read ahead of the last stage's
//          products): the bits do not depend on the tiling.  A diagonal tile
//          skips the register sub-blocks that lie wholly above the diagonal
//          (a compile-time test on the register indices, no divergence); it
//          is not balanced further, since a step lasts as long as its
//          fullest SM, which holds full tiles.  `cols` limits the update to
//          the leading columns, which lets the panel loop run the next block
//          column ahead of the rest (ops/chol_cuda.py).
//          Two shapes, measured on an NVIDIA H100 80GB HBM3 at 700.00 W
//          (tools/probe_schur_kernel.py, every step of n = 1536 and 1441,
//          each launch alone behind a sleep).  64 x 64 tiles, 4 x 4 outputs
//          a thread, 256 threads: 253 tiles at t = 1408, 1.92 per SM, all
//          resident at once, 0.0128-0.0131 ms (8 x 4 outputs on 128 threads
//          took 158 registers and 0.0144; 128 x 64 tiles would give 132 CTAs
//          with the same two tiles' work on the fullest SM).  32 x 32 tiles,
//          4 x 2 outputs, 128 threads, while they put at most two tiles on
//          an SM (the next block column at every step, the whole update
//          from t = 640 down): a launch is then one tile's latency,
//          0.0053-0.0066 ms against 0.0085 at 64 x 64.  By clock64() stamps
//          (1.98 GHz) a full 64 x 64 tile of the first step, two on its SM,
//          spends ~1.5 us until its copies are queued (stage 0 has landed
//          0.1 us later: queuing them paces it, not the k-stages), ~1.8 us per
//          k-stage of products and ~1.3 us reading and writing S; a lone
//          32 x 32 tile 1.1, 0.5 each and 0.4.
//          Rows as 1-D bulk copies (cp.async.bulk, one per row and k-stage,
//          on mbarriers) were slower: 0.0239 ms at t = 1408, 0.0124 alone.

#include <cuda_runtime.h>

namespace {

constexpr int kTileThreads = 512;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kTileMax = 128;
constexpr int kSub = 32;          // sub-panel width: one warp's diagonal block
constexpr int kXtLd = kSub + 4;   // row stride of the transposed diagonal inverse
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPanelMaxRows = 32;               // rows per CTA: 4, 8, 16 or 32
constexpr int kPanelMaxThreads = 16 * kPanelMaxRows;  // two warps per 4 rows
constexpr int kPanelLd = kTileMax + 4;          // staged row stride: 33 float4s
constexpr int kStages = 4;        // k-stages of 32 columns each (panel, Schur)
constexpr int kSchurLd = kTileMax + 4;  // staged row stride, as kPanelLd

// A Schur CTA's shape: a kTile x kTile output tile, kRM x kRN outputs per
// thread, threads in a TY x TX grid of which a warp covers 4 x 8.
template <int kTile_, int kRM_, int kRN_>
struct SchurShape {
  static constexpr int kTile = kTile_, kRM = kRM_, kRN = kRN_;
  static constexpr int kTY = kTile / kRM, kTX = kTile / kRN, kThreads = kTY * kTX;
  static constexpr size_t kSmem = 2 * kTile * kSchurLd * sizeof(float);
  static_assert(kTY % 4 == 0 && kTX % 8 == 0, "a warp covers 4 x 8 threads");
};
using SchurBig = SchurShape<64, 4, 4>;    // where its tiles fill the card
using SchurSmall = SchurShape<32, 4, 2>;  // where a launch lasts one tile's latency

// Shared-memory row stride of the tile kernel: b rounded up to a multiple of
// 4 (rows stay 16-byte aligned for float4 loads) plus 4 (neighbouring rows
// start in different banks).
__host__ __device__ inline int tile_ld(int b) { return ((b + 3) & ~3) + 4; }

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// acc[p][q] += sum_{k < 4 nk4} A[p][k] . B[k][q], A's rows at a + p * lda
// (contiguous in k), B's rows at bm + k * ldb (contiguous in q); k ascending.
__device__ __forceinline__ void mma4x4_rows(float (&acc)[4][4], const float* a,
                                            int lda, const float* bm, int ldb,
                                            int nk4) {
  for (int k4 = 0; k4 < nk4; ++k4) {
    float4 ra[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) ra[p] = lds4(a + p * lda + 4 * k4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 rb = lds4(bm + (4 * k4 + kk) * ldb);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float av = lane_of(ra[p], kk);
        acc[p][0] = __fmaf_rn(av, rb.x, acc[p][0]);
        acc[p][1] = __fmaf_rn(av, rb.y, acc[p][1]);
        acc[p][2] = __fmaf_rn(av, rb.z, acc[p][2]);
        acc[p][3] = __fmaf_rn(av, rb.w, acc[p][3]);
      }
    }
  }
}

// One warp factors the w x w diagonal block at (c0, c0) of Ls (lower
// triangle read) and inverts the factor, in registers: lane i holds row i of
// the block in a[] and column i of its inverse in x[]; rows and columns past
// w are padded with the identity.  Column step j broadcasts the pivot and
// the pivot column with __shfl_sync; the same square root, division, FMA
// order and !(d > 0) test as the unblocked recurrence.  Writes L_pp (upper
// zeros) into Ls, X_pp into Xs and into the staging rows Bs[k][c0 + i], and
// X_pp^T into XT; raises *bad on a non-positive or NaN pivot.
__device__ __forceinline__ void factor_diag_block(float* Ls, float* Xs, float* Bs,
                                                  float* XT, int ld, int c0, int w,
                                                  int* bad) {
  const int i = threadIdx.x & 31;
  float a[kSub], x[kSub];
#pragma unroll
  for (int k = 0; k < kSub; ++k) {
    a[k] = (i < w && k <= i) ? Ls[(c0 + i) * ld + c0 + k] : (k == i ? 1.0f : 0.0f);
    x[k] = (k == i) ? 1.0f : 0.0f;
  }
  bool fail = false;
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    const float d = __shfl_sync(kFull, a[j], j);
    fail |= !(d > 0.0f);
    const float s = __fsqrt_rn(d);
    // Only the lanes that need a quotient divide: the others hold exact
    // zeros or stale upper entries, which send __fdiv_rn down its slow path.
    float lij;
    if (i > j) {
      lij = __fdiv_rn(a[j], s);
    } else {
      lij = (i == j) ? s : 0.0f;
      x[j] = __fdiv_rn(x[j], s);  // row j of the inverse is final
    }
    a[j] = lij;
#pragma unroll
    for (int k = j + 1; k < kSub; ++k) {
      const float lkj = __shfl_sync(kFull, lij, k);
      a[k] = __fmaf_rn(-lij, lkj, a[k]);  // A[i][k] -= L[i][j] L[k][j]
      x[k] = __fmaf_rn(-lkj, x[j], x[k]);  // X[k][i] -= L[k][j] X[j][i]
    }
  }
  if (i < w) {
#pragma unroll
    for (int k = 0; k < kSub; ++k) {
      if (k < w) {
        Ls[(c0 + i) * ld + c0 + k] = (k <= i) ? a[k] : 0.0f;
        Xs[(c0 + k) * ld + c0 + i] = x[k];  // X_pp[k][i]
        Bs[k * ld + c0 + i] = x[k];
      }
      XT[i * kXtLd + k] = x[k];  // XT[i][k] = X_pp[k][i]
    }
  }
  if (i == 0 && fail) *bad = 1;
}

// Lane blockIdx.x factors the tile at A + lane * lane_a (its lower triangle
// read) into L + lane * lane_l and inv + lane * lane_i.  A and L may be the
// same tile (in place): every read of A is done before the first write.
__global__ void __launch_bounds__(kTileThreads, 1)
potrf_tile_kernel(const float* A, long long lda, float* L, long long ldl,
                  float* __restrict__ inv, long long ldi, int b, long long lane_a,
                  long long lane_l, long long lane_i) {
  const long long tile = blockIdx.x;
  A += tile * lane_a;
  L += tile * lane_l;
  inv += tile * lane_i;
  extern __shared__ float4 smem4[];
  const int ld = tile_ld(b);
  const int b4 = (b + 3) & ~3;
  float* Ls = reinterpret_cast<float*>(smem4);  // b4 x ld: the tile, then L
  float* Xs = Ls + b4 * ld;   // b4 x ld: the inverse; below the current block
                              // row, the running sums Y = -sum_r L_ir X_rq
  float* Bs = Xs + b4 * ld;   // kSub x ld: the current block row's operands
  float* XT = Bs + kSub * ld; // kSub x kXtLd: X_pp^T
  __shared__ int bad;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (tid == 0) bad = 0;
  // The lower triangle by asynchronous 4-byte copies (all of a thread's
  // loads in flight at once), zeros everywhere else: the padding rows and
  // columns must read as zeros.
  for (int r = warp; r < b4; r += kTileWarps) {
    for (int c = lane; c < ld; c += 32) {
      if (r < b && c <= r) {
        const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(Ls + r * ld + c));
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                     "l"(A + r * lda + c));
      } else {
        Ls[r * ld + c] = 0.0f;
      }
      Xs[r * ld + c] = 0.0f;
    }
  }
  for (int e = tid; e < kSub * ld + kSub * kXtLd; e += kTileThreads) Bs[e] = 0.0f;
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  for (int c0 = 0; c0 < b; c0 += kSub) {
    const int w = min(kSub, b - c0);
    const int R0 = c0 + w;  // first row below the block; R0 < b only if w == kSub
    // D: the diagonal block, one warp.
    if (warp == 0) factor_diag_block(Ls, Xs, Bs, XT, ld, c0, w, &bad);
    __syncthreads();

    // S: (a) L21 = A21 . X_pp^T, stored transposed in Bs[c][r] (r >= R0);
    //    (b) X_pq = X_pp . Y_pq for the columns c < c0, stored in Bs[i][c].
    // X_pp is lower-triangular, so (a) stops at depth c and (b) at depth i.
    const int na = R0 < b ? ((b - R0 + 3) / 4) * (kSub / 4) : 0;
    const int nbc = c0 / 4;
    const int nb = ((w + 3) / 4) * nbc;
    for (int t = tid; t < na + nb; t += kTileThreads) {
      float acc[4][4] = {};
      if (t < na) {
        const int I = t / (kSub / 4), J = t % (kSub / 4);
        const int r0 = R0 + 4 * I, cc = 4 * J;
        mma4x4_rows(acc, Ls + r0 * ld + c0, ld, XT + cc, kXtLd, J + 1);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          if (r0 + p < b) {
#pragma unroll
            for (int q = 0; q < 4; ++q) Bs[(cc + q) * ld + r0 + p] = acc[p][q];
          }
        }
      } else {
        const int u = t - na;
        const int I = u / nbc, J = u % nbc;
        const int i0 = 4 * I, cc = 4 * J;
        mma4x4_rows(acc, Xs + (c0 + i0) * ld + c0, ld, Xs + c0 * ld + cc, ld, I + 1);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          if (i0 + p < w) {
#pragma unroll
            for (int q = 0; q < 4; ++q) Bs[(i0 + p) * ld + cc + q] = acc[p][q];
          }
        }
      }
    }
    __syncthreads();

    // U: for the rows r >= R0, one product of depth kSub with the staged
    // block row B = [X_p,<R0 | L21^T]: Y[r][c] -= L21[r] . B[:, c] for
    // c < R0, A22[r][c] -= L21[r] . L21[c] for R0 <= c <= r.  4 x 4 tiles of
    // the lower region; row block I holds R0 / 4 + 1 + I of them.
    if (R0 < b) {
      const int base = R0 / 4 + 1;
      const int nI = (b - R0 + 3) / 4;
      const int nU = nI * base + nI * (nI - 1) / 2;
      for (int t = tid; t < nU; t += kTileThreads) {
        int I = 0, u = t;
        while (u >= base + I) {
          u -= base + I;
          ++I;
        }
        const int r0 = R0 + 4 * I, cc = 4 * u;
        float acc[4][4] = {};
#pragma unroll 8
        for (int k = 0; k < kSub; ++k) {
          const float4 ra = lds4(Bs + k * ld + r0);
          const float4 rb = lds4(Bs + k * ld + cc);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const float av = lane_of(ra, p);
            acc[p][0] = __fmaf_rn(av, rb.x, acc[p][0]);
            acc[p][1] = __fmaf_rn(av, rb.y, acc[p][1]);
            acc[p][2] = __fmaf_rn(av, rb.z, acc[p][2]);
            acc[p][3] = __fmaf_rn(av, rb.w, acc[p][3]);
          }
        }
        float* dst = cc < R0 ? Xs : Ls;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int r = r0 + p;
          if (r >= b) continue;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = cc + q;
            if (c <= r) dst[r * ld + c] = __fsub_rn(dst[r * ld + c], acc[p][q]);
          }
        }
      }
      // L21 to its place (U reads it only from Bs).
      for (int r = R0 + warp; r < b; r += kTileWarps) Ls[r * ld + c0 + lane] = Bs[lane * ld + r];
    }
    // The block row X_p,<c0 to its place (U reads it only from Bs).
    for (int k = warp; k < w; k += kTileWarps) {
      for (int c = lane; c < c0; c += 32) Xs[(c0 + k) * ld + c] = Bs[k * ld + c];
    }
    __syncthreads();
  }

  const bool fail = bad != 0;
  const float nan = __int_as_float(0x7fc00000);
  for (int r = warp; r < b; r += kTileWarps) {
    for (int c = lane; c < b; c += 32) {
      float lv = (c <= r) ? Ls[r * ld + c] : 0.0f;
      float xv = (c <= r) ? Xs[r * ld + c] : 0.0f;
      if (fail) {
        lv = nan;
        xv = nan;
      }
      L[r * ldl + c] = lv;
      inv[r * ldi + c] = xv;
    }
  }
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

// acc[p][j] += sum_k R[p][k] . I_j[k] over the chunks [k4_begin, k4_end),
// for the lane's two columns from j = J0 on (column 0 is done when J0 = 1);
// k ascending, as the plain product sums.
template <int J0>
__device__ __forceinline__ void panel_segment(float (&acc)[4][2], const float* Rw,
                                              const float* I0, const float* I1,
                                              int k4_begin, int k4_end) {
  for (int k4 = k4_begin; k4 < k4_end; ++k4) {
    float4 ra[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) ra[p] = lds4(Rw + p * kPanelLd + 4 * k4);
#pragma unroll
    for (int j = J0; j < 2; ++j) {
      const float4 rb = lds4((j == 0 ? I0 : I1) + 4 * k4);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        acc[p][j] = __fmaf_rn(ra[p].x, rb.x, acc[p][j]);
        acc[p][j] = __fmaf_rn(ra[p].y, rb.y, acc[p][j]);
        acc[p][j] = __fmaf_rn(ra[p].z, rb.z, acc[p][j]);
        acc[p][j] = __fmaf_rn(ra[p].w, rb.w, acc[p][j]);
      }
    }
  }
}

// The chunks [lo, hi) of the lane's two columns: both up to e0 (the end of
// column 0's chunks), column 1 alone from there up to e1.
__device__ __forceinline__ void panel_chunks(float (&acc)[4][2], const float* Rw,
                                             const float* I0, const float* I1, int lo,
                                             int hi, int e0, int e1) {
  if (lo < min(hi, e0)) panel_segment<0>(acc, Rw, I0, I1, lo, min(hi, e0));
  if (max(lo, e0) < min(hi, e1)) panel_segment<1>(acc, Rw, I0, I1, max(lo, e0), min(hi, e1));
}

// Waits for the staging of k-stage S (of kStages) and makes it visible.
template <int S>
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1 - S));
  __syncthreads();
}

// P = A_panel . Minv^T for the `rows` rows below the diagonal block, in
// place; also zeroes the upper strip entries strip[c][row] (the transposed
// position of every panel entry), which the TPU kernel zeroes per panel.
// Only the lower triangle of Minv is read.  CTA i owns the rows
// [i * rpc, (i + 1) * rpc), with 16 * rpc threads; vec_a / vec_inv say that
// the panel's / the inverse's rows start on 16-byte boundaries.
__global__ void __launch_bounds__(kPanelMaxThreads)
potrf_panel_kernel(float* __restrict__ A, long long lda,
                   const float* __restrict__ inv, long long ldi,
                   float* __restrict__ strip, int rows, int b, int rpc,
                   int vec_a, int vec_inv) {
  extern __shared__ float4 smem4[];
  float* Is = reinterpret_cast<float*>(smem4);  // kTileMax x kPanelLd: Minv
  float* Rs = Is + kTileMax * kPanelLd;         // rpc x kPanelLd: this CTA's rows
  const int tid = threadIdx.x, nwarps = blockDim.x >> 5;
  const int lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * rpc;
  const int nr = min(rpc, rows - row0);
  const int nk4 = (b + 3) / 4;
  // Staged in 4 k-stages of 8 chunks (one cp.async group each), so that the
  // products of a stage run while the later ones arrive: in stage st, lane
  // l copies chunk 8 st + l % 8 of row l / 8 of every 4 rows.  Row c of
  // Minv up to the chunk of its diagonal; the rows c >= b (the columns past
  // b of a lane's pair) as zeros up to column b.
  const int k4s = lane & 7, rsub = lane >> 3;
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    const int k4 = 8 * st + k4s;
    for (int c = 32 * st + 4 * warp + rsub; c < kTileMax; c += 4 * nwarps) {
      if (4 * k4 <= min(c, b - 1)) {
        const int valid = c < b ? min(4, c + 1 - 4 * k4) : 0;
        stage_chunk(Is + c * kPanelLd + 4 * k4, inv + c * ldi + 4 * k4, valid, vec_inv);
      }
    }
    for (int r = 4 * warp + rsub; r < rpc; r += 4 * nwarps) {
      if (k4 < nk4) {
        const int valid = r < nr ? min(4, b - 4 * k4) : 0;
        stage_chunk(Rs + r * kPanelLd + 4 * k4, A + (row0 + r) * lda + 4 * k4, valid,
                    vec_a);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }

  const int r0 = 4 * (warp >> 1), h = warp & 1;
  const int c0 = lane + 32 * h, c1 = lane + 96 - 32 * h;  // c0 < c1
  const float* Rw = Rs + r0 * kPanelLd;
  const float* I0 = Is + c0 * kPanelLd;
  const float* I1 = Is + c1 * kPanelLd;
  // Both columns up to the chunk of c0's diagonal, then c1 alone up to its
  // own (the entries past a diagonal are staged zeros).
  const int e0 = c0 < b ? c0 / 4 + 1 : 0;
  const int e1 = c1 < b ? c1 / 4 + 1 : e0;
  float acc[4][2] = {};
  stage_wait<0>();
  panel_chunks(acc, Rw, I0, I1, 0, 8, e0, e1);
  stage_wait<1>();
  panel_chunks(acc, Rw, I0, I1, 8, 16, e0, e1);
  stage_wait<2>();
  panel_chunks(acc, Rw, I0, I1, 16, 24, e0, e1);
  stage_wait<3>();
  panel_chunks(acc, Rw, I0, I1, 24, 32, e0, e1);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    if (r0 + p >= nr) break;
    float* out = A + (row0 + r0 + p) * lda;
    if (c0 < b) out[c0] = acc[p][0];
    if (c1 < b) out[c1] = acc[p][1];
  }
  for (int c = warp; c < b; c += nwarps) {
    if (lane < nr) strip[c * lda + row0 + lane] = 0.0f;
  }
}

// acc[p][q] += sum_k A[p][k] . B[q][k] over the chunks [k4_begin, k4_end) of
// 4 k each, for the thread's rows Aw + p * kTY rows and columns
// Bw + q * kTX rows; k ascending.  With kDiag (a diagonal tile) the
// sub-blocks (p, q) whose every row lies above every column are skipped.
template <class Sh, bool kDiag>
__device__ __forceinline__ void schur_chunks(float (&acc)[Sh::kRM][Sh::kRN],
                                             const float* Aw, const float* Bw,
                                             int k4_begin, int k4_end) {
  for (int k4 = k4_begin; k4 < k4_end; ++k4) {
    float4 ra[Sh::kRM];
#pragma unroll
    for (int p = 0; p < Sh::kRM; ++p) ra[p] = lds4(Aw + p * Sh::kTY * kSchurLd + 4 * k4);
#pragma unroll
    for (int q = 0; q < Sh::kRN; ++q) {
      const float4 rb = lds4(Bw + q * Sh::kTX * kSchurLd + 4 * k4);
#pragma unroll
      for (int p = 0; p < Sh::kRM; ++p) {
        if (kDiag && Sh::kTY * p + Sh::kTY - 1 < Sh::kTX * q) continue;
        acc[p][q] = __fmaf_rn(ra[p].x, rb.x, acc[p][q]);
        acc[p][q] = __fmaf_rn(ra[p].y, rb.y, acc[p][q]);
        acc[p][q] = __fmaf_rn(ra[p].z, rb.z, acc[p][q]);
        acc[p][q] = __fmaf_rn(ra[p].w, rb.w, acc[p][q]);
      }
    }
  }
}

// One tile's products and its update of S: the thread's outputs are the rows
// gi0 + p * kTY and the columns gj0 + q * kTX; it owns those with
// column <= row, row < t and column < cols.
template <class Sh, bool kDiag>
__device__ __forceinline__ void schur_tile(float* __restrict__ S, long long lds,
                                           const float* Aw, const float* Bw, int gi0,
                                           int gj0, int t, int cols, int nk4) {
  float acc[Sh::kRM][Sh::kRN] = {};
  float sv[Sh::kRM][Sh::kRN];
  stage_wait<0>();
  schur_chunks<Sh, kDiag>(acc, Aw, Bw, 0, min(8, nk4));
  stage_wait<1>();
  schur_chunks<Sh, kDiag>(acc, Aw, Bw, 8, min(16, nk4));
  stage_wait<2>();
  schur_chunks<Sh, kDiag>(acc, Aw, Bw, 16, min(24, nk4));
  // S's entries, ahead of the last stage's products.
#pragma unroll
  for (int p = 0; p < Sh::kRM; ++p) {
    const int gi = gi0 + p * Sh::kTY;
#pragma unroll
    for (int q = 0; q < Sh::kRN; ++q) {
      const int gj = gj0 + q * Sh::kTX;
      sv[p][q] = (gi < t && gj <= gi && gj < cols) ? S[gi * lds + gj] : 0.0f;
    }
  }
  stage_wait<3>();
  schur_chunks<Sh, kDiag>(acc, Aw, Bw, 24, min(32, nk4));
#pragma unroll
  for (int p = 0; p < Sh::kRM; ++p) {
    const int gi = gi0 + p * Sh::kTY;
#pragma unroll
    for (int q = 0; q < Sh::kRN; ++q) {
      const int gj = gj0 + q * Sh::kTX;
      if (gi < t && gj <= gi && gj < cols) S[gi * lds + gj] = __fsub_rn(sv[p][q], acc[p][q]);
    }
  }
}

// S -= P . P^T on the lower triangle of the (t, t) trailing block S, columns
// [0, cols), with P the (t, b) panel; S's upper triangle and its columns from
// `cols` on are not touched.  Block i takes the i-th tile on or below the
// diagonal: the rows of tiles bi < ncb hold bi + 1 tiles, the rows below
// them ncb each (ncb: the tile columns that `cols` spans).  vec says that
// P's rows start on 16-byte boundaries.
template <class Sh>
__global__ void __launch_bounds__(Sh::kThreads)
potrf_schur_kernel(float* __restrict__ S, long long lds,
                   const float* __restrict__ P, long long ldp, int t, int b, int cols,
                   int vec) {
  constexpr int kTile = Sh::kTile;
  extern __shared__ float4 smem4[];
  const int ncb = (cols + kTile - 1) / kTile;
  const int tri = ncb * (ncb + 1) / 2;
  const int idx = blockIdx.x;
  int bi, bj;
  if (idx < tri) {
    bi = static_cast<int>((sqrtf(8.0f * idx + 1.0f) - 1.0f) * 0.5f);
    while (bi * (bi + 1) / 2 > idx) --bi;
    while ((bi + 1) * (bi + 2) / 2 <= idx) ++bi;
    bj = idx - bi * (bi + 1) / 2;
  } else {
    bi = ncb + (idx - tri) / ncb;
    bj = (idx - tri) % ncb;
  }
  const bool diag = bi == bj;
  float* As = reinterpret_cast<float*>(smem4);       // kTile x kSchurLd: the rows' P
  float* Bs = diag ? As : As + kTile * kSchurLd;     // the columns' P
  const int tid = threadIdx.x;
  const int i0 = bi * kTile, j0 = bj * kTile;
  const int nk4 = (b + 3) / 4;
  // Stage st: the chunks [8 st, 8 st + 8) of every row, 8 neighbouring
  // threads on one row's 128 bytes; rows past t as zeros.
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    for (int e = tid; e < 8 * kTile; e += Sh::kThreads) {
      const int r = e >> 3, k4 = 8 * st + (e & 7);
      if (k4 >= nk4) continue;
      const int valid = min(4, b - 4 * k4);
      stage_chunk(As + r * kSchurLd + 4 * k4, P + (i0 + r) * ldp + 4 * k4,
                  i0 + r < t ? valid : 0, vec);
      if (!diag) {
        stage_chunk(Bs + r * kSchurLd + 4 * k4, P + (j0 + r) * ldp + 4 * k4,
                    j0 + r < t ? valid : 0, vec);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  // Warp w covers the 4 x 8 threads at (4 (w / (kTX / 8)), 8 (w % (kTX / 8))).
  const int lane = tid & 31, warp = tid >> 5;
  const int ty = 4 * (warp / (Sh::kTX / 8)) + (lane >> 3);
  const int tx = 8 * (warp % (Sh::kTX / 8)) + (lane & 7);
  const float* Aw = As + ty * kSchurLd;
  const float* Bw = Bs + tx * kSchurLd;
  if (diag) {
    schur_tile<Sh, true>(S, lds, Aw, Bw, i0 + ty, j0 + tx, t, cols, nk4);
  } else {
    schur_tile<Sh, false>(S, lds, Aw, Bw, i0 + ty, j0 + tx, t, cols, nk4);
  }
}

size_t tile_smem(int b) {
  const size_t b4 = (b + 3) & ~3;
  return ((2 * b4 + kSub) * tile_ld(b) + kSub * kXtLd) * sizeof(float);
}
size_t panel_smem(int rpc) {
  return static_cast<size_t>(kTileMax + rpc) * kPanelLd * sizeof(float);
}

// Launches the Schur kernel at shape Sh.
template <class Sh>
int launch_schur(float* S, long long lds, const float* P, long long ldp, int t, int b,
                 int cols, int vec, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        potrf_schur_kernel<Sh>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Sh::kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int nrb = (t + Sh::kTile - 1) / Sh::kTile;
  const int ncb = (cols + Sh::kTile - 1) / Sh::kTile;
  const int tiles = ncb * (ncb + 1) / 2 + (nrb - ncb) * ncb;
  potrf_schur_kernel<Sh><<<tiles, Sh::kThreads, Sh::kSmem, s>>>(S, lds, P, ldp, t, b, cols,
                                                                 vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes.  Each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError() (0 = launched),
// or cudaErrorInvalidValue for a shape it does not take.

// The tile kernel on `lanes` tiles in one launch, one CTA each: lane k reads
// A + k * lane_a and writes L + k * lane_l and inv + k * lane_i, bit-equal
// to the single launch on that tile (the same code on the lane's operands).
extern "C" int cim_potrf_tile_f32_batched(const float* A, long long lda,
                                          long long lane_a, float* L,
                                          long long ldl, long long lane_l,
                                          float* inv, long long ldi,
                                          long long lane_i, int b, int lanes,
                                          void* stream) {
  if (b < 1 || b > kTileMax || lanes < 1) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        potrf_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(tile_smem(kTileMax)));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  potrf_tile_kernel<<<lanes, kTileThreads, tile_smem(b), s>>>(
      A, lda, L, ldl, inv, ldi, b, lane_a, lane_l, lane_i);
  return static_cast<int>(cudaGetLastError());
}

// One tile in place (the panel loop's and the tile engine's single launch).
extern "C" int cim_potrf_tile_f32(float* A, long long lda, float* inv,
                                  long long ldi, int b, void* stream) {
  return cim_potrf_tile_f32_batched(A, lda, 0, A, lda, 0, inv, ldi, 0, b, 1,
                                    stream);
}

extern "C" int cim_potrf_panel_f32(float* A, long long lda, const float* inv,
                                   long long ldi, float* strip, int rows, int b,
                                   int rows_per_cta, int vec_a, int vec_inv,
                                   void* stream) {
  const int rpc = rows_per_cta;
  if (b < 1 || b > kTileMax || rows < 1 || rpc < 4 || rpc > kPanelMaxRows || rpc % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        potrf_panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(panel_smem(kPanelMaxRows)));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (rows + rpc - 1) / rpc;
  potrf_panel_kernel<<<blocks, 16 * rpc, panel_smem(rpc), s>>>(
      A, lda, inv, ldi, strip, rows, b, rpc, vec_a, vec_inv);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cim_potrf_schur_f32(float* S, long long lds, const float* P,
                                   long long ldp, int t, int b, int cols, int vec_p,
                                   void* stream) {
  if (b < 1 || b > kTileMax || t < 1 || cols < 1 || cols > t)
    return static_cast<int>(cudaErrorInvalidValue);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The small shape while it puts at most two tiles on an SM.
  const int nrb = (t + SchurSmall::kTile - 1) / SchurSmall::kTile;
  const int ncb = (cols + SchurSmall::kTile - 1) / SchurSmall::kTile;
  const int small_tiles = ncb * (ncb + 1) / 2 + (nrb - ncb) * ncb;
  if (small_tiles <= 2 * sms)
    return launch_schur<SchurSmall>(S, lds, P, ldp, t, b, cols, vec_p, s);
  return launch_schur<SchurBig>(S, lds, P, ldp, t, b, cols, vec_p, s);
}
