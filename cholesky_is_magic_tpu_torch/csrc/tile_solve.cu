// The tile engine's blocked triangular solves for Hopper (sm_90a), f32.
//
// Replaces no TPU kernel: the JAX package's tile engine solves with plain
// jnp (cholesky_is_magic_tpu/sparse/tiled.py, a lax.fori_loop of gathers and
// einsums per panel that XLA fuses on the TPU).  Run eagerly in PyTorch that
// loop is ~14 small launches a panel, issued one by one by the host: at
// PDS-10's 137 panels the host took ~60 ms a solve for 7 ms of card work,
// and at QAP15's 52 panels the gathers copied ~21 tiles a panel a lane
// before multiplying them.  This kernel runs one whole pass, for every lane,
// in one launch:
//
//     forward   y[k] = Dinv[k] (r[k] - sum_j L[k, j] y[j])       k = 0 .. B-1
//     backward  z[k] = Dinv[k]^T (y[k] - sum_i L[i, k]^T z[i])   k = B-1 .. 0
//
// where Dinv[k] is the stored inverse of panel k's diagonal factor tile
// (lower triangular: only its lower triangle is read) and the sums run over
// the resident off-diagonal tiles of block row k (forward) or block column k
// (backward), in the engine's list order.
//
// What bounds it on the H100: the bytes of L.  A pass reads every
// off-diagonal tile once and half of every inverse tile, 4 bytes an entry,
// for 2 operations an entry: far below the card's 20 operations a byte.  But
// the B panel steps of a pass form a chain (step k needs y of earlier
// panels), so a kernel that loads a step's tiles only when it reaches the
// step runs at the latency of B round trips to memory, not at its bandwidth.
//
// Design:
// - One thread-block cluster of C CTAs per lane (grid: C x lanes).  CTA c of
//   a lane owns the b / C rows [c R, c R + R) of every block row (forward)
//   or those columns of every block column (backward), so the CTAs of a
//   cluster split every tile's bytes evenly and never combine partial sums:
//   each output entry is computed by one thread chain, whatever C is.  C is
//   the largest of 8, 4, 2, 1 for which every lane's cluster is resident at
//   once (cudaOccupancyMaxActiveClusters), so 32 or 64 lanes still fill the
//   card's SMs; R is a multiple of 16 and at most 128.
// - L's tiles do not depend on the chain, so each CTA streams its share of
//   the pass's tiles and inverse tiles, in the order it will use them, by
//   16-byte cp.async into a ring of kDepth slots of 32 KB, kDepth - 1 of them
//   in flight while one is read: while a CTA waits for the other CTAs of its
//   cluster at a panel step, the next steps' tiles are on their way.  One
//   CTA barrier a piece: the slot the piece before used is refilled after
//   it.  (Bulk copies, one per row of a backward piece, ran slower.)
// - Per panel step: the step's vectors (y[j] or z[i], written by the
//   cluster's CTAs at earlier steps) are read from the L2 cache into shared
//   memory; each thread extends its chains, held in registers through the
//   step, over the ring's pieces with 16-byte shared loads; the CTA's slice
//   of r[k] - sum (or y[k] - sum) goes to every CTA of the cluster by
//   st.async into distributed shared memory, counted on each CTA's mbarrier;
//   each CTA waits for its whole vector there, applies its rows (columns) of
//   the inverse tile to it and writes its slice of y[k] (z[k]); one cluster
//   barrier a panel step, which makes y[k] visible and frees the vector.
//   (A second cluster barrier in place of the mbarrier, with its release
//   of the memory operations before it, cost ~1.3k cycles a step.)
// - The butterflies run unconditionally on 8 or 16 rows at once: a shuffle
//   under a per-row condition cost a convergence barrier each, ~100 cycles
//   (on an H100 a forward panel step of PDS-10's engine took 24k cycles
//   with them, 16k without).
// - Products are FP32 FMAs (a matrix-vector product has no tensor-core form,
//   and TF32 stays off).
//
// Fixed summation order, so the kernel is tested bit for bit against
// sparse.tiled_cuda.tile_solve_plain.  Every dot product over an index q of
// a tile is split into 32 partials: forward (q a column of block row k)
// partial l takes q = 128 u + 4 l + j, backward (q a row of block column k)
// partial l takes q = 32 u + l.  Partial l is one chain of __fmaf_rn from
// zero, over the step's tiles in list order and its q ascending within
// each; the 32 partials are added by a butterfly (l ^ 16, 8, 4, 2, 1:
// partial l plus partial l + 16, ...).  Then one subtraction from r[k]
// (y[k]), none where the step has no tile.  The inverse tile's product is
// split the same way over q <= i (forward, row i) or q >= p (backward,
// column p), without the subtraction.  The build has --fmad=false, and
// every FMA is explicit.
//
// Lanes whose L is not finite give NaN and do not fault (the dbound retry
// selects them away).  Each lane's tiles, inverses and right-hand side lie
// at their own lane stride (0 shares one), each lane row-major; a lane's
// cluster runs the single launch's code on the lane, so every lane is
// bit-equal to the single launch on it.

#include <initializer_list>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlot = 8192;      // floats a ring slot (32 KB)
constexpr int kDepth = 5;        // ring slots: the one being read and the next ones in flight
constexpr int kVec = 2048;       // floats of the step's vectors held at once
constexpr int kMaxSlice = 128;   // rows (columns) a CTA owns
constexpr int kMaxB = 256;
constexpr int kMaxCluster = 8;
constexpr int kPart = 32 * (kMaxSlice + 4);
constexpr size_t kSmem =
    (static_cast<size_t>(kDepth) * kSlot + kPart + kMaxB + kVec + kMaxSlice) * sizeof(float) +
    sizeof(unsigned long long);

struct Pass {
  const float* L;                // (NT + 1, b, b) a lane, row-major
  long long L_lane;
  const float* inv;              // (B, b, b) a lane, row-major
  long long inv_lane;
  const float* rhs;              // (B b) a lane
  long long rhs_lane;
  float* out;                    // (B b) a lane, lanes B b apart
  const long long* ids;          // (B, width): a panel step's tiles
  const long long* idx;          // (B, width): the panel of each tile's vector
  const long long* counts;       // (B): tiles a panel step
  long long width;
  int b, B;
};

// The pieces of one CTA's pass: per panel step, each tile's slice then the
// inverse tile's, each cut into pieces of at most kSlot floats.
struct Geo {
  int b, B, R, s0, P, tile_pieces, inv_pieces, inv_rows;
};

struct Cursor {
  int n, t, h, nt;  // n-th panel step, item t (t == nt: the inverse), piece h
};

__device__ __forceinline__ int step_of(bool fwd, int B, int n) { return fwd ? n : B - 1 - n; }

__device__ __forceinline__ int count_of(const Pass& a, int k) {
  return static_cast<int>(__ldg(a.counts + k));
}

__device__ __forceinline__ void advance(Cursor& c, const Geo& g, const Pass& a, bool fwd) {
  const int pieces = c.t < c.nt ? g.tile_pieces : g.inv_pieces;
  if (++c.h < pieces) return;
  c.h = 0;
  if (++c.t <= c.nt) return;
  c.t = 0;
  if (++c.n < g.B) c.nt = count_of(a, step_of(fwd, g.B, c.n));
}

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The piece at cursor c of this CTA's pass into `slot` (nothing past the
// last step), 16 bytes a thread at a time.  Forward pieces are P whole rows
// of the CTA's row slice; backward pieces are P rows of its column slice, R
// floats a row.  Of an inverse tile only the 16-byte chunks that hold a
// lower-triangle entry of the CTA's rows (columns) are copied.
template <bool kFwd>
__device__ __forceinline__ void stage(float* slot, const Cursor& c, const Geo& g, const Pass& a,
                                      const float* Ll, const float* Il) {
  if (c.n >= g.B) return;
  const int k = step_of(kFwd, g.B, c.n), b = g.b, R = g.R;
  const long long bb = static_cast<long long>(b) * b;
  const bool tile = c.t < c.nt;
  const float* base = tile ? Ll + __ldg(a.ids + k * a.width + c.t) * bb : Il + k * bb;
  if (kFwd && tile) {
    const int r0 = g.s0 + c.h * g.P, rows = min(g.P, R - c.h * g.P);
    const float* src = base + static_cast<long long>(r0) * b;
    for (int e = threadIdx.x; e < rows * (b / 4); e += kThreads) cp16(slot + 4 * e, src + 4 * e);
    return;
  }
  // Row r of the piece is row r0 + r of the tile, from column c0; ld floats a
  // staged row; q4 chunks a row.  A thread's chunks are kThreads apart.
  const int r0 = kFwd ? g.s0 + c.h * g.P : (tile ? 0 : g.s0) + c.h * g.P;
  const int rows = kFwd ? min(g.P, R - c.h * g.P) : min(g.P, (tile ? b : g.inv_rows) - c.h * g.P);
  const int c0 = kFwd ? 0 : g.s0, ld = kFwd ? b : R, q4 = ld / 4;
  const int dr = kThreads / q4, dc = kThreads - dr * q4;
  int r = threadIdx.x / q4, c4 = threadIdx.x - r * q4;
  while (r < rows) {
    if ((!kFwd && tile) || c0 + 4 * c4 <= r0 + r) {
      cp16(slot + r * ld + 4 * c4, base + static_cast<long long>(r0 + r) * b + c0 + 4 * c4);
    }
    r += dr;
    c4 += dc;
    if (c4 >= q4) {
      c4 -= q4;
      ++r;
    }
  }
}

// The butterfly over the 32 lanes of s[0 .. N), all at once and
// unconditionally (a shuffle under a condition the compiler cannot see is
// warp-uniform costs a convergence barrier each).
template <int N>
__device__ __forceinline__ void butterflies(float* s) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) s[j] = __fadd_rn(s[j], __shfl_xor_sync(0xffffffffu, s[j], m));
  }
}

// The butterflies of the first n (1 to 16, the same in every lane) of s.
__device__ __forceinline__ void butterflies16(float (&s)[16], int n) {
  butterflies<8>(s);
  if (n > 8) butterflies<8>(s + 8);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of CTA `rank`'s copy of the shared address a.
__device__ __forceinline__ unsigned cluster_addr(unsigned a, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(a), "r"(rank));
  return out;
}

// x to the shared::cluster address a, its 4 bytes counted on the mbarrier
// at cluster address bar (of the same CTA).
__device__ __forceinline__ void st_async(unsigned a, float x, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
                   a),
               "r"(__float_as_uint(x)), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void bar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

constexpr int kRows = kMaxSlice / kWarps;              // slice rows a warp takes
constexpr int kQuads = 32 * (kMaxSlice / 4) / kThreads;  // (4 columns, l) a thread takes
static_assert(kRows == 16, "butterflies16 takes 16 rows");

// Forward: warp w takes the slice rows w, w + 8, ..., lane l the entries
// q = 128 u + 4 l + j (j = 0 .. 3) of each, a 16-byte load at a time.
// Backward: thread t takes the quads (4 neighbouring columns, partial l)
// numbered t, t + 256, ..., each over its rows q = l + 32 u.  A thread keeps
// its chains in registers through a panel step, extending all of them one
// step at a time, so the loads and FMAs of its rows (quads) overlap.
template <bool kFwd>
__device__ __forceinline__ void solve_pass(const Pass& a) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* part = ring + kDepth * kSlot;  // backward: the chains' partials, for the butterflies
  float* acc = part + kPart;            // the whole r[k] - sum (y[k] - sum)
  float* vec = acc + kMaxB;             // the step's vectors
  float* rv = vec + kVec;               // the CTA's slice of r[k] (y[k])
  // Completes a phase a panel step, when all of acc has come.
  auto* acc_bar = reinterpret_cast<unsigned long long*>(rv + kMaxSlice);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = a.b, B = a.B, vmax = kVec / b;
  const int tid = threadIdx.x, warp = tid / 32, ln = tid % 32;
  const long long lane = blockIdx.y;
  const float* Ll = a.L + lane * a.L_lane;
  const float* Il = a.inv + lane * a.inv_lane;
  const float* rl = a.rhs + lane * a.rhs_lane;
  float* ol = a.out + lane * static_cast<long long>(B) * b;
  // Lane l < C sends acc entries to CTA l of the cluster, counted on its
  // acc_bar.
  const unsigned remote_acc = cluster_addr(smem_addr(acc), ln < C ? ln : 0);
  const unsigned remote_bar = cluster_addr(smem_addr(acc_bar), ln < C ? ln : 0);

  Geo g;
  g.b = b;
  g.B = B;
  g.R = b / C;
  g.s0 = rank * g.R;
  if (kFwd) {
    g.P = min(g.R, (kSlot / b) & ~7);
    g.tile_pieces = g.inv_pieces = (g.R + g.P - 1) / g.P;
    g.inv_rows = g.R;
  } else {
    g.P = min(b, (kSlot / g.R) & ~31);
    g.tile_pieces = (b + g.P - 1) / g.P;
    g.inv_rows = b - g.s0;
    g.inv_pieces = (g.inv_rows + g.P - 1) / g.P;
  }
  const int R = g.R, s0 = g.s0, P = g.P, ld = R + 4;
  const int mine = (R - warp + kWarps - 1) / kWarps;  // slice rows (columns) of this warp
  int ql[kQuads], qc[kQuads];                          // a quad's l and first column
  bool qv[kQuads];
#pragma unroll
  for (int m = 0; m < kQuads; ++m) {
    const int pi = tid + kThreads * m;
    qv[m] = pi < 8 * R;
    ql[m] = pi / (R / 4);
    qc[m] = 4 * (pi - ql[m] * (R / 4));
  }

  Cursor issue{0, 0, 0, count_of(a, step_of(kFwd, B, 0))};
#pragma unroll 1
  for (int s = 0; s < kDepth; ++s) {
    stage<kFwd>(ring + s * kSlot, issue, g, a, Ll, Il);
    advance(issue, g, a, kFwd);
    commit();
  }
  int slot = 0;
  bool refill = false;
  // One ring piece: wait for it; refill the slot the piece before it used
  // with the piece kDepth after that one; read it.
  auto next_piece = [&](auto&& use) {
    wait_pending<kDepth - 2>();
    __syncthreads();
    if (refill) {
      const int last = slot == 0 ? kDepth - 1 : slot - 1;
      stage<kFwd>(ring + last * kSlot, issue, g, a, Ll, Il);
      advance(issue, g, a, kFwd);
    }
    commit();
    refill = true;
    use(ring + slot * kSlot);
    slot = slot + 1 == kDepth ? 0 : slot + 1;
  };
  // Thread t < R holds entry t of the next step's slice of r (y), read a
  // step ahead.
  float r_next = tid < R ? rl[static_cast<long long>(step_of(kFwd, B, 0)) * b + s0 + tid] : 0.0f;
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(acc_bar)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Every CTA of the cluster runs, its acc_bar ready, before any writes to
  // another's memory.
  cluster_sync();

#pragma unroll 1
  for (int n = 0; n < B; ++n) {
    const int k = step_of(kFwd, B, n), nt = count_of(a, k);
    const long long kb = static_cast<long long>(k) * b;
    // This step's acc: b floats from the cluster's CTAs.  (Every CTA is past
    // the last step's barrier, so no byte of this step has come before the
    // last phase completed.)
    if (tid == 0) bar_expect(smem_addr(acc_bar), 4u * b);
    if (tid < R) {
      rv[tid] = r_next;
      if (n + 1 < B) r_next = rl[static_cast<long long>(step_of(kFwd, B, n + 1)) * b + s0 + tid];
    }
    float s[kRows];   // forward: slice rows warp + 8 j
    float sb[kQuads][4];  // backward: quads
#pragma unroll
    for (int j = 0; j < kRows; ++j) s[j] = 0.0f;
#pragma unroll
    for (int m = 0; m < kQuads; ++m) sb[m][0] = sb[m][1] = sb[m][2] = sb[m][3] = 0.0f;
#pragma unroll 1
    for (int t = 0; t < nt; ++t) {
      if (t % vmax == 0) {
        // The vectors of tiles t .. t + vmax - 1, from the L2 cache: the
        // cluster's CTAs wrote them at earlier steps.
        if (t > 0) __syncthreads();
        const int tv = min(vmax, nt - t), q4 = b / 4;
        for (int e = tid; e < tv * q4; e += kThreads) {
          const int ti = e / q4, c4 = e - ti * q4;
          const long long panel = __ldg(a.idx + k * a.width + t + ti);
          reinterpret_cast<float4*>(vec + ti * b)[c4] =
              __ldcg(reinterpret_cast<const float4*>(ol + panel * b) + c4);
        }
      }
      const float* v = vec + (t % vmax) * b;
#pragma unroll 1
      for (int h = 0; h < g.tile_pieces; ++h) {
        next_piece([&](const float* sl) {
          if (kFwd) {
            const int lo = h * P, hi = min(lo + P, R);
#pragma unroll 1
            for (int q = 4 * ln; q < b; q += 128) {
              const float4 y4 = lds4(v + q);
#pragma unroll
              for (int j = 0; j < kRows; ++j) {
                const int r = warp + kWarps * j;
                if (r >= lo && r < hi) {
                  const float4 x = lds4(sl + (r - lo) * b + q);
                  s[j] = __fmaf_rn(x.x, y4.x, s[j]);
                  s[j] = __fmaf_rn(x.y, y4.y, s[j]);
                  s[j] = __fmaf_rn(x.z, y4.z, s[j]);
                  s[j] = __fmaf_rn(x.w, y4.w, s[j]);
                }
              }
            }
          } else {
            const int rows = min(P, b - h * P), rho0 = h * P;
#pragma unroll 1
            for (int w = 0; 32 * w < rows; ++w) {
#pragma unroll
              for (int m = 0; m < kQuads; ++m) {
                const int r = ql[m] + 32 * w;
                if (qv[m] && r < rows) {
                  const float4 x = lds4(sl + r * R + qc[m]);
                  const float z = v[rho0 + r];
                  sb[m][0] = __fmaf_rn(x.x, z, sb[m][0]);
                  sb[m][1] = __fmaf_rn(x.y, z, sb[m][1]);
                  sb[m][2] = __fmaf_rn(x.z, z, sb[m][2]);
                  sb[m][3] = __fmaf_rn(x.w, z, sb[m][3]);
                }
              }
            }
          }
        });
      }
    }
    if (!kFwd) {
#pragma unroll
      for (int m = 0; m < kQuads; ++m) {
        if (qv[m]) {
          *reinterpret_cast<float4*>(part + ql[m] * ld + qc[m]) =
              make_float4(sb[m][0], sb[m][1], sb[m][2], sb[m][3]);
        }
      }
    }
    __syncthreads();
    {
      // The CTA's slice of r[k] - sum (y[k] - sum), to every CTA's acc.
      if (!kFwd) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          s[j] = j < mine ? part[ln * ld + warp + kWarps * j] : 0.0f;
        }
      }
      butterflies16(s, mine);
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int r = warp + kWarps * j;
        if (j < mine && ln < C) {
          st_async(remote_acc + 4u * (s0 + r), nt > 0 ? __fsub_rn(rv[r], s[j]) : rv[r],
                   remote_bar);
        }
      }
    }
    bar_wait(smem_addr(acc_bar), n & 1);
#pragma unroll
    for (int m = 0; m < kQuads; ++m) sb[m][0] = sb[m][1] = sb[m][2] = sb[m][3] = 0.0f;
#pragma unroll 1
    for (int h = 0; h < g.inv_pieces; ++h) {
      next_piece([&](const float* sl) {
        if (kFwd) {
          // y[k][i] for the piece's rows i: lane l over q = 128 u + 4 l + j <= i.
          const int rows = min(P, R - h * P), nr = (rows - warp + kWarps - 1) / kWarps;
          const int i0 = s0 + h * P + warp;
          float y[kRows];
#pragma unroll
          for (int j = 0; j < kRows; ++j) y[j] = 0.0f;
#pragma unroll 1
          for (int q = 4 * ln; q < b; q += 128) {
            const float4 x4 = lds4(acc + q);
#pragma unroll
            for (int j = 0; j < kRows; ++j) {
              const int i = i0 + kWarps * j;
              if (j < nr && q <= i) {
                const float4 l4 = lds4(sl + (warp + kWarps * j) * b + q);
                y[j] = __fmaf_rn(l4.x, x4.x, y[j]);
                if (q + 1 <= i) y[j] = __fmaf_rn(l4.y, x4.y, y[j]);
                if (q + 2 <= i) y[j] = __fmaf_rn(l4.z, x4.z, y[j]);
                if (q + 3 <= i) y[j] = __fmaf_rn(l4.w, x4.w, y[j]);
              }
            }
          }
          butterflies16(y, nr);
          if (ln == 0) {
#pragma unroll
            for (int j = 0; j < kRows; ++j) {
              if (j < nr) ol[kb + i0 + kWarps * j] = y[j];
            }
          }
        } else {
          // Quad (p, l): rows q = l + 32 u >= p of the piece.
          const int q0 = s0 + h * P, rows = min(P, g.inv_rows - h * P);
#pragma unroll 1
          for (int w = 0; 32 * w < rows + 31; ++w) {
#pragma unroll
            for (int m = 0; m < kQuads; ++m) {
              const int r = (ql[m] - q0 % 32 + 32) % 32 + 32 * w, q = q0 + r, p = s0 + qc[m];
              if (qv[m] && r < rows && q >= p) {
                const float4 x = lds4(sl + r * R + qc[m]);
                const float z = acc[q];
                sb[m][0] = __fmaf_rn(x.x, z, sb[m][0]);
                if (q >= p + 1) sb[m][1] = __fmaf_rn(x.y, z, sb[m][1]);
                if (q >= p + 2) sb[m][2] = __fmaf_rn(x.z, z, sb[m][2]);
                if (q >= p + 3) sb[m][3] = __fmaf_rn(x.w, z, sb[m][3]);
              }
            }
          }
        }
      });
    }
    if (!kFwd) {
#pragma unroll
      for (int m = 0; m < kQuads; ++m) {
        if (qv[m]) {
          *reinterpret_cast<float4*>(part + ql[m] * ld + qc[m]) =
              make_float4(sb[m][0], sb[m][1], sb[m][2], sb[m][3]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kRows; ++j) s[j] = j < mine ? part[ln * ld + warp + kWarps * j] : 0.0f;
      butterflies16(s, mine);
      if (ln == 0) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          if (j < mine) ol[kb + s0 + warp + kWarps * j] = s[j];
        }
      }
    }
    // y[k] (z[k]) is whole in device memory, and every CTA is done with acc.
    cluster_sync();
  }
  wait_pending<0>();
}

__global__ void __launch_bounds__(kThreads, 1) tile_solve_fwd_kernel(const Pass a) {
  solve_pass<true>(a);
}

__global__ void __launch_bounds__(kThreads, 1) tile_solve_bwd_kernel(const Pass a) {
  solve_pass<false>(a);
}

bool slice_ok(int b, int C) {
  return b % C == 0 && (b / C) % 16 == 0 && b / C <= kMaxSlice;
}

cudaError_t configure() {
  static bool done = false;
  if (done) return cudaSuccess;
  for (auto* k : {tile_solve_fwd_kernel, tile_solve_bwd_kernel}) {
    cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(kSmem));
    if (err != cudaSuccess) return err;
  }
  done = true;
  return cudaSuccess;
}

// Clusters of C CTAs that the card holds at once, per device.
int resident_clusters(int C) {
  static int seen[64][kMaxCluster + 1] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (seen[dev][C] == 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = kSmem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int got = 0;
    if (cudaOccupancyMaxActiveClusters(&got, tile_solve_fwd_kernel, &cfg) != cudaSuccess) {
      cudaGetLastError();
      got = 0;
    }
    seen[dev][C] = got > 0 ? got : -1;
  }
  return seen[dev][C];
}

}  // namespace

// C interface, loaded with ctypes.  Each entry point returns 0 or a CUDA
// error code; the launch runs on the given stream and does not synchronise.

// The cluster size a pass over `lanes` lanes of b-wide tiles takes: the
// largest C in 8, 4, 2, 1 whose slices b / C are multiples of 16 of at most
// 128 and whose `lanes` clusters the card holds at once; where none does,
// the smallest such C (the lanes then run in waves).  0 where no C fits b;
// a negative CUDA error code where the card could not be asked.
extern "C" int cim_tile_solve_cluster(int b, int lanes) {
  if (cudaError_t err = configure(); err != cudaSuccess) return -static_cast<int>(err);
  int fallback = 0;
  for (int C = kMaxCluster; C >= 1; C /= 2) {
    if (!slice_ok(b, C)) continue;
    fallback = C;
    if (resident_clusters(C) >= lanes) return C;
  }
  return fallback;
}

// One pass over `lanes` lanes (forward != 0: y = forward substitution of
// rhs; else z = backward substitution of rhs), written to out (lanes, B b).
// L, inv and rhs at lane strides L_lane, inv_lane, rhs_lane floats (0
// shares one); L, inv, their lane strides and b put every tile row on a
// 16-byte boundary, and out is 16-byte aligned.  ids, idx (B, width) and
// counts (B) are the engine's int64 tables of the pass.  b a multiple of 32
// from 32 to 256; 1 to 65535 lanes.
extern "C" int cim_tile_solve_f32(const float* L, long long L_lane, const float* inv,
                                  long long inv_lane, const float* rhs, long long rhs_lane,
                                  float* out, int b, int B, const long long* ids,
                                  const long long* idx, const long long* counts, long long width,
                                  int lanes, int forward, void* stream) {
  if (b < 32 || b > kMaxB || b % 32 != 0 || B < 1 || width < 1 || lanes < 1 || lanes > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int C = cim_tile_solve_cluster(b, lanes);
  if (C < 0) return -C;
  if (C == 0) return static_cast<int>(cudaErrorInvalidValue);
  Pass p{L, L_lane, inv, inv_lane, rhs, rhs_lane, out, ids, idx, counts, width, b, B};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, lanes, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = forward ? cudaLaunchKernelEx(&cfg, tile_solve_fwd_kernel, p)
                                  : cudaLaunchKernelEx(&cfg, tile_solve_bwd_kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
