// Pair-schedule assembly of the tile engine's normal matrix for Hopper
// (sm_90a), f32.
//
// Replaces the Pallas TPU exploration kernel
// benchmarks/explore_prefetch_assembly.py `kernel` (launched there by
// pallas_onehot_k), the kernel form of TiledCholesky.assemble_pairs
// (cholesky_is_magic_tpu/sparse/tiled.py): the resident (b, b) tiles of
// P·A·D²·Aᵀ·Pᵀ as
//
//     tiles[t, r, c] = boost(t, r, c) + sum_p  w_p · d[k_p]²
//
// over the pairs p whose flat destination is t·b² + r·b + c, where boost is
// the unit (or caller's) diagonal of padded and gap slots on the diagonal
// tiles, and the dummy tile NT stays zero.
//
// The TPU kernel reduces with one-hot matmuls, a Mosaic workaround.  Here
// the schedule is sorted by destination (TiledCholesky.build_ell_assembly),
// so every destination's pairs form one contiguous run; the host records the
// run offsets once per engine.  One thread walks one run in schedule order,
// so the sums are deterministic (no float atomics) and repeated solves are
// bit-reproducible; a grid-stride pass first writes the zeros and the boost.
//
// What bounds it on the H100: ~16 bytes and 3 flops per pair, read once;
// device-memory bound for long schedules, launch-bound for short ones.  The
// pair arrays are read with neighbouring threads on neighbouring runs, so
// short runs (the common case) keep the reads nearly coalesced.
//
// Every operation is an explicit round-to-nearest intrinsic: d², w·d² and
// the running sum round exactly as the plain version's multiply, multiply
// and sequential index_add_.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// tiles[e] = boost on the diagonal of diagonal tiles, 0 elsewhere.
// diag_panel[t] = k when tile t is the diagonal tile of panel k, else -1;
// slot s = k·b + r holds permuted row pperm[s], boosted by row_boost[row]
// for a real row (row < m) and by 1 for a padded or gap slot.
__global__ void __launch_bounds__(kThreads)
assemble_fill_kernel(float* __restrict__ tiles, long long total, int b,
                     const long long* __restrict__ diag_panel,
                     const long long* __restrict__ pperm,
                     const float* __restrict__ row_boost, long long m) {
  const long long bb = static_cast<long long>(b) * b;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * kThreads) {
    const long long t = e / bb;
    const long long rem = e - t * bb;
    const long long r = rem / b, c = rem - r * b;
    float v = 0.0f;
    if (r == c) {
      const long long k = diag_panel[t];
      if (k >= 0) {
        const long long row = pperm[k * b + r];
        v = row < m ? row_boost[row] : 1.0f;
      }
    }
    tiles[e] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
assemble_runs_kernel(float* __restrict__ tiles, const float* __restrict__ w,
                     const long long* __restrict__ kcol,
                     const float* __restrict__ d,
                     const long long* __restrict__ run_start,
                     const long long* __restrict__ run_dst, long long runs) {
  const long long s = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (s >= runs) return;
  float acc = 0.0f;
  for (long long p = run_start[s]; p < run_start[s + 1]; ++p) {
    const float dk = d[kcol[p]];
    acc = __fadd_rn(acc, __fmul_rn(w[p], __fmul_rn(dk, dk)));
  }
  const long long dst = run_dst[s];
  tiles[dst] = __fadd_rn(acc, tiles[dst]);
}

}  // namespace

// C interface, loaded with ctypes.  Launches on the given stream, does not
// synchronise, and returns cudaGetLastError() (0 = launched).
extern "C" int cim_assemble_pairs_f32(float* tiles, long long total, int b,
                                      const long long* diag_panel,
                                      const long long* pperm,
                                      const float* row_boost, long long m,
                                      const float* w, const long long* kcol,
                                      const float* d, const long long* run_start,
                                      const long long* run_dst, long long runs,
                                      void* stream) {
  if (b < 1 || total < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long fill_blocks = (total + kThreads - 1) / kThreads;
  if (fill_blocks > 65536) fill_blocks = 65536;
  assemble_fill_kernel<<<static_cast<unsigned>(fill_blocks), kThreads, 0, s>>>(
      tiles, total, b, diag_panel, pperm, row_boost, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || runs == 0) return static_cast<int>(err);
  const long long run_blocks = (runs + kThreads - 1) / kThreads;
  assemble_runs_kernel<<<static_cast<unsigned>(run_blocks), kThreads, 0, s>>>(
      tiles, w, kcol, d, run_start, run_dst, runs);
  return static_cast<int>(cudaGetLastError());
}
