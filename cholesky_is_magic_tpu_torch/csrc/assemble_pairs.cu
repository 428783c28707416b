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
// so every destination's pairs form one contiguous run, and the runs are
// sorted by destination too.  The host records once per engine
// (sparse/tiled_cuda.py::kernel_schedule), in 32-bit indices: the run
// offsets and destinations, with an empty run for every diagonal slot that
// no pair reaches; for a run on the diagonal of a diagonal tile the permuted
// row whose boost it takes (-1 elsewhere); and, for every chunk of ``chunk``
// consecutive tile entries, the first run that lands in it.
//
// One launch: block c owns chunk c of the flat tile array.  It writes the
// chunk's zeros 16 bytes at a time, then its threads each walk one of the
// chunk's runs in schedule order and store sum + boost.  No block touches
// another's chunk, so there is no second pass, no read-back of the tiles, no
// division to find the diagonal and no float atomics: the sums are
// deterministic and repeated solves bit-reproducible.
//
// What bounds it on the H100: the tiles written once (4 bytes per entry)
// plus ~12 bytes and 3 flops per pair read once; device-memory bound.
// Neighbouring threads walk neighbouring runs, so short runs (the common
// case) keep the pair reads nearly coalesced; d is small and stays in cache.
//
// Every operation is an explicit round-to-nearest intrinsic: d², w·d² and
// the running sum round exactly as the plain version's multiply, multiply
// and sequential index_add_, and the boost is added last, as there.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// A real row (row < m) is boosted by row_boost[row], a padded or gap slot
// by 1.
__global__ void __launch_bounds__(kThreads)
assemble_chunks_kernel(float* __restrict__ tiles, int total, int chunk,
                       const float* __restrict__ w,
                       const int* __restrict__ kcol,
                       const float* __restrict__ d,
                       const int* __restrict__ run_start,
                       const int* __restrict__ run_dst,
                       const int* __restrict__ run_row,
                       const int* __restrict__ chunk_run,
                       const float* __restrict__ row_boost, int m) {
  const int c = blockIdx.x;
  const int e0 = c * chunk;  // a multiple of 4: tiles + e0 is 16-byte aligned
  const int e1 = min(total, e0 + chunk);
  const int n4 = (e1 - e0) >> 2;
  float4* t4 = reinterpret_cast<float4*>(tiles + e0);
  for (int q = threadIdx.x; q < n4; q += kThreads) {
    t4[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (int e = e0 + (n4 << 2) + threadIdx.x; e < e1; e += kThreads) {
    tiles[e] = 0.0f;
  }
  __syncthreads();  // the block's zeros before the block's sums
  const int s1 = chunk_run[c + 1];
  for (int s = chunk_run[c] + threadIdx.x; s < s1; s += kThreads) {
    const int p0 = run_start[s], p1 = run_start[s + 1];
    float acc = 0.0f;
    for (int p = p0; p < p1; ++p) {
      const float dk = d[kcol[p]];
      acc = __fadd_rn(acc, __fmul_rn(w[p], __fmul_rn(dk, dk)));
    }
    const int row = run_row[s];
    const float boost = row < 0 ? 0.0f : (row < m ? row_boost[row] : 1.0f);
    tiles[run_dst[s]] = p1 > p0 ? __fadd_rn(acc, boost) : boost;
  }
}

}  // namespace

// C interface, loaded with ctypes.  Launches on the given stream, does not
// synchronise, and returns cudaGetLastError() (0 = launched).  ``tiles`` is
// 16-byte aligned, ``chunk`` a multiple of 4 with total + chunk < 2^31, and
// chunk_run has ceil(total / chunk) + 1 entries.
extern "C" int cim_assemble_pairs_f32(float* tiles, int total, int chunk,
                                      const float* w, const int* kcol,
                                      const float* d, const int* run_start,
                                      const int* run_dst, const int* run_row,
                                      const int* chunk_run,
                                      const float* row_boost, int m,
                                      void* stream) {
  if (total < 1 || chunk < 4 || chunk % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (total + chunk - 1) / chunk;
  assemble_chunks_kernel<<<chunks, kThreads, 0, s>>>(
      tiles, total, chunk, w, kcol, d, run_start, run_dst, run_row, chunk_run,
      row_boost, m);
  return static_cast<int>(cudaGetLastError());
}
