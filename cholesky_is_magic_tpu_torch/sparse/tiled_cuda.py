"""Launch the hand-written Hopper pair-schedule assembly kernel.

The kernel (``csrc/assemble_pairs.cu``, CUDA C++ for ``sm_90a``) replaces
the Pallas TPU kernel ``benchmarks/explore_prefetch_assembly.py`` ``kernel``
(launched there by ``pallas_onehot_k``): the kernel form of the tile
engine's ``assemble_pairs``, which builds the resident (b, b) tiles of
P·A·D²·Aᵀ·Pᵀ from the sorted pair schedule.  One launch: each block owns a
chunk of ``CHUNK`` consecutive tile entries, writes its zeros, then one
thread sums each run of pairs that share a destination in the chunk, in
schedule order, and stores sum + boost, so the result is deterministic.
What bounds it on the H100: the bytes of the tiles, written once, and of the
pair arrays, read once (see the .cu file).

:func:`kernel_schedule` makes the kernel's view of an engine's schedule, in
32-bit indices (half the index bytes of the int64 arrays the plain version
keeps): the runs, an empty run for every diagonal slot no pair reaches, each
diagonal run's boosted row, and each chunk's first run.  The engine calls it
once, where it builds its pair schedule for float32 on a card.

:func:`assemble_pairs_batched` (``cim_assemble_pairs_f32_batched``)
assembles B lanes' tiles from one schedule (the lanes share A) and their own
d and boost in one launch, a lane per grid row, each lane bit-equal to the
single launch on it: the batched sparse solvers' assembly, which the
operator ``cim::assemble_pairs`` (``sparse.tiled``) launches from its
``torch.func.vmap`` rule, where the JAX package vmaps its segment sum.

The plain version is ``sparse.tiled.TiledCholesky._assemble_pairs_plain``
(w·d²[k] summed per destination in schedule order, then the boost; with a
lane axis for the batch).  ``LAUNCHES`` counts the kernel launches, single
and batched apart.
"""

from __future__ import annotations

from ctypes import c_int as _I
from ctypes import c_longlong as _LL
from ctypes import c_void_p as _P
from typing import NamedTuple

import numpy as np
import torch

from cholesky_is_magic_tpu_torch.ops import cuda_build

LAUNCHES = {"assemble_pairs": 0, "assemble_pairs_batched": 0}

_SIGNATURES = {
    "cim_assemble_pairs_f32": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                               _P],
    "cim_assemble_pairs_f32_batched": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                                       _P, _I, _I, _LL, _LL, _LL, _P],
}

# Lanes of one batched launch: the grid's y extent.
MAX_LANES = 65535

# Tile entries per block: a multiple of 4.  On the m = 16384 schedule, NVIDIA
# H100 80GB HBM3 at 700.00 W (tools/probe_assembly_kernel.py): 1024 / 2048 /
# 4096 / 8192 / 16384 took 0.0145 / 0.0154 / 0.0172 / 0.0185 / 0.0252 ms at
# block 128 and 0.0278 / 0.0252 / 0.0270 / 0.0276 / 0.0332 ms at block 256.
CHUNK = 2048
_INT32_MAX = 2**31 - 1


class KernelSchedule(NamedTuple):
    """The assembly kernel's arrays, int32 on the engine's device."""

    k: torch.Tensor  # (pairs,) the column of d each pair reads
    run_start: torch.Tensor  # (runs + 1,) offsets into the pair arrays
    run_dst: torch.Tensor  # (runs,) flat destinations, ascending
    run_row: torch.Tensor  # (runs,) the permuted row a run's boost comes from, or -1
    chunk_run: torch.Tensor  # (chunks + 1,) the first run of each chunk
    chunk: int


def kernel_schedule(eng, run_start: np.ndarray, run_dst: np.ndarray,
                    chunk: int = CHUNK) -> KernelSchedule:
    """The engine's pair schedule as the kernel reads it (see the module
    docstring), from the host's ``run_start`` (runs + 1 offsets into the
    pairs) and ``run_dst`` (the runs' flat destinations, ascending): a few
    searches over the runs, no pass over the pairs.  Raises where an index
    does not fit 32 bits."""
    b = eng.b
    total = (eng.NT + 1) * b * b
    if total + chunk > _INT32_MAX or eng.n_pairs >= _INT32_MAX or (
            eng.n_pairs and int(eng.asm_k.max()) > _INT32_MAX):
        raise ValueError(
            f"assemble_pairs: {total} tile entries / {eng.n_pairs} pairs do "
            "not fit the kernel's 32-bit indices")
    # Slot k·b + r sits on the diagonal of panel k's diagonal tile; the
    # diagonal tiles come in panel order, so diag_dst ascends.
    diag_dst = (eng._diag_ids_np[:, None] * (b * b)
                + np.arange(b)[None, :] * (b + 1)).reshape(-1)
    pos = np.searchsorted(run_dst, diag_dst)
    bare = run_dst[np.minimum(pos, len(run_dst) - 1)] != diag_dst if len(run_dst) \
        else np.ones(len(diag_dst), bool)
    # An empty run for each diagonal slot that no pair reaches.
    run_start = np.append(np.insert(run_start[:-1], pos[bare], run_start[pos[bare]]),
                          run_start[-1])
    run_dst = np.insert(run_dst, pos[bare], diag_dst[bare])
    run_row = np.full(len(run_dst), -1, np.int64)
    # Slot s holds the permuted row whose slot_of is s.
    run_row[np.searchsorted(run_dst, diag_dst)] = np.argsort(eng._slot_of_np)
    chunks = -(-total // chunk)
    chunk_run = np.searchsorted(run_dst, np.arange(chunks + 1) * chunk)
    put = lambda a: torch.as_tensor(a.astype(np.int32), device=eng.device)  # noqa: E731
    return KernelSchedule(eng.asm_k.to(torch.int32), put(run_start), put(run_dst),
                          put(run_row), put(chunk_run), chunk)


def assemble_pairs(eng, d: torch.Tensor, row_boost: torch.Tensor) -> torch.Tensor:
    """The (NT+1, b, b) resident tiles of the engine ``eng``'s normal
    matrix for the column scaling ``d`` (f32, on the card) and the boost
    ``row_boost`` of the first len(row_boost) permuted rows (the other
    slots get 1)."""
    if not (d.is_cuda and eng.asm_w.is_cuda and row_boost.is_cuda):
        raise ValueError("assemble_pairs takes CUDA tensors")
    if d.dtype != torch.float32 or eng.asm_w.dtype != torch.float32:
        raise TypeError(f"assemble_pairs takes float32 (got {d.dtype}, "
                        f"{eng.asm_w.dtype})")
    if d.dim() != 1 or not d.is_contiguous():
        raise ValueError("assemble_pairs: d must be a contiguous vector")
    rb = row_boost.to(torch.float32).contiguous()
    b, NT = eng.b, eng.NT
    sched = eng._kernel_schedule
    tiles = torch.empty((NT + 1, b, b), dtype=torch.float32, device=d.device)
    lib = cuda_build.load(_SIGNATURES)
    LAUNCHES["assemble_pairs"] += 1
    cuda_build.raise_on(
        lib.cim_assemble_pairs_f32(
            tiles.data_ptr(), tiles.numel(), sched.chunk,
            eng.asm_w.data_ptr(), sched.k.data_ptr(), d.data_ptr(),
            sched.run_start.data_ptr(), sched.run_dst.data_ptr(),
            sched.run_row.data_ptr(), sched.chunk_run.data_ptr(),
            rb.data_ptr(), rb.shape[0],
            torch.cuda.current_stream(d.device).cuda_stream),
        "assemble_pairs")
    return tiles


def assemble_pairs_batched(eng, d: torch.Tensor,
                           row_boost: torch.Tensor) -> torch.Tensor:
    """The (B, NT+1, b, b) tiles of every lane of ``d`` (B, n) in one
    launch: lane k bit-equal to ``assemble_pairs(eng, d[k], row_boost[k])``.
    ``row_boost`` is (B, m), or (m,) shared by every lane; any lane strides
    (0 repeats one operand)."""
    if not (d.is_cuda and eng.asm_w.is_cuda and row_boost.is_cuda):
        raise ValueError("assemble_pairs_batched takes CUDA tensors")
    if d.dtype != torch.float32 or eng.asm_w.dtype != torch.float32:
        raise TypeError(f"assemble_pairs_batched takes float32 (got {d.dtype}, "
                        f"{eng.asm_w.dtype})")
    if d.dim() != 2 or row_boost.dim() not in (1, 2):
        raise ValueError(f"assemble_pairs_batched: d {tuple(d.shape)}, boost "
                         f"{tuple(row_boost.shape)}")
    lanes = d.shape[0]
    if not 1 <= lanes <= MAX_LANES:
        raise ValueError(f"assemble_pairs_batched: {lanes} lanes, the kernel "
                         f"takes 1 to {MAX_LANES}")
    rb = row_boost.to(torch.float32)
    if rb.dim() == 1:
        rb = rb.expand(lanes, *rb.shape)
    if rb.shape[0] != lanes:
        raise ValueError(f"assemble_pairs_batched: {lanes} lanes of d, "
                         f"{rb.shape[0]} of the boost")
    d = d if d.stride(1) == 1 else d.contiguous()
    rb = rb if rb.stride(1) == 1 or rb.shape[1] == 0 else rb.contiguous()
    b, NT = eng.b, eng.NT
    total = (NT + 1) * b * b
    ld = -(-total // 4) * 4  # each lane's tiles 16-byte aligned
    buf = torch.empty((lanes, ld), dtype=torch.float32, device=d.device)
    sched = eng._kernel_schedule
    lib = cuda_build.load(_SIGNATURES)
    LAUNCHES["assemble_pairs_batched"] += 1
    cuda_build.raise_on(
        lib.cim_assemble_pairs_f32_batched(
            buf.data_ptr(), total, sched.chunk,
            eng.asm_w.data_ptr(), sched.k.data_ptr(), d.data_ptr(),
            sched.run_start.data_ptr(), sched.run_dst.data_ptr(),
            sched.run_row.data_ptr(), sched.chunk_run.data_ptr(),
            rb.data_ptr(), rb.shape[1], lanes, ld, d.stride(0), rb.stride(0),
            torch.cuda.current_stream(d.device).cuda_stream),
        "assemble_pairs_batched")
    return buf[:, :total].view(lanes, NT + 1, b, b)
