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
lane axis for the batch).

:func:`tile_schur_` (``cim_tile_schur_f32``, ``csrc/tile_schur.cu``) runs one
panel's Schur update in place on the engine's tiles, L[dst] -= L[a]·L[b]ᵀ
for every pair of the panel, with nothing gathered or scattered; it
replaces no TPU kernel (the JAX engine's update is plain jnp) and
:func:`tile_schur_batched_` does it for every lane in one launch, each lane
bit-equal to the single launch on it.  ``TiledCholesky.factorize`` reaches
them on float32 CUDA tiles (through the operator ``cim::tile_schur``,
:func:`tile_schur_op`, inside a lane of a batched solver); their plain form
is ``ops.chol_cuda.tile_schur_fma_plain``, the kernel's own sums, which the
wrappers run on CPU tensors.  ``LAUNCHES`` counts the kernel launches,
single and batched apart.
"""

from __future__ import annotations

from ctypes import c_int as _I
from ctypes import c_longlong as _LL
from ctypes import c_void_p as _P
from typing import NamedTuple

import numpy as np
import torch

from cholesky_is_magic_tpu_torch.ops import chol_cuda, cuda_build

LAUNCHES = {"assemble_pairs": 0, "assemble_pairs_batched": 0, "tile_schur": 0,
            "tile_schur_batched": 0}

_SIGNATURES = {
    "cim_assemble_pairs_f32": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                               _P],
    "cim_assemble_pairs_f32_batched": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                                       _P, _I, _I, _LL, _LL, _LL, _P],
    "cim_tile_schur_f32_batched": [_P, _LL, _I, _P, _P, _P, _I, _I, _I, _P],
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
                    chunk: int = CHUNK, boost: bool = True) -> KernelSchedule:
    """The engine's pair schedule as the kernel reads it (see the module
    docstring), from the host's ``run_start`` (runs + 1 offsets into the
    pairs) and ``run_dst`` (the runs' flat destinations, ascending): a few
    searches over the runs, no pass over the pairs.  The runs may be a
    part of the engine's (a rank's slab in the mesh mode: the offsets
    still index the engine's pair arrays, and every entry no run reaches
    is written zero); ``boost=False`` gives no run a boost and adds no
    empty diagonal run.  Raises where an index does not fit 32 bits."""
    b = eng.b
    total = (eng.NT + 1) * b * b
    if total + chunk > _INT32_MAX or eng.n_pairs >= _INT32_MAX or (
            eng.n_pairs and int(eng.asm_k.max()) > _INT32_MAX):
        raise ValueError(
            f"assemble_pairs: {total} tile entries / {eng.n_pairs} pairs do "
            "not fit the kernel's 32-bit indices")
    # Slot k·b + r sits on the diagonal of panel k's diagonal tile; the
    # diagonal tiles come in panel order, so diag_dst ascends.
    chunks = -(-total // chunk)
    put = lambda a: torch.as_tensor(a.astype(np.int32), device=eng.device)  # noqa: E731
    if not boost:
        return KernelSchedule(
            eng.asm_k.to(torch.int32), put(run_start), put(run_dst),
            put(np.full(len(run_dst), -1, np.int64)),
            put(np.searchsorted(run_dst, np.arange(chunks + 1) * chunk)), chunk)
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
    chunk_run = np.searchsorted(run_dst, np.arange(chunks + 1) * chunk)
    return KernelSchedule(eng.asm_k.to(torch.int32), put(run_start), put(run_dst),
                          put(run_row), put(chunk_run), chunk)


def assemble_pairs(eng, d: torch.Tensor, row_boost: torch.Tensor,
                   sched: KernelSchedule = None) -> torch.Tensor:
    """The (NT+1, b, b) resident tiles of the engine ``eng``'s normal
    matrix for the column scaling ``d`` (f32, on the card) and the boost
    ``row_boost`` of the first len(row_boost) permuted rows (the other
    slots get 1).  ``sched``: a schedule of part of the engine's runs (a
    rank's slab in the mesh mode, ``TiledCholesky._slab``) in place of the
    engine's whole one."""
    if not (d.is_cuda and eng.asm_w.is_cuda and row_boost.is_cuda):
        raise ValueError("assemble_pairs takes CUDA tensors")
    if d.dtype != torch.float32 or eng.asm_w.dtype != torch.float32:
        raise TypeError(f"assemble_pairs takes float32 (got {d.dtype}, "
                        f"{eng.asm_w.dtype})")
    if d.dim() != 1 or not d.is_contiguous():
        raise ValueError("assemble_pairs: d must be a contiguous vector")
    rb = row_boost.to(torch.float32).contiguous()
    b, NT = eng.b, eng.NT
    sched = eng._kernel_schedule if sched is None else sched
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


def _row_major_lanes(L: torch.Tensor) -> bool:
    """Whether each lane of L (axis 0 the lanes) is laid out row-major."""
    return L.shape[0] == 0 or L[0].is_contiguous()


def _tile_schur_plain_(L: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       dst: torch.Tensor) -> None:
    """What the kernel leaves in L, leading axes of L lanes: the kernel's
    sums by ``chol_cuda.tile_schur_fma_plain``."""
    L[..., dst, :, :] = chol_cuda.tile_schur_fma_plain(
        L[..., dst, :, :], L[..., a, :, :], L[..., b, :, :])


def _tile_schur_launch(L: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       dst: torch.Tensor, key: str, name: str) -> None:
    """One launch over the lanes of L (lanes, NT+1, b, b) float32 on the
    card, each lane row-major, for the pairs (a[p], b[p], dst[p]): int64
    tile indices on the same card, which the kernel does not check."""
    if not (L.is_cuda and a.is_cuda and b.is_cuda and dst.is_cuda):
        raise ValueError(f"{name} takes CUDA tensors")
    if len({L.device, a.device, b.device, dst.device}) != 1:
        raise ValueError(f"{name}: operands on {L.device}, {a.device}, {b.device}, "
                         f"{dst.device}")
    if L.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 tiles (got {L.dtype})")
    pairs = a.shape[0] if a.dim() == 1 else -1
    for t in (a, b, dst):
        if t.dtype != torch.int64 or t.shape != (pairs,) or (pairs > 1 and t.stride(0) != 1):
            raise ValueError(f"{name}: the pair lists must be three int64 vectors of one "
                             f"length (got {tuple(a.shape)}, {tuple(b.shape)}, "
                             f"{tuple(dst.shape)})")
    lanes = L.shape[0]
    if L.dim() != 4 or L.shape[2] != L.shape[3] or not _row_major_lanes(L):
        raise ValueError(f"{name}: tiles {tuple(L.shape)} at strides {L.stride()}, each "
                         "lane (NT+1, b, b) row-major")
    if not 1 <= lanes <= MAX_LANES or (lanes > 1 and L.stride(0) == 0):
        raise ValueError(f"{name}: {lanes} lanes at lane stride {L.stride(0)}, the kernel "
                         f"takes 1 to {MAX_LANES} lanes of their own")
    if pairs == 0:
        return
    bs = L.shape[-1]
    lane_stride = L.stride(0) if lanes > 1 else 0
    vec = int(L.data_ptr() % 16 == 0 and bs % 4 == 0 and lane_stride % 4 == 0)
    lib = cuda_build.load(_SIGNATURES)
    cuda_build.raise_on(
        lib.cim_tile_schur_f32_batched(
            L.data_ptr(), lane_stride, bs, a.data_ptr(), b.data_ptr(), dst.data_ptr(),
            pairs, lanes, vec, torch.cuda.current_stream(L.device).cuda_stream),
        name)
    LAUNCHES[key] += 1


def tile_schur_(L: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                dst: torch.Tensor) -> None:
    """In place on one lane's tiles L (NT+1, b, b): L[dst[p]] -= L[a[p]] ·
    L[b[p]]ᵀ for every pair p, where the destinations are distinct and none
    is an operand's tile (one panel's Schur update).  The kernel on a CUDA
    tensor (float32), one launch (on a row-major copy, written back, where L
    is not row-major); on a CPU tensor the kernel's sums in plain PyTorch
    (``chol_cuda.tile_schur_fma_plain``)."""
    if not L.is_cuda:
        _tile_schur_plain_(L, a, b, dst)
        return
    if L.dim() != 3:
        raise ValueError(f"tile_schur_: tiles {tuple(L.shape)}, not (NT+1, b, b)")
    _tile_schur_rows_(L[None], a, b, dst, "tile_schur", "tile_schur_")


def tile_schur_batched_(L: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                        dst: torch.Tensor) -> None:
    """:func:`tile_schur_` on every lane of L (lanes, NT+1, b, b) with the
    same pairs, in one launch: lane k bit-equal to ``tile_schur_(L[k], a, b,
    dst)``.  Lanes at any lane stride; where a lane is not row-major the
    kernel runs on a row-major copy, written back."""
    if not L.is_cuda:
        _tile_schur_plain_(L, a, b, dst)
        return
    if L.dim() != 4:
        raise ValueError(f"tile_schur_batched_: tiles {tuple(L.shape)}, not "
                         "(lanes, NT+1, b, b)")
    _tile_schur_rows_(L, a, b, dst, "tile_schur_batched", "tile_schur_batched_")


def _tile_schur_rows_(L, a, b, dst, key, name):
    """The launch on L's lanes where each is row-major, else on a row-major
    copy written back."""
    work = L if _row_major_lanes(L) else L.contiguous()
    _tile_schur_launch(work, a, b, dst, key, name)
    if work is not L:
        L.copy_(work)


@torch.library.custom_op("cim::tile_schur", mutates_args=("L",))
def tile_schur_op(L: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  dst: torch.Tensor) -> None:
    """:func:`tile_schur_` as an operator; under ``torch.func.vmap`` (the
    lanes' tiles batched, the pair lists shared) one
    :func:`tile_schur_batched_` launch for the whole batch, in place on the
    batch's tiles."""
    tile_schur_(L, a, b, dst)


@tile_schur_op.register_fake
def _(L, a, b, dst):
    return None


@tile_schur_op.register_vmap
def _(info, in_dims, L, a, b, dst):
    if in_dims[0] is None or any(d is not None for d in in_dims[1:]):
        raise ValueError("cim::tile_schur under vmap takes batched tiles and shared "
                         f"pair lists (in_dims {in_dims})")
    tile_schur_batched_(L.movedim(in_dims[0], 0), a, b, dst)
    return None, None


def tile_schur(L: torch.Tensor, a: torch.Tensor, b: torch.Tensor, dst: torch.Tensor,
               per_lane: bool = False) -> None:
    """One panel's Schur update in place, as ``TiledCholesky.factorize``
    runs it on float32 CUDA tiles: :func:`tile_schur_`, or inside a lane of
    a batched solver (``per_lane``) through :func:`tile_schur_op`, one
    launch for all the lanes.  The operator's dispatch costs tens of
    microseconds a call, so the single path launches the kernel itself."""
    (tile_schur_op if per_lane else tile_schur_)(L, a, b, dst)
