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

:func:`tile_solve` (``cim_tile_solve_f32``, ``csrc/tile_solve.cu``) runs
``TiledCholesky.solve`` on float32 CUDA tiles: the forward and the backward
substitution with the stored tile inverses, one launch a pass for all the
lanes (through the operator ``cim::tile_solve``, :func:`tile_solve_op`,
whose ``torch.func.vmap`` rule launches every lane at once).  It replaces
no TPU kernel (the JAX engine's solve is plain jnp).  Its plain form is
:func:`tile_solve_plain`, the kernel's own sums, which the operator runs on
CPU tensors; each launch goes through :func:`tile_solve_pass`.
"""

from __future__ import annotations

from ctypes import c_int as _I
from ctypes import c_longlong as _LL
from ctypes import c_void_p as _P
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from cholesky_is_magic_tpu_torch.ops import chol_cuda, cuda_build

LAUNCHES = {"assemble_pairs": 0, "assemble_pairs_batched": 0, "tile_schur": 0,
            "tile_schur_batched": 0, "tile_solve": 0, "tile_solve_batched": 0}

_SIGNATURES = {
    "cim_assemble_pairs_f32": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                               _P],
    "cim_assemble_pairs_f32_batched": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                                       _P, _I, _I, _LL, _LL, _LL, _P],
    "cim_tile_schur_f32_batched": [_P, _LL, _I, _P, _P, _P, _I, _I, _I, _P],
    "cim_tile_solve_f32": [_P, _LL, _P, _LL, _P, _LL, _P, _I, _I, _P, _P, _P, _LL, _I, _I,
                           _P],
    "cim_tile_solve_cluster": [_I, _I],
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


# The tile widths the solve kernel takes: every multiple of 32 up to 256.
SOLVE_BLOCKS = range(32, 257, 32)


class SolvePass(NamedTuple):
    """One pass's tables of an engine: per panel step the tiles (``ids``,
    (B, width), padded), the panel of each tile's vector (``idx``) and the
    tile count (``counts``, (B,)), int64 on the engine's device; and
    ``tiles``, the off-diagonal tiles the pass reads a lane."""

    ids: torch.Tensor
    idx: torch.Tensor
    counts: torch.Tensor
    tiles: int


def takes_tile_solve(L: torch.Tensor, invd: torch.Tensor, rhs: torch.Tensor) -> bool:
    """Whether ``TiledCholesky.solve`` takes the kernel for these operands:
    float32 on a card, tiles of a width in :data:`SOLVE_BLOCKS`."""
    return (cuda_build.takes_kernel(L.device, L.dtype, invd.dtype, rhs.dtype)
            and L.shape[-1] in SOLVE_BLOCKS)


def _lanes_ready(x: torch.Tensor) -> torch.Tensor:
    """``x`` (lanes, ...) as the kernel reads it: each lane row-major, the
    lane stride (0 shares one lane) and the start on 16-byte boundaries;
    else a row-major copy."""
    if (x[0].is_contiguous() and x.data_ptr() % 16 == 0
            and (x.shape[0] == 1 or x.stride(0) % 4 == 0)):
        return x
    return x.contiguous()


def tile_solve_pass(L: torch.Tensor, invd: torch.Tensor, rhs: torch.Tensor,
                    tables: SolvePass, forward: bool, key: str = "tile_solve") -> torch.Tensor:
    """One launch of the solve kernel over the lanes of L (lanes, NT+1, b, b),
    invd (lanes, B, b, b) and rhs (lanes, B·b), float32 on one card, any
    lane strides: the forward substitution (``forward``) or the backward one
    of every lane, in slot order, as a new (lanes, B·b) tensor.  ``key``
    names the ``LAUNCHES`` counter the launch adds to."""
    name = "tile_solve_pass"
    if not (L.is_cuda and invd.is_cuda and rhs.is_cuda):
        raise ValueError(f"{name} takes CUDA tensors")
    if len({L.device, invd.device, rhs.device, tables.ids.device}) != 1:
        raise ValueError(f"{name}: operands on {L.device}, {invd.device}, {rhs.device}, "
                         f"{tables.ids.device}")
    if not L.dtype == invd.dtype == rhs.dtype == torch.float32:
        raise TypeError(f"{name} takes float32 (got {L.dtype}, {invd.dtype}, {rhs.dtype})")
    lanes, b = L.shape[0], L.shape[-1]
    B = invd.shape[1] if invd.dim() == 4 else -1
    if (L.dim() != 4 or L.shape[2] != b or invd.shape != (lanes, B, b, b)
            or rhs.shape != (lanes, B * b) or b not in SOLVE_BLOCKS):
        raise ValueError(f"{name}: tiles {tuple(L.shape)}, inverses {tuple(invd.shape)}, "
                         f"right-hand sides {tuple(rhs.shape)}: (lanes, NT+1, b, b), "
                         f"(lanes, B, b, b), (lanes, B·b), b in {list(SOLVE_BLOCKS)}")
    if not 1 <= lanes <= MAX_LANES:
        raise ValueError(f"{name}: {lanes} lanes, the kernel takes 1 to {MAX_LANES}")
    for t in tables[:3]:
        if t.dtype != torch.int64 or not t.is_contiguous() or t.shape[0] != B:
            raise ValueError(f"{name}: the tables must be contiguous int64 with B = {B} rows")
    L, invd = _lanes_ready(L), _lanes_ready(invd)
    rhs = rhs if rhs.stride(1) == 1 else rhs.contiguous()
    out = torch.empty((lanes, B * b), dtype=torch.float32, device=L.device)
    stride = lambda x: x.stride(0) if lanes > 1 else 0  # noqa: E731
    lib = cuda_build.load(_SIGNATURES)
    cuda_build.raise_on(
        lib.cim_tile_solve_f32(
            L.data_ptr(), stride(L), invd.data_ptr(), stride(invd), rhs.data_ptr(),
            stride(rhs), out.data_ptr(), b, B, tables.ids.data_ptr(),
            tables.idx.data_ptr(), tables.counts.data_ptr(), tables.ids.shape[1], lanes,
            int(forward), torch.cuda.current_stream(L.device).cuda_stream),
        name)
    LAUNCHES[key] += 1
    return out


def tile_solve_cluster(b: int, lanes: int) -> int:
    """The cluster size (CTAs a lane) the solve kernel takes for ``lanes``
    lanes of b-wide tiles on the current card (0 where it takes no such
    b)."""
    got = cuda_build.load(_SIGNATURES).cim_tile_solve_cluster(b, lanes)
    if got < 0:
        raise RuntimeError(f"tile_solve_cluster: CUDA error {-got}")
    return got


def _tile_solve_lanes(L, invd, rhs, fwd: SolvePass, bwd: SolvePass, key: str,
                      passes: int = 3):
    """The passes over the lanes (leading axis) on the card, one launch each:
    ``passes`` 3 both, 1 the forward one alone, 2 the backward one alone."""
    y = tile_solve_pass(L, invd, rhs, fwd, True, key) if passes & 1 else rhs
    return tile_solve_pass(L, invd, y, bwd, False, key) if passes & 2 else y


def _fma(a: torch.Tensor, c: torch.Tensor, acc: torch.Tensor, f32: bool) -> torch.Tensor:
    """The kernel's fused multiply-add on float32 values held in float64,
    rounded once to float32 (``f32``); else a·c + acc in float64."""
    return chol_cuda._fma32(a, c, acc) if f32 else a * c + acc


def _split(x: torch.Tensor, dim: int, quads: bool) -> torch.Tensor:
    """Axis ``dim`` (of length b) of ``x`` as the kernel's partials split it,
    padded with zeros: (U, 32, 4) with q = 128·u + 4·l + j (``quads``), or
    (U, 32) with q = 32·u + l."""
    dim = dim % x.dim()
    b, width = x.shape[dim], 128 if quads else 32
    U = -(-b // width)
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, width * U - b]
    inner = (U, 32, 4) if quads else (U, 32)
    return F.pad(x, pad).reshape(*x.shape[:dim], *inner, *x.shape[dim + 1:])


def _butterfly(P: torch.Tensor, dim: int, dt) -> torch.Tensor:
    """The 32 partials along ``dim`` added as the kernel's butterfly does
    (partial l plus partial l + 16, then l + 8, ...), in ``dt``."""
    P = P.to(dt).movedim(dim, -1)
    while P.shape[-1] > 1:
        h = P.shape[-1] // 2
        P = P[..., :h] + P[..., h:]
    return P[..., 0]


def tile_solve_plain(L: torch.Tensor, invd: torch.Tensor, rhs: torch.Tensor,
                     fwd: SolvePass, bwd: SolvePass, passes: int = 3) -> torch.Tensor:
    """``TiledCholesky.solve`` as the solve kernel (``csrc/tile_solve.cu``)
    computes it, in plain PyTorch on any device: leading axes of L (...,
    NT+1, b, b), invd (..., B, b, b) and rhs (..., B·b) are lanes.  In
    float32 bit for bit the kernel's sums: every dot product over a tile
    index q split into 32 partials, partial l one chain of fused
    multiply-adds from zero over the panel step's tiles in list order and
    over its own q ascending (forward, a column index: q = 128·u + 4·l + j;
    backward, a row index: q = 32·u + l), the 32 partials added by the
    kernel's butterfly, one subtraction from the right-hand side where the
    step has tiles; the inverse tile's product the same way over its lower
    triangle (q <= i forward, q >= p backward).  In float64 the same order
    with a·c + acc.  Any b (the kernel takes multiples of 32; others pad q
    with zeros it never adds).  Slow (a host loop over panels, tiles and u): for tests and
    the CPU route of :func:`tile_solve_op`.  ``passes``: 3 both, 1 the
    forward one alone, 2 the backward one alone (on ``rhs``)."""
    dt, work = L.dtype, torch.float64
    f32 = dt == torch.float32
    b, B = L.shape[-1], invd.shape[-3]
    U = -(-b // 32)
    lead = torch.broadcast_shapes(L.shape[:-3], invd.shape[:-3], rhs.shape[:-1])
    q = (32 * torch.arange(U, device=L.device)[:, None]
         + torch.arange(32, device=L.device)[None, :])  # (U, 32): q = 32 u + l
    U4 = -(-b // 128)
    q4 = (128 * torch.arange(U4, device=L.device)[:, None, None]
          + 4 * torch.arange(32, device=L.device)[None, :, None]
          + torch.arange(4, device=L.device)[None, None, :])  # (U4, 32, 4): q = 128 u + 4 l + j
    rows = torch.arange(b, device=L.device)
    r = rhs.reshape(*rhs.shape[:-1], B, b).to(dt)
    fn, bn = fwd.counts.tolist(), bwd.counts.tolist()

    y = torch.zeros(*lead, B, b, dtype=dt, device=L.device)
    if not passes & 1:
        y = r.expand(*lead, B, b)
    for k in range(B if passes & 1 else 0):
        if fn[k]:
            P = torch.zeros(*lead, b, 32, dtype=work, device=L.device)
            for t in range(fn[k]):
                Lt = _split(L[..., int(fwd.ids[k, t]), :, :].to(work), -1, True)  # (.., i, u, l, j)
                vt = _split(y[..., int(fwd.idx[k, t]), :].to(work), -1, True)  # (.., u, l, j)
                for u in range(U4):
                    for j in range(4):
                        P = torch.where(q4[u, :, j] < b, _fma(
                            Lt[..., :, u, :, j], vt[..., None, u, :, j], P, f32), P)
            acc = r[..., k, :] - _butterfly(P, -1, dt)
        else:
            acc = r[..., k, :].expand(*lead, b)
        Ik = _split(invd[..., k, :, :].to(work), -1, True)
        a = _split(acc.to(work), -1, True)
        P = torch.zeros(*lead, b, 32, dtype=work, device=L.device)
        for u in range(U4):
            for j in range(4):
                keep = (q4[u, :, j][None, :] <= rows[:, None]) & (q4[u, :, j][None, :] < b)
                P = torch.where(keep, _fma(Ik[..., :, u, :, j], a[..., None, u, :, j], P, f32), P)
        y[..., k, :] = _butterfly(P, -1, dt)
    if not passes & 2:
        return y.reshape(*lead, B * b)

    z = torch.zeros(*lead, B, b, dtype=dt, device=L.device)
    for k in range(B - 1, -1, -1):
        if bn[k]:
            P = torch.zeros(*lead, 32, b, dtype=work, device=L.device)
            for t in range(bn[k]):
                Lt = _split(L[..., int(bwd.ids[k, t]), :, :].to(work), -2, False)  # (.., u, l, p)
                vt = _split(z[..., int(bwd.idx[k, t]), :].to(work), -1, False)  # (.., u, l)
                for u in range(U):
                    keep = (q[u] < b)[:, None]
                    P = torch.where(keep, _fma(Lt[..., u, :, :], vt[..., u, :, None], P, f32), P)
            acc = y[..., k, :] - _butterfly(P, -2, dt)
        else:
            acc = y[..., k, :]
        Ik = _split(invd[..., k, :, :].to(work), -2, False)  # (.., u, l, p): row q, column p
        a = _split(acc.to(work), -1, False)
        P = torch.zeros(*lead, 32, b, dtype=work, device=L.device)
        for u in range(U):
            keep = (q[u][:, None] >= rows[None, :]) & (q[u] < b)[:, None]
            P = torch.where(keep, _fma(Ik[..., u, :, :], a[..., u, :, None], P, f32), P)
        z[..., k, :] = _butterfly(P, -2, dt)
    return z.reshape(*lead, B * b)


@torch.library.custom_op("cim::tile_solve", mutates_args=())
def tile_solve_op(L: torch.Tensor, invd: torch.Tensor, rhs: torch.Tensor,
                  fwd_ids: torch.Tensor, fwd_j: torch.Tensor, fwd_n: torch.Tensor,
                  rows_ids: torch.Tensor, rows_i: torch.Tensor, rows_n: torch.Tensor,
                  tiles: int, passes: int = 3) -> torch.Tensor:
    """``TiledCholesky.solve`` of one lane by the kernel, two launches
    (:func:`tile_solve_plain` on CPU tensors), as an operator: under
    ``torch.func.vmap`` (any of L, invd and rhs batched, the tables shared)
    two launches for the whole batch.  ``passes`` 1 or 2: the forward or
    the backward pass alone, one launch."""
    fwd = SolvePass(fwd_ids, fwd_j, fwd_n, tiles)
    bwd = SolvePass(rows_ids, rows_i, rows_n, tiles)
    if not L.is_cuda:
        return tile_solve_plain(L, invd, rhs, fwd, bwd, passes)
    return _tile_solve_lanes(L[None], invd[None], rhs[None], fwd, bwd, "tile_solve",
                             passes)[0]


@tile_solve_op.register_fake
def _(L, invd, rhs, fwd_ids, fwd_j, fwd_n, rows_ids, rows_i, rows_n, tiles, passes=3):
    return rhs.new_empty(rhs.shape)


@tile_solve_op.register_vmap
def _(info, in_dims, L, invd, rhs, fwd_ids, fwd_j, fwd_n, rows_ids, rows_i, rows_n, tiles,
      passes=3):
    if any(d is not None for d in in_dims[3:9]):
        raise ValueError(f"cim::tile_solve under vmap takes shared tables (in_dims {in_dims})")
    n = info.batch_size
    L, invd, rhs = (x.movedim(d, 0) if d is not None else x.expand(n, *x.shape)
                    for x, d in zip((L, invd, rhs), in_dims[:3]))
    fwd = SolvePass(fwd_ids, fwd_j, fwd_n, tiles)
    bwd = SolvePass(rows_ids, rows_i, rows_n, tiles)
    if not L.is_cuda:
        return tile_solve_plain(L, invd, rhs, fwd, bwd, passes), 0
    return _tile_solve_lanes(L, invd, rhs, fwd, bwd, "tile_solve_batched", passes), 0


def tile_solve(eng, L: torch.Tensor, invd: torch.Tensor, rhs: torch.Tensor,
               passes: int = 3) -> torch.Tensor:
    """``TiledCholesky.solve`` of the engine ``eng`` through
    :func:`tile_solve_op`: one lane (two launches) or, inside a lane of a
    batched solver, every lane at once (two launches); ``passes`` as
    there."""
    return tile_solve_op(L, invd, rhs, eng.fwd_ids, eng.fwd_j, eng.fwd_n, eng.rows_ids,
                         eng.rows_i, eng.rows_n, eng.NT - eng.B, passes)
