"""Launch the hand-written Hopper double-word matvec kernels.

The kernels (``csrc/dd_matvec.cu``, CUDA C++ for ``sm_90a``) replace the
Pallas TPU kernels of ``cholesky_is_magic_tpu/ops/dd_pallas.py``:

- :func:`dd_mv`  (``cim_dd_mv_f32``)  replaces ``_mv_kernel``, launched there
  by ``_dd_mv_partials``: A·x in double-word, the row's sum finished inside
  the kernel, its order that of a block of MV_THREADS threads per row; rows
  of at most MV_SHORT_MAX columns take a warp per group of rows that keeps
  that order (the same bits) and reduces the group's warp trees together;
- :func:`dd_rmv` (``cim_dd_rmv_f32``) replaces ``_rmv_kernel``, launched
  there by ``_dd_rmv_partials``: Aᵀ·x in double-word, reading row-major A
  without a transpose copy, in one launch; a thread accumulates two
  neighbouring columns over its row slab, a chunk of rows' loads at a time,
  and the slabs' partials are added in slab order with ``dd_add``.  Lanes of
  at most RMV_SHORT_SLABS slabs (512 rows on a narrow lane) take a kernel
  whose block holds every slab of its columns and adds the partials in
  shared memory; longer ones leave (slabs, n) partials in L2, and the last
  block to arrive for a column block (an integer ticket) adds them.  Either
  way the same sums in the same order.

What bounds them on the H100: every 4-byte element of A costs ~10 flops
(error-free product + compensated accumulation), far below the card's
flop-to-byte balance, so both are bound by device-memory bandwidth; their
design reads A exactly once with coalesced loads (see the .cu file).

The plain version of both is ``ops.dd._dd_matvec_plain`` (on ``A.T`` for
Aᵀ·x).  The results agree with it to a few f32-eps² of Σ|aᵢⱼxⱼ| per row,
not bit for bit: the summation order differs.  :func:`rmv_slab_plain` is
Aᵀ·x in plain PyTorch in the kernel's own order (rows ascending inside a
slab, slabs ascending), and :func:`mv_order_plain` A·x in its kernels'
(threads striding over the columns, each warp's shuffle tree, the warps in
order), which the kernels match bit for bit.

Batches: :func:`dd_mv_batched` / :func:`dd_rmv_batched`
(``cim_dd_mv_f32_batched`` / ``cim_dd_rmv_f32_batched``) run B lanes of the
same (m, n) in one launch, a lane per block row of the grid, each lane
bit-equal to the single call on it.  They replace what the JAX package gets
from ``pallas_call``'s batching rule when the batched solvers vmap the two
Pallas kernels.  ``ops.dd`` reaches the kernels through the custom operators
``cim::dd_mv`` / ``cim::dd_rmv`` (:func:`dd_mv_op`, :func:`dd_rmv_op`),
whose ``torch.func.vmap`` rule launches the batched kernel once for the
whole batch: a vmapped solver loop (``parallel.batched``) then takes the
kernels with the batch axis written out, where a raw pointer of a vmapped
tensor would not exist.

The library is built at first use by :mod:`.cuda_build`.  Importing this
module needs no CUDA toolkit.  ``LAUNCHES`` counts the wrapper calls that
launched a kernel, single and batched apart.
"""

from __future__ import annotations

from ctypes import c_int as _I
from ctypes import c_longlong as _LL
from ctypes import c_void_p as _P

import torch

from cholesky_is_magic_tpu_torch.ops import cuda_build
from cholesky_is_magic_tpu_torch.ops import dd as ddm

LAUNCHES = {"mv": 0, "rmv": 0, "mv_batched": 0, "rmv_batched": 0}

_SIGNATURES = {
    "cim_dd_mv_f32": [_P, _P, _P, _P, _I, _I, _LL, _P],
    "cim_dd_rmv_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _LL, _LL, _I, _I,
                       _P],
    "cim_dd_mv_f32_batched": [_P, _P, _P, _P, _I, _I, _LL, _I, _LL, _LL, _P],
    "cim_dd_rmv_f32_batched": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _LL, _LL,
                               _I, _I, _I, _LL, _LL, _P],
}

# Lanes of one batched launch: the grid's y (mv) or z (rmv) extent.
MAX_LANES = 65535

# Columns per block of the Aᵀ·x kernel (kRmvCtaCols of csrc/dd_matvec.cu):
# one ticket each, and the width of a column block in rmv_slabs' count, which
# fixes the slab partition and with it the order of the sums.
RMV_CTA_COLS = 256

# Lanes of at most this many slabs take the short-lane Aᵀ·x kernel
# (kRmvShortSlabs), which needs neither partials nor tickets.
RMV_SHORT_SLABS = 16

# Per (device, stream): the zeroed tickets of dd_rmv's column blocks.  Each
# launch leaves them zero again, and launches on one stream run in turn, so
# no call pays for a memset.  A ticket that was not zero on entry makes the
# kernel trap (the launch's last arrival then counts past its slabs), so a
# stale count is a CUDA error at the next synchronisation, never a wrong sum.
_TICKETS: dict = {}


def _check(A: torch.Tensor, x: torch.Tensor, k: int, name: str) -> None:
    if not (A.is_cuda and x.is_cuda):
        raise ValueError(f"{name} takes CUDA tensors")
    if A.device != x.device:
        raise ValueError(f"{name}: A on {A.device}, x on {x.device}")
    if A.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 (got {A.dtype}, {x.dtype})")
    if A.dim() != 2 or x.dim() != 1 or x.shape[0] != A.shape[k]:
        raise ValueError(
            f"{name}: shapes {tuple(A.shape)} and {tuple(x.shape)} do not match"
        )
    if not (A.is_contiguous() and x.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")


def rmv_slabs(m: int, n: int, sms: int) -> tuple[int, int]:
    """(slabs, rows_per_slab) for Aᵀ·x: enough row slabs that the grid has
    ~4 blocks per SM, each slab at least 32 rows, at most 65535 slabs."""
    col_blocks = -(-n // RMV_CTA_COLS)
    want = max(1, -(-4 * sms // col_blocks))
    slabs = max(1, min(want, -(-m // 32), 65535))
    rows = -(-m // slabs)
    return -(-m // rows), rows


def _tickets(device, stream, count: int) -> torch.Tensor:
    """At least ``count`` zeroed tickets for launches on ``stream``."""
    tickets = _TICKETS.get((device, stream))
    if tickets is None or tickets.numel() < count:
        tickets = torch.zeros(count, dtype=torch.int32, device=device)
        _TICKETS[(device, stream)] = tickets
    return tickets


def _scratch(device, stream, lanes: int, n: int, slabs: int):
    """The long Aᵀ·x kernel's scratch: (ldp, partials (2, lanes, slabs,
    ldp), the partials' and tickets' addresses) with ldp a multiple of 4 >=
    n; on the short path, which takes neither, (0, None, nulls).  The caller
    holds the partials until its launch is queued."""
    if slabs <= RMV_SHORT_SLABS:
        return 0, None, (0, 0, 0)
    ldp = -(-n // 4) * 4
    part = torch.empty((2, lanes, slabs, ldp), dtype=torch.float32, device=device)
    tickets = _tickets(device, stream, lanes * -(-n // RMV_CTA_COLS))
    return ldp, part, (part[0].data_ptr(), part[1].data_ptr(), tickets.data_ptr())


def dd_mv(A: torch.Tensor, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A·x in double-word on the card: (hi, lo), each (m,) f32."""
    _check(A, x, 1, "dd_mv")
    m, n = A.shape
    hi = torch.empty(m, dtype=torch.float32, device=A.device)
    lo = torch.empty(m, dtype=torch.float32, device=A.device)
    if m == 0:
        return hi, lo
    lib = cuda_build.load(_SIGNATURES)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    LAUNCHES["mv"] += 1
    cuda_build.raise_on(
        lib.cim_dd_mv_f32(A.data_ptr(), x.data_ptr(), hi.data_ptr(),
                          lo.data_ptr(), m, n, A.stride(0), stream),
        "dd_mv")
    return hi, lo


def dd_rmv(A: torch.Tensor, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Aᵀ·x in double-word on the card, reading A row-major: (hi, lo),
    each (n,) f32."""
    _check(A, x, 0, "dd_rmv")
    m, n = A.shape
    if m == 0 or n == 0:
        zero = torch.zeros(n, dtype=torch.float32, device=A.device)
        return zero, zero.clone()
    sms = torch.cuda.get_device_properties(A.device).multi_processor_count
    slabs, rows = rmv_slabs(m, n, sms)
    hi = torch.empty(n, dtype=torch.float32, device=A.device)
    lo = torch.empty(n, dtype=torch.float32, device=A.device)
    lib = cuda_build.load(_SIGNATURES)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    ldp, part, scratch = _scratch(A.device, stream, 1, n, slabs)
    LAUNCHES["rmv"] += 1
    cuda_build.raise_on(
        lib.cim_dd_rmv_f32(A.data_ptr(), x.data_ptr(), hi.data_ptr(),
                           lo.data_ptr(), *scratch, m, n,
                           A.stride(0), ldp, slabs, rows, stream),
        "dd_rmv")
    return hi, lo


def _check_batched(A: torch.Tensor, x: torch.Tensor, k: int, name: str) -> None:
    """As :func:`_check` for (B, m, n) A and (B, ·) x: float32 CUDA tensors
    on one device, unit stride along a row and along x, any lane and row
    strides (0 shares one operand across the lanes), 1 <= B <= MAX_LANES."""
    if not (A.is_cuda and x.is_cuda):
        raise ValueError(f"{name} takes CUDA tensors")
    if A.device != x.device:
        raise ValueError(f"{name}: A on {A.device}, x on {x.device}")
    if A.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 (got {A.dtype}, {x.dtype})")
    if (A.dim() != 3 or x.dim() != 2 or x.shape[0] != A.shape[0]
            or x.shape[1] != A.shape[1 + k]):
        raise ValueError(
            f"{name}: shapes {tuple(A.shape)} and {tuple(x.shape)} do not match"
        )
    if not 1 <= A.shape[0] <= MAX_LANES:
        raise ValueError(f"{name}: {A.shape[0]} lanes, the kernel takes 1 to "
                         f"{MAX_LANES}")
    if A.stride(2) != 1 or x.stride(1) != 1:
        raise ValueError(f"{name} takes rows and x with unit stride")


def dd_mv_batched(A: torch.Tensor, x: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """A[k]·x[k] in double-word for every lane k in one launch: (hi, lo),
    each (B, m) f32; lane k bit-equal to ``dd_mv(A[k], x[k])``."""
    _check_batched(A, x, 1, "dd_mv_batched")
    lanes, m, n = A.shape
    hi = torch.empty(lanes, m, dtype=torch.float32, device=A.device)
    lo = torch.empty(lanes, m, dtype=torch.float32, device=A.device)
    if m == 0:
        return hi, lo
    lib = cuda_build.load(_SIGNATURES)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    LAUNCHES["mv_batched"] += 1
    cuda_build.raise_on(
        lib.cim_dd_mv_f32_batched(A.data_ptr(), x.data_ptr(), hi.data_ptr(),
                                  lo.data_ptr(), m, n, A.stride(1), lanes,
                                  A.stride(0), x.stride(0), stream),
        "dd_mv_batched")
    return hi, lo


def dd_rmv_batched(A: torch.Tensor, x: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """A[k]ᵀ·x[k] in double-word for every lane k in one launch: (hi, lo),
    each (B, n) f32.  The slab partition is the single call's
    (:func:`rmv_slabs` of one lane), so lane k is bit-equal to
    ``dd_rmv(A[k], x[k])``; on long lanes one ticket per (lane, column
    block)."""
    _check_batched(A, x, 0, "dd_rmv_batched")
    lanes, m, n = A.shape
    if m == 0 or n == 0:
        zero = torch.zeros(lanes, n, dtype=torch.float32, device=A.device)
        return zero, zero.clone()
    sms = torch.cuda.get_device_properties(A.device).multi_processor_count
    slabs, rows = rmv_slabs(m, n, sms)
    hi = torch.empty(lanes, n, dtype=torch.float32, device=A.device)
    lo = torch.empty(lanes, n, dtype=torch.float32, device=A.device)
    lib = cuda_build.load(_SIGNATURES)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    ldp, part, scratch = _scratch(A.device, stream, lanes, n, slabs)
    LAUNCHES["rmv_batched"] += 1
    cuda_build.raise_on(
        lib.cim_dd_rmv_f32_batched(A.data_ptr(), x.data_ptr(), hi.data_ptr(),
                                   lo.data_ptr(), *scratch, m,
                                   n, A.stride(1), ldp, slabs, rows, lanes,
                                   A.stride(0), x.stride(0), stream),
        "dd_rmv_batched")
    return hi, lo


def _lanes(batch: int, args, in_dims):
    """The vmap rule's operands with the batch axis first: a vmapped one
    moved there, an unbatched one expanded (lane stride 0); rows with a
    non-unit stride are made contiguous for the kernel."""
    out = []
    for t, d in zip(args, in_dims):
        t = t.movedim(d, 0) if d is not None else t.expand(batch, *t.shape)
        out.append(t if t.stride(-1) == 1 else t.contiguous())
    return out


@torch.library.custom_op("cim::dd_mv", mutates_args=())
def dd_mv_op(A: torch.Tensor, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`dd_mv` as an operator; under ``torch.func.vmap`` one
    :func:`dd_mv_batched` launch for the whole batch."""
    return dd_mv(A, x)


@dd_mv_op.register_fake
def _(A, x):
    return A.new_empty(A.shape[0]), A.new_empty(A.shape[0])


@dd_mv_op.register_vmap
def _(info, in_dims, A, x):
    return dd_mv_batched(*_lanes(info.batch_size, (A, x), in_dims)), (0, 0)


@torch.library.custom_op("cim::dd_rmv", mutates_args=())
def dd_rmv_op(A: torch.Tensor, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`dd_rmv` as an operator; under ``torch.func.vmap`` one
    :func:`dd_rmv_batched` launch for the whole batch."""
    return dd_rmv(A, x)


@dd_rmv_op.register_fake
def _(A, x):
    return A.new_empty(A.shape[1]), A.new_empty(A.shape[1])


@dd_rmv_op.register_vmap
def _(info, in_dims, A, x):
    return dd_rmv_batched(*_lanes(info.batch_size, (A, x), in_dims)), (0, 0)


def rmv_slab_plain(A: torch.Tensor, x: torch.Tensor, slabs: int,
                   rows: int) -> ddm.DD:
    """Aᵀ·x for float32 A (..., m, n) and x (..., m) in plain PyTorch, in
    :func:`dd_rmv`'s own order (either kernel, single or batched): each
    column adds its slab's rows in ascending order into a double-word (the
    kernel's ``dd_accumulate``), and the slabs' partials are added in
    ascending order with ``dd_add``, from slab 0's.  The product error is
    the kernel's fma(a, x, -p), exact here by way of float64.  One small
    operation per row: for checks, not for speed."""
    *lead, m, n = A.shape
    if m and -(-m // rows) != slabs:
        raise ValueError(f"{slabs} slabs of {rows} rows do not cover {m} rows")
    total = None
    for r0 in range(0, max(m, 1), rows):
        hi = torch.zeros(*lead, n, dtype=A.dtype, device=A.device)
        lo = torch.zeros_like(hi)
        for i in range(r0, min(m, r0 + rows)):
            a, xi = A[..., i, :], x[..., i, None]
            p = a * xi
            e = (a.double() * xi.double() - p.double()).to(A.dtype)
            s = ddm.two_sum(hi, p)
            low = lo + (s.lo + e)
            hi = s.hi + low
            lo = low - (hi - s.hi)
        part = ddm.DD(hi, lo)
        total = part if total is None else ddm.dd_add(total, part)
    return total


# Threads of dd_mv_kernel's block (kMvThreads of csrc/dd_matvec.cu): each
# sums the columns t, t + MV_THREADS, ..., which fixes the order of A·x's
# sums, on either of its kernels.
MV_THREADS = 128
# Rows of at most this many columns take the short-row kernel (kMvShortMax).
MV_SHORT_MAX = 384


def mv_order_plain(A: torch.Tensor, x: torch.Tensor) -> ddm.DD:
    """A·x for float32 A (..., m, n) and x (..., n) in plain PyTorch, in
    :func:`dd_mv`'s own order (either kernel, single or batched): thread t
    of MV_THREADS adds the columns j = t, t + MV_THREADS, ... in ascending
    order into a double-word (the kernel's ``dd_accumulate``), each warp of
    32 threads sums its threads with ``dd_add`` at the offsets 16, 8, 4, 2,
    1, and the warps' sums are added in order 0 to 3.  The product error is
    the kernel's fma(a, x, -p), exact here by way of float64.  For checks,
    not for speed."""
    *lead, m, n = A.shape
    hi = torch.zeros(*lead, m, MV_THREADS, dtype=A.dtype, device=A.device)
    lo = torch.zeros_like(hi)
    for j0 in range(0, n, MV_THREADS):
        cols = min(MV_THREADS, n - j0)
        a = A[..., j0:j0 + cols]
        xv = x[..., None, j0:j0 + cols]
        p = a * xv
        e = (a.double() * xv.double() - p.double()).to(A.dtype)
        s = ddm.two_sum(hi[..., :cols], p)
        low = lo[..., :cols] + (s.lo + e)
        h = s.hi + low
        lo[..., :cols] = low - (h - s.hi)
        hi[..., :cols] = h
    warps = ddm.DD(hi.unflatten(-1, (MV_THREADS // 32, 32)),
                   lo.unflatten(-1, (MV_THREADS // 32, 32)))
    for off in (16, 8, 4, 2, 1):
        warps = ddm.dd_add(ddm.DD(warps.hi[..., :off], warps.lo[..., :off]),
                           ddm.DD(warps.hi[..., off:2 * off], warps.lo[..., off:2 * off]))
    total = ddm.DD(warps.hi[..., 0, 0], warps.lo[..., 0, 0])
    for w in range(1, MV_THREADS // 32):
        total = ddm.dd_add(total, ddm.DD(warps.hi[..., w, 0], warps.lo[..., w, 0]))
    return total
