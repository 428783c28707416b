"""Launch the hand-written Hopper blocked-Cholesky kernels.

The kernels (``csrc/potrf.cu``, CUDA C++ for ``sm_90a``) replace the Pallas
TPU kernel ``cholesky_is_magic_tpu/ops/pallas_chol.py`` ``_potrf_kernel``
(launched there by ``_potrf``, reached from ``cholesky``):

- :func:`potrf_tile_` (``cim_potrf_tile_f32``): one CTA factors one (b, b)
  tile, b <= 128, in shared memory and writes L and L⁻¹ — the kernel's
  ``_chol_fori`` + ``_tri_inv_fori``; :func:`potrf_tile` the same into new
  tensors (the sparse tile engine's panel factor), and
  :func:`potrf_tile_batched` (``cim_potrf_tile_f32_batched``) a (B, b, b)
  stack of tiles in one launch, a CTA per lane, each lane bit-equal to the
  single launch on it: the panel factor of the batched sparse solvers, where
  ``jax.vmap`` of the JAX engine batches its tile Cholesky;
- :func:`potrf` drives the kernel's panel loop from the host over the
  matrix in global memory: per 128-column panel :func:`potrf_tile_` on the
  diagonal block, :func:`potrf_panel_` (``cim_potrf_panel_f32``:
  P = A_panel·Minvᵀ in place, and the panel's upper strip zeroed) and
  :func:`potrf_schur_` (``cim_potrf_schur_f32``: the trailing
  lower-triangle update S -= P·Pᵀ), the last split in two launches so that
  the part the next panel needs does not wait for the rest.

What bounds them on the H100 (see the .cu file): the tile kernel runs on
one SM and is bound by its chain of b dependent pivots; it is blocked over
32-column sub-panels (one warp factors each diagonal block in registers,
all warps share the register-tiled products).  The panel kernel moves too
few bytes to be bound by the card's rates: CTAs of ``PANEL_ROWS_PER_CTA``
whole rows each stage the inverse and their rows along k, with 16-byte
copies where :func:`aligned16` allows, and run 4 x 2 register tiles, two
warps per 4 rows, that stop at each column's diagonal.  The Schur kernel is
bound by the FP32 FMA rate: one CTA per tile on or below the diagonal (64 x 64,
or 32 x 32 while those put at most two on an SM), the whole depth of its
operands staged by ``cp.async`` in four k-stages, 4 x 4 (4 x 2) outputs per
thread from 16-byte shared-memory loads.  The panel loop's
critical path is tile -> panel -> the next block column's update -> tile, so
:func:`potrf` queues the rest of each trailing update on a second stream,
where it runs beside the next tile kernel (one SM), and launches from
addresses inside the matrix, so that the host stays ahead of the card.

The plain versions are ``ops.chol._factor_tile_plain`` (``cholesky_ex`` +
``solve_triangular``), ``torch.tril(S - P @ P.T)`` and
``ops.chol.blocked_cholesky``; :func:`schur_fma_plain` is the Schur kernel's
own sums in plain PyTorch, bit for bit, and :func:`tile_schur_fma_plain`
those of the tile engine's Schur kernel (``csrc/tile_schur.cu``, launched
by ``sparse.tiled_cuda``).  ``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

from ctypes import c_int as _I
from ctypes import c_longlong as _LL
from ctypes import c_void_p as _P

import torch

from cholesky_is_magic_tpu_torch.ops import cuda_build

LAUNCHES = {"potrf_tile": 0, "potrf_tile_batched": 0, "potrf_panel": 0,
            "potrf_schur": 0}

_SIGNATURES = {
    "cim_potrf_tile_f32": [_P, _LL, _P, _LL, _I, _P],
    "cim_potrf_tile_f32_batched": [_P, _LL, _LL, _P, _LL, _LL, _P, _LL, _LL,
                                   _I, _I, _P],
    "cim_potrf_panel_f32": [_P, _LL, _P, _LL, _P, _I, _I, _I, _I, _I, _P],
    "cim_potrf_schur_f32": [_P, _LL, _P, _LL, _I, _I, _I, _I, _P],
}

BLOCK = 128  # panel width; also the largest tile potrf_tile_ takes
PANEL_ROWS = (4, 8, 16, 32)  # rows per CTA the panel kernel takes
# The wrapper's: each CTA stages the whole inverse, faster with more threads
# (16 per row) but slower at 32 rows; 16 was the fastest at every panel step
# of n = 1536 and 1441 on an NVIDIA H100 80GB HBM3 at 700.00 W
# (tools/probe_panel_kernel.py).
PANEL_ROWS_PER_CTA = 16


def _check_square(A: torch.Tensor, name: str, max_n: int | None = None) -> None:
    if not A.is_cuda:
        raise ValueError(f"{name} takes CUDA tensors")
    if A.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 (got {A.dtype})")
    if A.dim() != 2 or A.shape[0] != A.shape[1] or A.shape[0] < 1:
        raise ValueError(f"{name}: shape {tuple(A.shape)} is not square")
    if max_n is not None and A.shape[0] > max_n:
        raise ValueError(f"{name}: tile {A.shape[0]} wider than {max_n}")
    if A.stride(1) != 1:
        raise ValueError(f"{name} takes tensors with contiguous rows")


def _stream(A: torch.Tensor) -> int:
    return torch.cuda.current_stream(A.device).cuda_stream


def _launch(kernel: str, *args) -> None:
    """Counts and launches ``cim_<kernel>_f32(*args)``: addresses, strides
    and sizes as integers, the CUDA stream last.  The wrappers below check
    their tensors first; :func:`potrf` passes addresses inside the matrix it
    has checked."""
    lib = cuda_build.load(_SIGNATURES)
    LAUNCHES[kernel] += 1
    cuda_build.raise_on(getattr(lib, f"cim_{kernel}_f32")(*args), kernel)


def potrf_tile_(T: torch.Tensor, inv: torch.Tensor) -> None:
    """In place on the card: T <- its lower Cholesky factor (lower triangle
    read, upper written as zeros), inv <- L⁻¹; both all-NaN on a non-PD
    tile.  T and inv are (b, b) f32 with contiguous rows, b <= 128 (views
    into larger matrices are fine; ``chol.factor_tile_`` splits wider
    tiles around this kernel)."""
    _check_square(T, "potrf_tile_", BLOCK)
    _check_square(inv, "potrf_tile_", BLOCK)
    if inv.shape != T.shape or inv.device != T.device:
        raise ValueError("potrf_tile_: inv must match the tile")
    _launch("potrf_tile", T.data_ptr(), T.stride(0), inv.data_ptr(), inv.stride(0),
            T.shape[0], _stream(T))


def potrf_tile(T: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, L⁻¹) of the (b, b) f32 CUDA tile T, b <= 128, as new tensors (T's
    lower triangle read, T untouched): :func:`potrf_tile_`'s kernel writing
    elsewhere, with the same bits."""
    L, inv = _tile_launch(T[None], "potrf_tile")
    return L[0], inv[0]


def potrf_tile_batched(T: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, L⁻¹) of every tile of the (B, b, b) f32 CUDA stack T, b <= 128, in
    one launch, a CTA per lane: (B, b, b) each, lane k bit-equal to
    :func:`potrf_tile` of T[k].  T may have any lane stride (0 repeats one
    tile) and row stride, with contiguous rows."""
    return _tile_launch(T, "potrf_tile_batched")


def _tile_launch(T: torch.Tensor, counter: str) -> tuple[torch.Tensor, torch.Tensor]:
    if T.dim() != 3:
        raise ValueError(f"{counter}: a (B, b, b) stack, got {tuple(T.shape)}")
    _check_square(T[0], counter, BLOCK)
    lanes, b = T.shape[0], T.shape[-1]
    if lanes < 1:
        raise ValueError(f"{counter}: no tiles")
    L = torch.empty((lanes, b, b), dtype=T.dtype, device=T.device)
    inv = torch.empty_like(L)
    lib = cuda_build.load(_SIGNATURES)
    LAUNCHES[counter] += 1
    cuda_build.raise_on(lib.cim_potrf_tile_f32_batched(
        T.data_ptr(), T.stride(1), T.stride(0), L.data_ptr(), b, b * b,
        inv.data_ptr(), b, b * b, b, lanes, _stream(T)), counter)
    return L, inv


def _check_rows(A: torch.Tensor, name: str) -> None:
    if not A.is_cuda or A.dtype != torch.float32:
        raise ValueError(f"{name} takes float32 CUDA tensors")
    if A.dim() != 2 or A.stride(1) != 1:
        raise ValueError(f"{name} takes matrices with contiguous rows")


def aligned16(ptr: int, ld: int) -> bool:
    """Whether every row of a float32 matrix at address ``ptr`` with row
    stride ``ld`` starts on a 16-byte boundary (16-byte copies allowed)."""
    return ptr % 16 == 0 and ld % 4 == 0


def potrf_panel_(P: torch.Tensor, inv: torch.Tensor, strip: torch.Tensor) -> None:
    """In place on the card: P <- P·invᵀ for the (rows, b) panel P and the
    (b, b) inv, of which only the lower triangle is read; ``strip``
    (b, rows), the panel's mirror above the diagonal, is zeroed and must
    share P's row stride."""
    _potrf_panel(P, inv, strip, PANEL_ROWS_PER_CTA)


def _potrf_panel(P: torch.Tensor, inv: torch.Tensor, strip: torch.Tensor,
                 rows_per_cta: int) -> None:
    """:func:`potrf_panel_` at ``rows_per_cta`` (one of ``PANEL_ROWS``)."""
    if rows_per_cta not in PANEL_ROWS:
        raise ValueError(f"potrf_panel_: rows_per_cta {rows_per_cta} not in {PANEL_ROWS}")
    _check_rows(P, "potrf_panel_")
    _check_square(inv, "potrf_panel_", BLOCK)
    _check_rows(strip, "potrf_panel_")
    rows, b = P.shape
    if inv.shape[0] != b or rows < 1:
        raise ValueError(f"potrf_panel_: panel {tuple(P.shape)}, inv "
                         f"{tuple(inv.shape)}")
    if strip.shape != (b, rows) or strip.stride(0) != P.stride(0):
        raise ValueError("potrf_panel_: strip must be the panel's mirror")
    _launch("potrf_panel", P.data_ptr(), P.stride(0), inv.data_ptr(), inv.stride(0),
            strip.data_ptr(), rows, b, rows_per_cta, aligned16(P.data_ptr(), P.stride(0)),
            aligned16(inv.data_ptr(), inv.stride(0)), _stream(P))


def potrf_schur_(S: torch.Tensor, P: torch.Tensor, cols: int | None = None) -> None:
    """In place on the card: the lower triangle of the (t, t) block S
    minus P·Pᵀ for the (t, b) panel P, b <= 128; with ``cols``, only its
    columns [0, cols).  S's upper triangle is not touched.  Every entry is
    one chain of fused multiply-adds, k ascending, subtracted from S once
    (:func:`schur_fma_plain`), whatever ``cols``."""
    _check_square(S, "potrf_schur_")
    _check_rows(P, "potrf_schur_")
    t, b = P.shape
    cols = t if cols is None else cols
    if S.shape[0] != t or S.device != P.device:
        raise ValueError(f"potrf_schur_: S {tuple(S.shape)}, P {tuple(P.shape)}")
    if not (1 <= b <= BLOCK and 1 <= cols <= t):
        raise ValueError(f"potrf_schur_: depth {b} (at most {BLOCK}), cols {cols} of {t}")
    _launch("potrf_schur", S.data_ptr(), S.stride(0), P.data_ptr(), P.stride(0), t, b, cols,
            aligned16(P.data_ptr(), P.stride(0)), _stream(S))


def _fma32(a: torch.Tensor, c: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """float32(a·c + acc) rounded once, for float32 values held in float64
    tensors.  The product is exact in float64 (48 bits); two_sum gives the
    rounding error of the sum, and an inexact sum is moved to its neighbour
    with an odd last bit (rounding to odd), after which the rounding to
    float32 is that of the exact value (53 >= 2·24 + 2 bits).  Adding in
    float64 and rounding again would round twice."""
    s = a * c
    hi = s + acc
    bb = hi - s
    lo = (s - (hi - bb)) + (acc - bb)
    inexact_even = (lo != 0) & ((hi.view(torch.int64) & 1) == 0)
    toward = torch.where(lo > 0, float("inf"), float("-inf")).to(hi.dtype)
    hi = torch.where(inexact_even, torch.nextafter(hi, toward), hi)
    return hi.float().double()


def schur_fma_plain(S: torch.Tensor, P: torch.Tensor, cols: int | None = None) -> torch.Tensor:
    """What :func:`potrf_schur_` leaves in S, in plain PyTorch on any device,
    bit for bit (finite float32 operands): per entry one accumulator from
    zero, ``fma(P[i, k], P[j, k], acc)`` for k ascending, one float32
    subtraction from S; the lower triangle of the columns [0, cols).  Slow
    (b passes over a (t, t) float64 array): for tests."""
    t, b = P.shape
    cols = t if cols is None else cols
    P64 = P.double()
    acc = torch.zeros((t, t), dtype=torch.float64, device=P.device)
    for k in range(b):
        acc = _fma32(P64[:, k, None], P64[None, :, k], acc)
    idx = torch.arange(t, device=P.device)
    owned = (idx[None, :] <= idx[:, None]) & (idx[None, :] < cols)
    return torch.where(owned, S - acc.float(), S)


def tile_schur_fma_plain(S: torch.Tensor, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """S - A·Bᵀ as the tile engine's Schur kernel (``csrc/tile_schur.cu``)
    computes it, in plain PyTorch on any device, bit for bit: per entry one
    accumulator from zero, ``fma(A[i, t], B[j, t], acc)`` for t ascending,
    one float32 subtraction from S.  S (..., r, c), A (..., r, k) and B
    (..., c, k), float32, leading axes broadcast (lanes, pairs).  Slow (k
    passes over a float64 array of S's size): for tests and the CPU route
    of ``sparse.tiled_cuda.tile_schur_``."""
    A64, B64 = A.double(), B.double()
    acc = torch.zeros(torch.broadcast_shapes(S.shape, A.shape[:-1] + (1,),
                                             B.shape[:-2] + (1, B.shape[-2])),
                      dtype=torch.float64, device=S.device)
    for t in range(A.shape[-1]):
        acc = _fma32(A64[..., :, t, None], B64[..., None, :, t], acc)
    return S - acc.float()


_STREAMS: dict[int, tuple] = {}


def _streams(device: torch.device) -> tuple:
    """The device's two streams for :func:`potrf`, made once: one for the
    chain of kernels that each wait on the one before, one for the updates
    beside it; and three events."""
    key = torch.cuda.current_device() if device.index is None else device.index
    if key not in _STREAMS:
        _STREAMS[key] = (torch.cuda.Stream(device), torch.cuda.Stream(device),
                         *(torch.cuda.Event() for _ in range(3)))
    return _STREAMS[key]


def potrf(N: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of the SPD (n, n) f32 matrix N on the card, by
    128-column panels (N's lower triangle is read; N is not modified).  A
    non-PD input yields NaN from the failing panel on.

    The chain that cannot be shortened is tile kernel -> panel kernel -> the
    update of the next block column -> the next tile kernel; it runs on one
    stream.  Step k's update of the columns beyond the next block column runs
    on a second stream, behind an event recorded after the chain's update,
    beside step k + 1's tile kernel (one CTA on one SM).  The chain waits for
    that second launch only before step k + 1's own update, which lowers the
    same entries.  Both streams start behind the caller's, and the caller's
    waits for the chain's end, which follows the last second launch.  Every
    entry gets the same sums in the same order as from one whole update per
    step, so the factor's bits do not depend on the split."""
    _check_square(N, "potrf")
    n = N.shape[0]
    A = N.contiguous().clone()
    inv = torch.empty((BLOCK, BLOCK), dtype=A.dtype, device=A.device)
    caller = torch.cuda.current_stream(A.device)
    chain, beside, at_caller, at_chain, at_beside = _streams(A.device)
    on_chain, on_beside = chain.cuda_stream, beside.cuda_stream
    # Addresses inside A and inv, not views: ~45 launches from Python, and the
    # card should not wait for the host.
    base, ip, vec_inv = A.data_ptr(), inv.data_ptr(), aligned16(inv.data_ptr(), BLOCK)

    def at(i: int, j: int) -> int:
        return base + 4 * (i * n + j)

    at_caller.record(caller)
    chain.wait_event(at_caller)
    for off in range(0, n, BLOCK):
        e, e2 = min(off + BLOCK, n), min(off + 2 * BLOCK, n)
        w = e - off
        _launch("potrf_tile", at(off, off), n, ip, BLOCK, w, on_chain)
        if e == n:
            break
        _launch("potrf_panel", at(e, off), n, ip, BLOCK, at(off, e), n - e, w,
                PANEL_ROWS_PER_CTA, aligned16(at(e, off), n), vec_inv, on_chain)
        if off:
            chain.wait_event(at_beside)  # the previous step's second launch
        _launch("potrf_schur", at(e, e), n, at(e, off), n, n - e, w, e2 - e,
                aligned16(at(e, off), n), on_chain)
        if e2 < n:
            at_chain.record(chain)
            beside.wait_event(at_chain)
            _launch("potrf_schur", at(e2, e2), n, at(e2, off), n, n - e2, w, n - e2,
                    aligned16(at(e2, off), n), on_beside)
            at_beside.record(beside)
    at_chain.record(chain)
    caller.wait_event(at_chain)
    return A
