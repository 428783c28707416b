"""Launch the hand-written Hopper blocked-Cholesky kernels.

The kernels (``csrc/potrf.cu``, CUDA C++ for ``sm_90a``) replace the Pallas
TPU kernel ``cholesky_is_magic_tpu/ops/pallas_chol.py`` ``_potrf_kernel``
(launched there by ``_potrf``, reached from ``cholesky``):

- :func:`potrf_tile_` (``cim_potrf_tile_f32``): one CTA factors one (b, b)
  tile, b <= 128, in shared memory and writes L and L⁻¹ — the kernel's
  ``_chol_fori`` + ``_tri_inv_fori``, and the sparse tile engine's panel
  factor;
- :func:`potrf` drives the kernel's panel loop from the host over the
  matrix in global memory: per 128-column panel :func:`potrf_tile_` on the
  diagonal block, :func:`potrf_panel_` (``cim_potrf_panel_f32``:
  P = A_panel·Minvᵀ in place, and the panel's upper strip zeroed) and
  :func:`potrf_schur_` (``cim_potrf_schur_f32``: the trailing
  lower-triangle update S -= P·Pᵀ).

What bounds them on the H100 (see the .cu file): the tile kernel runs on
one SM and is bound by its chain of b dependent pivots; it is blocked over
32-column sub-panels (one warp factors each diagonal block in registers,
all warps share the register-tiled products).  The panel kernel moves too
few bytes to be bound by the card's rates: CTAs of ``PANEL_ROWS_PER_CTA``
whole rows each stage the inverse and their rows along k, with 16-byte
copies where :func:`aligned16` allows, and run 4 x 2 register tiles, two
warps per 4 rows, that stop at each column's diagonal.  The Schur kernel is a SIMT product that reads its
operands once per block.

The plain versions are ``ops.chol._factor_tile_plain`` (``cholesky_ex`` +
``solve_triangular``) and ``ops.chol.blocked_cholesky``.  ``LAUNCHES``
counts the kernel launches.
"""

from __future__ import annotations

from ctypes import c_int as _I
from ctypes import c_longlong as _LL
from ctypes import c_void_p as _P

import torch

from cholesky_is_magic_tpu_torch.ops import cuda_build

LAUNCHES = {"potrf_tile": 0, "potrf_panel": 0, "potrf_schur": 0}

_SIGNATURES = {
    "cim_potrf_tile_f32": [_P, _LL, _P, _LL, _I, _P],
    "cim_potrf_panel_f32": [_P, _LL, _P, _LL, _P, _I, _I, _I, _I, _I, _P],
    "cim_potrf_schur_f32": [_P, _LL, _P, _LL, _I, _I, _P],
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
    lib = cuda_build.load(_SIGNATURES)
    LAUNCHES["potrf_tile"] += 1
    cuda_build.raise_on(
        lib.cim_potrf_tile_f32(T.data_ptr(), T.stride(0), inv.data_ptr(),
                               inv.stride(0), T.shape[0], _stream(T)),
        "potrf_tile_")


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
    lib = cuda_build.load(_SIGNATURES)
    LAUNCHES["potrf_panel"] += 1
    cuda_build.raise_on(
        lib.cim_potrf_panel_f32(
            P.data_ptr(), P.stride(0), inv.data_ptr(), inv.stride(0),
            strip.data_ptr(), rows, b, rows_per_cta,
            aligned16(P.data_ptr(), P.stride(0)),
            aligned16(inv.data_ptr(), inv.stride(0)), _stream(P)),
        "potrf_panel_")


def potrf_schur_(S: torch.Tensor, P: torch.Tensor) -> None:
    """In place on the card: the lower triangle of the (t, t) block S
    minus P·Pᵀ for the (t, b) panel P; S's upper triangle is not touched."""
    _check_square(S, "potrf_schur_")
    _check_rows(P, "potrf_schur_")
    t, b = P.shape
    if S.shape[0] != t:
        raise ValueError(f"potrf_schur_: S {tuple(S.shape)}, P {tuple(P.shape)}")
    lib = cuda_build.load(_SIGNATURES)
    LAUNCHES["potrf_schur"] += 1
    cuda_build.raise_on(
        lib.cim_potrf_schur_f32(S.data_ptr(), S.stride(0), P.data_ptr(),
                                P.stride(0), t, b, _stream(S)),
        "potrf_schur_")


def potrf(N: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of the SPD (n, n) f32 matrix N on the card, by
    128-column panels (N's lower triangle is read; N is not modified).  A
    non-PD input yields NaN from the failing panel on."""
    _check_square(N, "potrf")
    n = N.shape[0]
    A = N.contiguous().clone()
    inv = torch.empty((BLOCK, BLOCK), dtype=A.dtype, device=A.device)
    for off in range(0, n, BLOCK):
        e = min(off + BLOCK, n)
        potrf_tile_(A[off:e, off:e], inv[: e - off, : e - off])
        if e == n:
            break
        potrf_panel_(A[e:, off:e], inv[: e - off, : e - off], A[off:e, e:])
        potrf_schur_(A[e:, e:], A[e:, off:e])
    return A
