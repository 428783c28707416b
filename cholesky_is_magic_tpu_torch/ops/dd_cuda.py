"""Launch the hand-written Hopper double-word matvec kernels.

The kernels (``csrc/dd_matvec.cu``, CUDA C++ for ``sm_90a``) replace the
Pallas TPU kernels of ``cholesky_is_magic_tpu/ops/dd_pallas.py``:

- :func:`dd_mv`  (``cim_dd_mv_f32``)  replaces ``_mv_kernel``, launched there
  by ``_dd_mv_partials``: A·x in double-word, one block per row, the row's
  sum finished inside the kernel;
- :func:`dd_rmv` (``cim_dd_rmv_f32``) replaces ``_rmv_kernel``, launched
  there by ``_dd_rmv_partials``: Aᵀ·x in double-word, reading row-major A
  without a transpose copy; row slabs write (slabs, n) partials that a
  second small kernel combines with ``dd_add``.

What bounds them on the H100: every 4-byte element of A costs ~10 flops
(error-free product + compensated accumulation), far below the card's
flop-to-byte balance, so both are bound by device-memory bandwidth; their
design reads A exactly once with coalesced loads (see the .cu file).

The plain version of both is ``ops.dd._dd_matvec_plain`` (on ``A.T`` for
Aᵀ·x).  The results agree with it to a few f32-eps² of Σ|aᵢⱼxⱼ| per row,
not bit for bit: the summation order differs.

The library is built at first use by :mod:`.cuda_build`.  Importing this
module needs no CUDA toolkit.  ``LAUNCHES`` counts the wrapper calls that
launched a kernel.
"""

from __future__ import annotations

from ctypes import c_int as _I
from ctypes import c_longlong as _LL
from ctypes import c_void_p as _P

import torch

from cholesky_is_magic_tpu_torch.ops import cuda_build

LAUNCHES = {"mv": 0, "rmv": 0}

_SIGNATURES = {
    "cim_dd_mv_f32": [_P, _P, _P, _P, _I, _I, _LL, _P],
    "cim_dd_rmv_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _LL, _I, _I, _P],
}

RMV_THREADS = 256  # kRmvThreads in the .cu file


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
    col_blocks = -(-n // RMV_THREADS)
    want = max(1, -(-4 * sms // col_blocks))
    slabs = max(1, min(want, -(-m // 32), 65535))
    rows = -(-m // slabs)
    return -(-m // rows), rows


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
    part = torch.empty((2, slabs, n), dtype=torch.float32, device=A.device)
    lib = cuda_build.load(_SIGNATURES)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    LAUNCHES["rmv"] += 1
    cuda_build.raise_on(
        lib.cim_dd_rmv_f32(A.data_ptr(), x.data_ptr(), hi.data_ptr(),
                           lo.data_ptr(), part[0].data_ptr(),
                           part[1].data_ptr(), m, n, A.stride(0),
                           slabs, rows, stream),
        "dd_rmv")
    return hi, lo
