"""Launch the hand-written double-word block-ELL product (``csrc/bell_dd.cu``).

:func:`dd_mv` (``cim_bell_dd_mv_f32``, kernel ``bell_dd_mv_kernel``)
computes ``ops.bell.dd_matvec`` for float32 operands on the card, bit for
bit: each lane's (hi, lo) are the plain form's (``bell._dd_matvec_plain``).
It replaces no TPU kernel (the JAX package's ``ops/bell.py`` is plain jnp);
it exists because the plain form, run eagerly, writes every intermediate of
its product and its two compensated trees to device memory (see the .cu
file for the design and what bounds it).

:func:`dd_mv_batched` runs B lanes in one launch, at lane strides for the
tiles, their block columns and x (0 shares an operand, as an unbatched
``BellMatrix`` under ``torch.func.vmap``).  ``ops.bell`` reaches both
through the operator ``cim::bell_dd_mv`` (:func:`bell_dd_mv_op`), whose vmap
rule launches :func:`dd_mv_batched` once for the whole batch.

``nnz`` is the matrix's stored nonzeros (``BellMatrix.nnz``), a plain int
handed to the wrappers so that a record of a launch can name its work
without reading the card; the kernel does not use it.  ``LAUNCHES`` counts
the wrapper calls that launched the kernel, single and batched apart, under
keys of their own beside the other kernels' (``utils.spans`` merges them).  The
library is built at first use by :mod:`.cuda_build`; importing this module
needs no CUDA toolkit.
"""

from __future__ import annotations

from ctypes import c_int as _I
from ctypes import c_longlong as _LL
from ctypes import c_void_p as _P

import torch

from cholesky_is_magic_tpu_torch.ops import cuda_build
from cholesky_is_magic_tpu_torch.ops.bell import BC, BR

LAUNCHES = {"bell_mv": 0, "bell_mv_batched": 0}

_SIGNATURES = {
    "cim_bell_dd_mv_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _LL, _LL, _LL, _P],
}


def _lane_contiguous(t: torch.Tensor) -> bool:
    """Whether each lane of ``t`` (axis 0 the lanes) is laid out row-major
    (dimensions of size 1 take any stride)."""
    want = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size > 1 and stride != want:
            return False
        want *= size
    return True


def _launch(blocks: torch.Tensor, bcols: torch.Tensor, x: torch.Tensor,
            n_rows: int, name: str) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch over the lanes of (B, nbr, kb, 8, 128) float32 tiles,
    (B, nbr, kb) int64 block columns and (B, n_cols) float32 x on one CUDA
    device, each lane's tiles and block columns row-major and x of unit
    stride, ``n_rows`` in the last block-row: (hi, lo), each (B, n_rows)."""
    if not (blocks.is_cuda and bcols.is_cuda and x.is_cuda):
        raise ValueError(f"{name} takes CUDA tensors")
    if len({blocks.device, bcols.device, x.device}) != 1:
        raise ValueError(f"{name}: operands on {blocks.device}, {bcols.device}, {x.device}")
    if blocks.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 (got {blocks.dtype}, {x.dtype})")
    if bcols.dtype != torch.int64:
        raise TypeError(f"{name} takes int64 block columns (got {bcols.dtype})")
    if (blocks.dim() != 5 or blocks.shape[3:] != (BR, BC) or bcols.shape != blocks.shape[:3]
            or x.dim() != 2 or x.shape[0] != blocks.shape[0]):
        raise ValueError(f"{name}: shapes {tuple(blocks.shape)}, {tuple(bcols.shape)} and"
                         f" {tuple(x.shape)} do not match")
    lanes, nbr, kb = blocks.shape[:3]
    if not (kb >= 1 and 8 * (nbr - 1) < n_rows <= 8 * nbr):
        raise ValueError(f"{name}: {n_rows} rows in {nbr} block-rows of {kb} tiles")
    if not (_lane_contiguous(blocks) and _lane_contiguous(bcols) and x.stride(1) == 1):
        raise ValueError(f"{name} takes each lane's tiles and block columns row-major"
                         " and x of unit stride")
    if blocks.data_ptr() % 16 or blocks.stride(0) % 4:  # the kernel's 16-byte loads
        blocks = (blocks[:1] if blocks.stride(0) == 0 else blocks).clone(
            memory_format=torch.contiguous_format).expand_as(blocks)
    hi = torch.empty(lanes, n_rows, dtype=torch.float32, device=x.device)
    lo = torch.empty(lanes, n_rows, dtype=torch.float32, device=x.device)
    lib = cuda_build.load(_SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    cuda_build.raise_on(
        lib.cim_bell_dd_mv_f32(blocks.data_ptr(), bcols.data_ptr(), x.data_ptr(),
                               hi.data_ptr(), lo.data_ptr(), nbr, kb, n_rows,
                               x.shape[1], lanes, blocks.stride(0), bcols.stride(0),
                               x.stride(0), stream),
        name)
    return hi, lo


def dd_mv_batched(blocks: torch.Tensor, bcols: torch.Tensor, x: torch.Tensor,
                  n_rows: int, nnz: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Lane k's block-ELL product (blocks[k] (nbr, kb, 8, 128), bcols[k]
    (nbr, kb)) times x[k] in double-word, every lane in one launch: (hi,
    lo), each (B, n_rows) float32; lane k bit-equal to
    ``ops.bell._dd_matvec_plain`` on it."""
    LAUNCHES["bell_mv_batched"] += 1
    return _launch(blocks, bcols, x, n_rows, "bell dd_mv_batched")


def dd_mv(blocks: torch.Tensor, bcols: torch.Tensor, x: torch.Tensor,
          n_rows: int, nnz: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The block-ELL product (blocks (nbr, kb, 8, 128), bcols (nbr, kb))
    times x (n_cols,) in double-word on the card: (hi, lo), each (n_rows,)
    float32, bit-equal to ``ops.bell._dd_matvec_plain``."""
    if blocks.dim() != 4 or bcols.dim() != 2 or x.dim() != 1:
        raise ValueError(f"bell dd_mv: shapes {tuple(blocks.shape)}, {tuple(bcols.shape)}"
                         f" and {tuple(x.shape)} do not match")
    LAUNCHES["bell_mv"] += 1
    hi, lo = _launch(blocks[None], bcols[None], x[None], n_rows, "bell dd_mv")
    return hi[0], lo[0]


def _lanes(batch: int, args, in_dims):
    """The vmap rule's tensors with the batch axis first: a vmapped one
    moved there, an unbatched one expanded (lane stride 0); a lane that is
    not row-major made so for the kernel."""
    out = []
    for t, d in zip(args, in_dims):
        t = t.movedim(d, 0) if d is not None else t.expand(batch, *t.shape)
        out.append(t if _lane_contiguous(t) else t.contiguous())
    return out


@torch.library.custom_op("cim::bell_dd_mv", mutates_args=())
def bell_dd_mv_op(blocks: torch.Tensor, bcols: torch.Tensor, x: torch.Tensor,
                  n_rows: int, nnz: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`dd_mv` as an operator; under ``torch.func.vmap`` one
    :func:`dd_mv_batched` launch for the whole batch."""
    return dd_mv(blocks, bcols, x, n_rows, nnz)


@bell_dd_mv_op.register_fake
def _(blocks, bcols, x, n_rows, nnz):
    return x.new_empty(n_rows), x.new_empty(n_rows)


@bell_dd_mv_op.register_vmap
def _(info, in_dims, blocks, bcols, x, n_rows, nnz):
    lanes = _lanes(info.batch_size, (blocks, bcols, x), in_dims[:3])
    return dd_mv_batched(*lanes, n_rows, nnz), (0, 0)
