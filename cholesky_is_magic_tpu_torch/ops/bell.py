"""Block-ELL sparse matvec: dense (8, 128) tiles instead of element gathers.

Counterpart of ``cholesky_is_magic_tpu/ops/bell.py``.  The matrix is cut
into dense (8, 128) tiles; each 8-row block-row stores its nonempty tiles
padded to a common count ``kb``, and the product is

    y[8r : 8r+8] = sum_k  blocks[r, k] @ x[128 * bcols[r, k] : ...+128]

Zero-padded tiles (bcols 0, values 0) are inert.  The (8, 128) tile is the
TPU's f32 register tile; the port keeps it because the sparse loops'
double-word products ride this layout in the JAX package, and the same
layout keeps their summation order for the parity tests.  A layout chosen
for the card (CSR) is later work.

:func:`from_coo` returns ``None`` when the blocked footprint exceeds its
byte gates; the callers then keep the plain ELL products (ops.sparse_ops).
It can hold long rows apart (``apart_rows``, an ``ops.sparse_ops.RowsApart``,
a dense block of them, as ``sparse_ops.from_coo`` does), so that they
neither set ``kb`` nor trip the gates; the products add them back.

:func:`dd_matvec` on float32 CUDA operands launches the hand-written
kernel of :mod:`.bell_cuda` (``csrc/bell_dd.cu``), which keeps the plain
form's order and so its bits; the JAX package has no kernel here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from cholesky_is_magic_tpu_torch.ops import dd as ddm
from cholesky_is_magic_tpu_torch.ops import sparse_ops
from cholesky_is_magic_tpu_torch.ops.cuda_build import takes_kernel
from cholesky_is_magic_tpu_torch.utils.spans import span

BR = 8  # block rows
BC = 128  # block cols


@dataclasses.dataclass(frozen=True)
class BellMatrix:
    """Block-ELL matrix: dense (8, 128) tiles, one padded tile list per
    8-row block-row, with its logical shape."""

    blocks: torch.Tensor  # (nbr, kb, BR, BC); 0.0 on padded tiles
    bcols: torch.Tensor  # (nbr, kb) int64 block-column ids; 0 on padded tiles
    n_rows: int
    n_cols: int
    # Stored nonzeros (duplicates summed), for a record of the work on the
    # host; 0: not counted.  Not part of the structure: ``utils.lanes``
    # stacks matrices of one pattern whatever their counts.
    nnz: int = dataclasses.field(default=0, compare=False)
    apart: "sparse_ops.RowsApart | None" = None  # rows held apart, or None

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def kb(self) -> int:
        return self.blocks.shape[1]


def from_coo(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: tuple[int, int],
    dtype=torch.float32,
    max_bytes: int = 256 * 1024 * 1024,
    max_dense_frac: float = 1.0,
    device="cuda",
    apart_rows=None,
) -> BellMatrix | None:
    """Build a BellMatrix from COO triplets on the host (duplicates summed).

    Returns ``None`` when the blocked footprint exceeds ``max_bytes`` or
    ``max_dense_frac`` of the dense (m x n) bytes — the caller's signal to
    stay on plain ELL.  The same gates as the JAX package.  ``apart_rows``:
    rows held apart, as ``sparse_ops.from_coo`` holds them."""
    (rows, cols, vals), apart = sparse_ops.rows_apart(rows, cols, vals, shape,
                                                      apart_rows, dtype, device)
    m, n = shape
    if m == 0 or len(vals) == 0:
        return None
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals, dtype=np.float64)
    # Sum duplicates at the triplet level (f64, nnz-sized).
    key = rows.astype(np.int64) * n + cols.astype(np.int64)
    order = np.argsort(key, kind="stable")
    key_sorted = key[order]
    uniq_key, start = np.unique(key_sorted, return_index=True)
    vals = np.add.reduceat(vals[order], start)
    rows = (uniq_key // n).astype(np.int64)
    cols = (uniq_key % n).astype(np.int64)
    nbr = -(-m // BR)
    brow = rows // BR
    bcol = cols // BC
    # Distinct tiles per block-row -> kb.
    tile_ids = brow * ((n // BC) + 2) + bcol
    uniq = np.unique(tile_ids)
    tiles_per_brow = np.bincount((uniq // ((n // BC) + 2)).astype(np.int64),
                                 minlength=nbr)
    kb = max(int(tiles_per_brow.max()), 1)
    np_dtype = torch.zeros((), dtype=dtype).numpy().dtype
    bytes_bell = nbr * kb * BR * BC * np_dtype.itemsize
    if (bytes_bell > max_bytes
            or bytes_bell > max_dense_frac * m * n * np_dtype.itemsize):
        return None
    blocks = np.zeros((nbr, kb, BR, BC), dtype=np_dtype)
    bcols = np.zeros((nbr, kb), dtype=np.int64)
    # Slot of each tile within its block-row (tiles sorted by (brow, bcol)).
    slot_of_tile = np.concatenate(
        [np.arange(c, dtype=np.int64) for c in tiles_per_brow]
    ) if nbr else np.zeros(0, np.int64)
    tile_slot = dict(zip(uniq.tolist(), slot_of_tile.tolist()))
    br_of_tile = (uniq // ((n // BC) + 2)).astype(np.int64)
    bc_of_tile = (uniq % ((n // BC) + 2)).astype(np.int64)
    for t, b_r, b_c in zip(uniq.tolist(), br_of_tile.tolist(),
                           bc_of_tile.tolist()):
        bcols[b_r, tile_slot[t]] = b_c
    slot = np.array([tile_slot[t] for t in tile_ids.tolist()], dtype=np.int64)
    # Triplets are unique after the dedup: plain assignment.
    vals = vals.astype(np_dtype)
    blocks[brow, slot, rows % BR, cols % BC] = vals
    return BellMatrix(
        blocks=torch.from_numpy(blocks).to(device),
        bcols=torch.from_numpy(bcols).to(device),
        n_rows=m,
        n_cols=n,
        nnz=int(np.count_nonzero(vals)),
        apart=apart,
    )


def _gather_x(B: BellMatrix, x: torch.Tensor) -> torch.Tensor:
    """(nbr, kb, BC) whole-tile gather of x, zero-padded past n_cols."""
    ncb = -(-B.n_cols // BC)
    xp = F.pad(x, (0, ncb * BC - B.n_cols)).reshape(ncb, BC)
    return xp[B.bcols]


@span("ops.bell.matvec")
def matvec(B: BellMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x via whole-tile gathers + per-tile dense products."""
    y = torch.einsum("rkij,rkj->ri", B.blocks, _gather_x(B, x)).reshape(-1)[: B.n_rows]
    return y if B.apart is None else B.apart.matvec(y, x)


@span("ops.bell.dd_matvec")
def dd_matvec(B: BellMatrix, x: torch.Tensor) -> ddm.DD:
    """A @ x in double-word: error-free per-element tile products and
    compensated tree reductions over the lane axis, then the tile axis.

    Float32 CUDA operands go to the hand-written kernel through its operator
    (:func:`.bell_cuda.bell_dd_mv_op`: one launch, under ``torch.func.vmap``
    one for the whole batch), bit-equal to the plain form; a CPU tensor, or
    another dtype on the card, to :func:`_dd_matvec_plain`.  Rows held
    apart come from the dense double-word product of their block."""
    if takes_kernel(x.device, B.blocks.dtype, x.dtype):
        from cholesky_is_magic_tpu_torch.ops import bell_cuda

        y = ddm.DD(*bell_cuda.bell_dd_mv_op(B.blocks, B.bcols, x, B.n_rows, B.nnz))
    else:
        y = _dd_matvec_plain(B, x)
    return y if B.apart is None else B.apart.dd_matvec(y, x)


def _dd_matvec_plain(B: BellMatrix, x: torch.Tensor) -> ddm.DD:
    """The plain form of :func:`dd_matvec` (the JAX package's, line for
    line): Dekker's product of every tile element, then ``dd_sum`` over a
    tile row's 128 columns and over the block-row's kb tiles, padded tiles
    included.  The CPU path and the kernel's yardstick."""
    xg = _gather_x(B, x)  # (nbr, kb, BC)
    p = ddm.two_prod(B.blocks, xg[:, :, None, :])  # (nbr, kb, BR, BC)
    s = ddm.dd_sum(p, axis=-1)  # lanes -> (nbr, kb, BR)
    s = ddm.dd_sum(s, axis=1)  # tiles -> (nbr, BR)
    return ddm.DD(s.hi.reshape(-1)[: B.n_rows], s.lo.reshape(-1)[: B.n_rows])


def dd_matvec_dd(B: BellMatrix, x: ddm.DD) -> ddm.DD:
    """A @ (x.hi + x.lo) in double-word: dd product on the hi part + a
    working-precision product on the (eps-small) lo part."""
    return ddm.dd_add_w(dd_matvec(B, x.hi), matvec(B, x.lo))
