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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from cholesky_is_magic_tpu_torch.ops import dd as ddm

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
) -> BellMatrix | None:
    """Build a BellMatrix from COO triplets on the host (duplicates summed).

    Returns ``None`` when the blocked footprint exceeds ``max_bytes`` or
    ``max_dense_frac`` of the dense (m x n) bytes — the caller's signal to
    stay on plain ELL.  The same gates as the JAX package."""
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
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
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
    blocks[brow, slot, rows % BR, cols % BC] = vals.astype(np_dtype)
    return BellMatrix(
        blocks=torch.from_numpy(blocks).to(device),
        bcols=torch.from_numpy(bcols).to(device),
        n_rows=m,
        n_cols=n,
    )


def _gather_x(B: BellMatrix, x: torch.Tensor) -> torch.Tensor:
    """(nbr, kb, BC) whole-tile gather of x, zero-padded past n_cols."""
    ncb = -(-B.n_cols // BC)
    xp = F.pad(x, (0, ncb * BC - B.n_cols)).reshape(ncb, BC)
    return xp[B.bcols]


def matvec(B: BellMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x via whole-tile gathers + per-tile dense products."""
    y = torch.einsum("rkij,rkj->ri", B.blocks, _gather_x(B, x))
    return y.reshape(-1)[: B.n_rows]


def dd_matvec(B: BellMatrix, x: torch.Tensor) -> ddm.DD:
    """A @ x in double-word: error-free per-element tile products and
    compensated tree reductions over the lane axis, then the tile axis."""
    xg = _gather_x(B, x)  # (nbr, kb, BC)
    p = ddm.two_prod(B.blocks, xg[:, :, None, :])  # (nbr, kb, BR, BC)
    s = ddm.dd_sum(p, axis=-1)  # lanes -> (nbr, kb, BR)
    s = ddm.dd_sum(s, axis=1)  # tiles -> (nbr, BR)
    return ddm.DD(s.hi.reshape(-1)[: B.n_rows], s.lo.reshape(-1)[: B.n_rows])


def dd_matvec_dd(B: BellMatrix, x: ddm.DD) -> ddm.DD:
    """A @ (x.hi + x.lo) in double-word: dd product on the hi part + a
    working-precision product on the (eps-small) lo part."""
    return ddm.dd_add_w(dd_matvec(B, x.hi), matvec(B, x.lo))
