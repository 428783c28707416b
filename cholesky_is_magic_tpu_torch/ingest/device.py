"""Standard form -> device operands.

Counterpart of ``cholesky_is_magic_tpu/ingest/device.py``: ``round_up``,
``DeviceLP``, ``to_device_lp``, the matrix-free ``SparseLP`` (built by
``to_sparse_lp``) and the fully sparse ``SparseKKTLP`` (built by
``solvers.pdas.make_pdas_sparse``).  Every dense LP is embedded into a
(M, N) box rounded up to ``pad_multiple`` with boolean validity masks, and
the padding is inert exactly as in the JAX package:

- padded columns: A[:, j] = 0, c[j] = 0, bounds [-1, 1] — their slacks are
  1 and the solvers mask their directions to 0;
- padded rows: A[i, :] = 0, b[i] = 0 — the normal matrix gets +1 on those
  diagonal entries (``row_boost``), so the Cholesky stays positive definite
  and the corresponding dy is exactly 0.

PyTorch needs no static shapes, but the padded box is kept so that the port
and the reference run on identical operands.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cholesky_is_magic_tpu_torch.ingest.standard_form import StandardForm


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class DeviceLP:
    """Padded dense LP operands.

    ``m``/``n`` are the *true* constraint/variable counts; tensor shapes are
    the padded (M, N).
    """

    A: torch.Tensor  # (M, N)
    c: torch.Tensor  # (N,)
    b: torch.Tensor  # (M,)
    l: torch.Tensor  # (N,)
    u: torch.Tensor  # (N,)
    row_mask: torch.Tensor  # (M,) bool, True = real row
    col_mask: torch.Tensor  # (N,) bool, True = real column
    row_type: torch.Tensor  # (M,) int8, StandardForm.ROW_EQ/LE/GE (0 when padded)
    m: int
    n: int

    @property
    def shape(self) -> tuple[int, int]:
        return self.A.shape[-2], self.A.shape[-1]


@dataclasses.dataclass(frozen=True)
class SparseLP:
    """Sparse operands of the matrix-free path (APPROX / ALM).

    No padding: the APPROX / ALM solvers are gathers and elementwise work,
    so memory follows nnz(A), not m*n.  ``EB`` / ``ETB`` are the block-ELL
    renderings of A and Aᵀ (ops.bell) that the products ride when the byte
    gates of ``bell.from_coo`` admit them; ``None`` otherwise, and the
    products fall back to the ELL gather and scatter-add
    (``sparse_ops.rmatvec``, whose ``index_add_`` sums in no fixed order on
    the card).
    """

    E: object  # ops.sparse_ops.ELLMatrix, (m, n)
    EB: object  # ops.bell.BellMatrix of A, or None (gate: bell.from_coo)
    ETB: object  # ops.bell.BellMatrix of Aᵀ, or None
    c: torch.Tensor  # (n,)
    b: torch.Tensor  # (m,)
    l: torch.Tensor  # (n,)
    u: torch.Tensor  # (n,)
    row_type: torch.Tensor  # (m,) int8
    m: int
    n: int


@dataclasses.dataclass(frozen=True)
class SparseKKTLP:
    """Fully sparse operand set for the interior-point (KKT) solvers.

    The at-scale twin of DeviceLP (the JAX package's ``SparseKKTLP``): A
    lives as ELL pairs (E = A, ET = Aᵀ, ops.sparse_ops) and, when the byte
    gates of ops.bell admit them, block-ELL renderings (EB, ETB) that the
    loops' A-products ride; no dense (m, n) operand exists.  No padding is
    needed (the tile engine pads rows internally with boosted gap slots),
    so the masks are all-true and exist only for code shared with the
    padded dense path.
    """

    E: object  # ops.sparse_ops.ELLMatrix, (m, n)
    ET: object  # ELLMatrix of Aᵀ, (n, m)
    c: torch.Tensor  # (n,)
    b: torch.Tensor  # (m,)
    l: torch.Tensor  # (n,)
    u: torch.Tensor  # (n,)
    row_mask: torch.Tensor  # (m,) bool, all True
    col_mask: torch.Tensor  # (n,) bool, all True
    m: int
    n: int
    EB: object = None  # ops.bell.BellMatrix of A, or None
    ETB: object = None  # ops.bell.BellMatrix of Aᵀ, or None


def to_device_lp(
    sf: StandardForm,
    *,
    pad_multiple: int = 128,
    dtype: torch.dtype = torch.float32,
    device="cuda",
    big: float = 1e30,
    shape: tuple[int, int] | None = None,
) -> DeviceLP:
    """Embed a StandardForm into a padded DeviceLP on ``device``.

    Infinite bounds are encoded as +/-``big`` so that the tensors never hold
    actual infinities (inf - inf would poison masked arithmetic).  The
    operands are assembled in f64 on the host and rounded once to ``dtype``,
    as the JAX package does, so both packages see bit-identical data.
    ``shape`` forces an explicit padded (M, N).
    """
    m, n = sf.ncons, sf.nvars
    if shape is not None:
        M, N = shape
        if M < m or N < n:
            raise ValueError(f"shape {shape} smaller than problem ({m}, {n})")
    else:
        M = round_up(max(m, 1), pad_multiple)
        N = round_up(max(n, 1), pad_multiple)

    A = np.zeros((M, N), dtype=np.float64)
    np.add.at(A, (sf.a_rows, sf.a_cols), sf.a_vals)
    c = np.zeros(N)
    c[:n] = sf.c
    b = np.zeros(M)
    b[:m] = sf.b
    l = np.full(N, -1.0)
    u = np.full(N, 1.0)
    l[:n] = np.clip(sf.l, -big, big)
    u[:n] = np.clip(sf.u, -big, big)
    row_mask = np.zeros(M, dtype=bool)
    row_mask[:m] = True
    col_mask = np.zeros(N, dtype=bool)
    col_mask[:n] = True
    row_type = np.zeros(M, dtype=np.int8)
    row_type[:m] = sf.row_type

    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    put = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return DeviceLP(
        A=put(A.astype(np_dtype)),
        c=put(c.astype(np_dtype)),
        b=put(b.astype(np_dtype)),
        l=put(l.astype(np_dtype)),
        u=put(u.astype(np_dtype)),
        row_mask=put(row_mask),
        col_mask=put(col_mask),
        row_type=put(row_type),
        m=m,
        n=n,
    )


def to_sparse_lp(sf: StandardForm, *, dtype: torch.dtype = torch.float32,
                 device="cuda", big: float = 1e30,
                 bell_max_bytes: int = 256 * 1024 * 1024,
                 bell_max_dense_frac: float = 1.0) -> SparseLP:
    """StandardForm -> ELL-backed sparse operands on ``device`` (no padding).

    ``bell_max_bytes`` / ``bell_max_dense_frac`` are the storage gates of
    ``ops.bell.from_coo`` for the EB / ETB renderings, as in the JAX
    package: raise ``bell_max_dense_frac`` for small LPs whose blocked
    footprint is marginally above the dense bytes (``ALMConfig.dd_gradient``
    needs the block-ELL forms)."""
    from cholesky_is_magic_tpu_torch.ops import bell, sparse_ops

    shape, shape_t = (sf.ncons, sf.nvars), (sf.nvars, sf.ncons)
    gates = dict(dtype=dtype, device=device, max_bytes=bell_max_bytes,
                 max_dense_frac=bell_max_dense_frac)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    put = lambda v: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(np.asarray(v, np.float64).astype(np_dtype))).to(device)
    return SparseLP(
        E=sparse_ops.from_coo(sf.a_rows, sf.a_cols, sf.a_vals, shape,
                              dtype=dtype, device=device),
        EB=bell.from_coo(sf.a_rows, sf.a_cols, sf.a_vals, shape, **gates),
        ETB=bell.from_coo(sf.a_cols, sf.a_rows, sf.a_vals, shape_t, **gates),
        c=put(sf.c),
        b=put(sf.b),
        l=put(np.clip(sf.l, -big, big)),
        u=put(np.clip(sf.u, -big, big)),
        row_type=torch.from_numpy(np.asarray(sf.row_type)).to(device),
        m=sf.ncons,
        n=sf.nvars,
    )
