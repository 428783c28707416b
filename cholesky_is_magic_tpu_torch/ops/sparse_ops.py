"""Padded-ELL sparse matrix products: the cholmod_sdmult replacement.

Counterpart of ``cholesky_is_magic_tpu/ops/sparse_ops.py``.  A is stored in
ELL layout — every row padded to the same slot count — so the product is
one gather, one elementwise multiply and one row reduction:

    y_i = sum_k  values[i, k] * x[indices[i, k]]

and the transposed product is a scatter-add over the same slots
(``index_add_``, which sums duplicate indices).  Padded slots carry index 0
and value 0: masking by value, not by index, keeps the gather branch-free.
Indices are int64, as torch indexing takes them.

A few long rows (Aᵀ's rows of A's dense columns) would set every row's
slot count: :func:`from_coo` can hold them apart (``apart_rows``), as a
:class:`RowsApart`, a dense block of those rows beside the padded form of
the others, and every product here adds their entries back (through the
dense double-word product, ``ops.dd.dd_matvec``, where the product is
double-word).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cholesky_is_magic_tpu_torch.ops import dd as ddm
from cholesky_is_magic_tpu_torch.utils.spans import span


@dataclasses.dataclass(frozen=True)
class ELLMatrix:
    """Row-padded sparse matrix (ELLPACK layout) with its logical column
    count; ``apart``: rows held apart (their slots here empty), or None."""

    indices: torch.Tensor  # (m, k) int64, 0 on padded slots
    values: torch.Tensor  # (m, k), 0.0 on padded slots
    n_cols: int
    apart: "RowsApart | None" = None

    @property
    def shape(self):
        return (self.indices.shape[0], self.n_cols)


@dataclasses.dataclass(frozen=True)
class RowsApart:
    """The rows of a matrix held apart from its padded form (an
    :class:`ELLMatrix`, or an ``ops.bell.BellMatrix``), whose slots for
    them are empty: ``A`` (k, n_cols) the rows as a dense block, ``rows``
    (k,) their row numbers, and ``take`` (m,), i for row i of the padded form
    and m + j for the j-th row held apart, which :meth:`merge` gathers by."""

    A: torch.Tensor
    rows: torch.Tensor
    take: torch.Tensor

    def merge(self, main: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
        """The product over every row: ``main`` (over the padded form, zero
        on the rows held apart) with those rows' entries replaced by
        ``part``'s, each an exact copy."""
        return torch.cat([main, part], dim=-1)[..., self.take]

    def matvec(self, main: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``main`` (the padded form's product with x) completed by the held
        rows' product."""
        return self.merge(main, torch.matmul(self.A, x))

    def dd_matvec(self, main: ddm.DD, x: torch.Tensor) -> ddm.DD:
        """``main`` (the padded form's double-word product with x) completed
        by the held rows' double-word product."""
        part = ddm.dd_matvec(self.A, x)
        return ddm.DD(self.merge(main.hi, part.hi), self.merge(main.lo, part.lo))


def rows_apart(rows, cols, vals, shape, apart_rows, dtype, device):
    """(the triplets of every other row, the :class:`RowsApart` of
    ``apart_rows``, duplicates summed), or the triplets as they are and None
    where ``apart_rows`` is empty or None."""
    if apart_rows is None or len(apart_rows) == 0:
        return (rows, cols, vals), None
    m, n = shape
    apart_rows = np.unique(np.asarray(apart_rows, np.int64))
    rows, cols, vals = (np.asarray(a) for a in (rows, cols, vals))
    held = np.isin(rows, apart_rows)
    block = np.zeros((len(apart_rows), n))
    np.add.at(block, (np.searchsorted(apart_rows, rows[held]), cols[held]), vals[held])
    take = np.arange(m, dtype=np.int64)
    take[apart_rows] = m + np.arange(len(apart_rows))
    put = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return ((rows[~held], cols[~held], vals[~held]),
            RowsApart(A=put(block).to(dtype), rows=put(apart_rows), take=put(take)))


def from_coo(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: tuple[int, int],
    dtype=torch.float32,
    min_slots: int = 1,
    device="cuda",
    apart_rows=None,
) -> ELLMatrix:
    """Build an ELLMatrix from COO triplets on the host (duplicates summed,
    the CHOLMOD triplet->CSC semantics, sparse-cholesky.lisp:433-459).
    ``apart_rows``: rows held apart (:class:`RowsApart`), so that the slot
    count is the longest of the other rows'."""
    import scipy.sparse as sp

    (rows, cols, vals), apart = rows_apart(rows, cols, vals, shape, apart_rows,
                                           dtype, device)
    m, n = shape
    C = sp.csr_matrix((vals, (rows, cols)), shape=shape)  # sums duplicates
    C.sort_indices()
    counts = np.diff(C.indptr)
    k = max(int(counts.max()) if m else 0, min_slots)
    indices = np.zeros((m, k), dtype=np.int64)
    values = np.zeros((m, k), dtype=np.float64)
    for i in range(m):
        c = counts[i]
        indices[i, :c] = C.indices[C.indptr[i] : C.indptr[i + 1]]
        values[i, :c] = C.data[C.indptr[i] : C.indptr[i + 1]]
    return ELLMatrix(
        indices=torch.from_numpy(indices).to(device),
        values=torch.from_numpy(values).to(device=device, dtype=dtype),
        n_cols=n,
        apart=apart,
    )


def from_dense(A: np.ndarray, dtype=torch.float32, device="cuda") -> ELLMatrix:
    rows, cols = np.nonzero(A)
    return from_coo(rows, cols, np.asarray(A)[rows, cols], A.shape,
                    dtype=dtype, device=device)


@span("ops.ell.matvec")
def matvec(E: ELLMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x: gather + row reduction (sparse-m*, no transpose)."""
    y = torch.sum(E.values * x[E.indices], dim=1)
    return y if E.apart is None else E.apart.matvec(y, x)


def rmatvec(E: ELLMatrix, y: torch.Tensor) -> torch.Tensor:
    """z = Aᵀ @ y: scatter-add over the slots (sparse-m* :transpose t)."""
    contrib = E.values * y[:, None]
    out = torch.zeros(E.n_cols, dtype=contrib.dtype, device=contrib.device)
    out = out.index_add_(0, E.indices.reshape(-1), contrib.reshape(-1))
    return out if E.apart is None else out + torch.matmul(y[E.apart.rows], E.apart.A)


def scale_columns(E: ELLMatrix, d: torch.Tensor) -> ELLMatrix:
    """A · diag(d): the scale-sparse! analogue (sparse-cholesky.lisp:461-477),
    the per-column scale gathered into each slot."""
    apart = E.apart if E.apart is None else dataclasses.replace(
        E.apart, A=E.apart.A * d)
    return dataclasses.replace(E, values=E.values * d[E.indices], apart=apart)


def sdmult(
    E: ELLMatrix,
    x: torch.Tensor,
    y: torch.Tensor | None = None,
    alpha: float = 1.0,
    beta: float = 0.0,
    transpose: bool = False,
) -> torch.Tensor:
    """y <- alpha·op(A)·x + beta·y, the full sparse-m* signature
    (sparse-cholesky.lisp:567-614)."""
    out = alpha * (rmatvec(E, x) if transpose else matvec(E, x))
    if y is not None and beta != 0.0:
        out = out + beta * y
    return out


@span("ops.ell.dd_matvec")
def dd_matvec(E: ELLMatrix, x: torch.Tensor) -> ddm.DD:
    """A @ x in double-word: error-free slot products + compensated row
    reduction (the ELL twin of ops.dd.dd_matvec).  Padded slots hold exact
    zeros and stay inert through two_prod."""
    p = ddm.two_prod(E.values, x[E.indices])
    y = ddm.dd_sum(p, axis=1)
    return y if E.apart is None else E.apart.dd_matvec(y, x)


def dd_matvec_dd(E: ELLMatrix, x: ddm.DD) -> ddm.DD:
    """A @ (x.hi + x.lo) in double-word (x a DD pair)."""
    return ddm.dd_add_w(dd_matvec(E, x.hi), matvec(E, x.lo))


def to_dense(E: ELLMatrix) -> torch.Tensor:
    """The dense (m, n_cols) matrix, repeated slots of a row summed.  The
    sum adds one slot column at a time, in slot order (no row repeats within
    a column), so it has one fixed order on every device, as JAX's
    sequential ``.at[].add`` on the CPU."""
    m, k = E.indices.shape
    out = torch.zeros((m, E.n_cols), dtype=E.values.dtype, device=E.values.device)
    rows = torch.arange(m, device=E.indices.device)
    for s in range(k):
        out[rows, E.indices[:, s]] += E.values[:, s]
    if E.apart is not None:
        out[E.apart.rows] = E.apart.A
    return out
