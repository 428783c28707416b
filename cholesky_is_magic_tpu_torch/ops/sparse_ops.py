"""Padded-ELL sparse matrix products: the cholmod_sdmult replacement.

Counterpart of ``cholesky_is_magic_tpu/ops/sparse_ops.py``.  A is stored in
ELL layout — every row padded to the same slot count — so the product is
one gather, one elementwise multiply and one row reduction:

    y_i = sum_k  values[i, k] * x[indices[i, k]]

and the transposed product is a scatter-add over the same slots
(``index_add_``, which sums duplicate indices).  Padded slots carry index 0
and value 0: masking by value, not by index, keeps the gather branch-free.
Indices are int64, as torch indexing takes them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cholesky_is_magic_tpu_torch.ops import dd as ddm


@dataclasses.dataclass(frozen=True)
class ELLMatrix:
    """Row-padded sparse matrix (ELLPACK layout) with its logical column
    count."""

    indices: torch.Tensor  # (m, k) int64, 0 on padded slots
    values: torch.Tensor  # (m, k), 0.0 on padded slots
    n_cols: int

    @property
    def shape(self):
        return (self.indices.shape[0], self.n_cols)


def from_coo(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: tuple[int, int],
    dtype=torch.float32,
    min_slots: int = 1,
    device="cuda",
) -> ELLMatrix:
    """Build an ELLMatrix from COO triplets on the host (duplicates summed,
    the CHOLMOD triplet->CSC semantics, sparse-cholesky.lisp:433-459)."""
    import scipy.sparse as sp

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
    )


def from_dense(A: np.ndarray, dtype=torch.float32, device="cuda") -> ELLMatrix:
    rows, cols = np.nonzero(A)
    return from_coo(rows, cols, np.asarray(A)[rows, cols], A.shape,
                    dtype=dtype, device=device)


def matvec(E: ELLMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x: gather + row reduction (sparse-m*, no transpose)."""
    return torch.sum(E.values * x[E.indices], dim=1)


def rmatvec(E: ELLMatrix, y: torch.Tensor) -> torch.Tensor:
    """z = Aᵀ @ y: scatter-add over the slots (sparse-m* :transpose t)."""
    contrib = E.values * y[:, None]
    out = torch.zeros(E.n_cols, dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, E.indices.reshape(-1), contrib.reshape(-1))


def scale_columns(E: ELLMatrix, d: torch.Tensor) -> ELLMatrix:
    """A · diag(d): the scale-sparse! analogue (sparse-cholesky.lisp:461-477),
    the per-column scale gathered into each slot."""
    return dataclasses.replace(E, values=E.values * d[E.indices])


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


def dd_matvec(E: ELLMatrix, x: torch.Tensor) -> ddm.DD:
    """A @ x in double-word: error-free slot products + compensated row
    reduction (the ELL twin of ops.dd.dd_matvec).  Padded slots hold exact
    zeros and stay inert through two_prod."""
    p = ddm.two_prod(E.values, x[E.indices])
    return ddm.dd_sum(p, axis=1)


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
    return out
