"""MPS data -> standard form:  min c'x  s.t.  Ax = b,  l <= x <= u.

Capability parity with standard-form.lisp:

- Slack/artificial-column insertion per row interval (standard-form.lisp:48-86):
  equality rows pass through; one-sided rows gain a slack in [0, inf) with
  coefficient -1 (>=) or +1 (<=); two-sided (range) rows gain a slack in
  [0, ub - lb].
- Objective negated for ``max`` problems (standard-form.lisp:95-99).
- Row equilibration ``rescale_sf`` scaling each row (and its RHS) by
  1 / max|a_ij| (standard-form.lisp:107-134), and the triplet-level variant
  ``scale_constraints`` (primal-dual-affine-scaling.lisp:50-73).

All arrays are NumPy float64 on the host; conversion to padded device
operands happens in :mod:`cholesky_is_magic_tpu_torch.ingest.device`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from cholesky_is_magic_tpu_torch.ingest.mps import MPSData, post_process_mps


@dataclasses.dataclass
class StandardForm:
    """min c'x s.t. Ax = b, l <= x <= u (standard-form.lisp:8-16).

    ``A`` is kept in COO triplet form (row, col, value arrays); duplicates
    are summed when materialized (matching CHOLMOD's triplet->CSC semantics
    used by the reference, sparse-cholesky.lisp:433-459).
    """

    nvars: int
    ncons: int
    c: np.ndarray  # (nvars,) dense objective
    a_rows: np.ndarray  # (nnz,) int32
    a_cols: np.ndarray  # (nnz,) int32
    a_vals: np.ndarray  # (nnz,) float64
    b: np.ndarray  # (ncons,)
    # Row type tags, mirroring sf-type (standard-form.lisp:14): 0 for
    # equality/range rows, +1 for '<=' rows, -1 for '>=' rows.  Used by the
    # ALM multiplier sign bounds (alm-approx.lisp:434-438).
    row_type: np.ndarray  # (ncons,) int8
    l: np.ndarray  # (nvars,)
    u: np.ndarray  # (nvars,)
    initial_vars: int  # number of original (non-slack) variables
    # +1 for min problems, -1 for max: c was multiplied by this in
    # to_standard_form, so the ORIGINAL objective is obj_sign * (c'x).
    obj_sign: float = 1.0

    ROW_EQ = 0
    ROW_LE = 1
    ROW_GE = -1

    def dense_A(self) -> np.ndarray:
        """Materialize A densely, summing duplicate triplets."""
        A = np.zeros((self.ncons, self.nvars))
        np.add.at(A, (self.a_rows, self.a_cols), self.a_vals)
        return A

    def dense_c(self) -> np.ndarray:
        return np.asarray(self.c, dtype=np.float64)


def to_standard_form(mps: MPSData) -> StandardForm:
    """Convert parsed MPS data to standard form (standard-form.lisp:18-105)."""
    post_process_mps(mps)

    rows = [t.row for t in mps.triplets]
    cols = [t.col for t in mps.triplets]
    vals = [t.value for t in mps.triplets]

    nvars = len(mps.col_data)
    l = [float(c.lb) for c in mps.col_data]
    u = [float(c.ub) for c in mps.col_data]
    b: list[float] = []
    row_type: list[int] = []

    def artificial_var(row: int, coef: float, lb: float = 0.0, ub: float = math.inf) -> None:
        # standard-form.lisp:48-59
        assert lb <= ub
        j = len(l)
        l.append(float(lb))
        u.append(float(ub))
        rows.append(row)
        cols.append(j)
        vals.append(float(coef))

    for i, row in enumerate(mps.row_data):
        lb, ub = row.lb, row.ub
        if lb == ub:
            row_type.append(StandardForm.ROW_EQ)
            b.append(lb)
        elif ub == math.inf:
            # ax >= b  ->  ax - s = b, s >= 0   (standard-form.lisp:67-72)
            b.append(lb)
            row_type.append(StandardForm.ROW_GE)
            artificial_var(i, -1.0)
        elif lb == -math.inf:
            # ax <= b  ->  ax + s = b, s >= 0   (standard-form.lisp:73-78)
            b.append(ub)
            row_type.append(StandardForm.ROW_LE)
            artificial_var(i, 1.0)
        else:
            # l <= ax <= u  ->  ax + s = u, 0 <= s <= u - l
            # (standard-form.lisp:79-86)
            b.append(ub)
            row_type.append(StandardForm.ROW_EQ)
            artificial_var(i, 1.0, 0.0, ub - lb)

    c = np.zeros(len(l))
    sign = 1.0 if (mps.sense or "min") == "min" else -1.0
    for j, v in mps.obj_row:
        # The reference stores (index . value) pairs and later *overwrites*
        # duplicates on densify (affine-scaling.lisp:82-85); we sum, which is
        # the standard MPS semantics and identical when entries are unique.
        c[j] += sign * v

    return StandardForm(
        nvars=len(l),
        ncons=len(b),
        c=c,
        a_rows=np.asarray(rows, dtype=np.int32),
        a_cols=np.asarray(cols, dtype=np.int32),
        a_vals=np.asarray(vals, dtype=np.float64),
        b=np.asarray(b, dtype=np.float64),
        row_type=np.asarray(row_type, dtype=np.int8),
        l=np.asarray(l, dtype=np.float64),
        u=np.asarray(u, dtype=np.float64),
        initial_vars=nvars,
        obj_sign=sign,
    )


def extract_solution(sf: StandardForm, x) -> dict:
    """Split a standard-form solution back into original variables and
    slacks.

    The reference keeps ``initial-vars`` on the struct for exactly this
    (standard-form.lisp:16,105): columns [0, initial_vars) are the MPS
    problem's variables, the rest are the slack/artificial columns added
    per row.  ``x`` may be longer than nvars (padded device output).
    """
    import numpy as _np

    x = _np.asarray(x)[: sf.nvars]
    # Report the ORIGINAL problem's objective: for OBJSENSE MAX problems c
    # was negated in to_standard_form (standard-form.lisp:95-99), so c'x is
    # the negated true objective; obj_sign undoes that.
    return {
        "x": x[: sf.initial_vars],
        "slacks": x[sf.initial_vars :],
        "objective": float(sf.obj_sign * (sf.dense_c() @ x)),
        "standard_form_objective": float(sf.dense_c() @ x),
    }


def rescale_sf(sf: StandardForm) -> StandardForm:
    """Row equilibration in place: scale row i (and b_i) by 1 / max_j |a_ij|.

    Rows whose max |a_ij| < 1e-6 are left unscaled (standard-form.lisp:107-134).
    Returns ``sf`` for chaining.
    """
    norm = np.zeros(sf.ncons)
    np.maximum.at(norm, sf.a_rows, np.abs(sf.a_vals))
    scale = np.where(norm < 1e-6, 1.0, 1.0 / np.where(norm == 0, 1.0, norm))
    sf.b = sf.b * scale
    sf.a_vals = sf.a_vals * scale[sf.a_rows]
    return sf


def scale_constraints(
    a_rows: np.ndarray, a_vals: np.ndarray, b: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Non-destructive row equilibration on triplets + RHS.

    Mirrors ``scale-constraints`` (primal-dual-affine-scaling.lisp:50-73):
    each row is scaled by 1 / max|a_ij| (1 if the max is below 1e-6).
    Returns (scaled_vals, scaled_b).
    """
    norm = np.zeros(len(b))
    np.maximum.at(norm, a_rows, np.abs(a_vals))
    scale = np.where(norm < 1e-6, 1.0, 1.0 / np.where(norm == 0, 1.0, norm))
    return a_vals * scale[a_rows], b * scale
