"""Frozen NumPy copy of the staircase LP with an optimum known by
construction, extended to fleets of lanes that share A, l and u.

The construction is the one of ``constructed_optimum_lp`` in the port's
``utils/testing.py`` (itself a copy of the JAX package's), copied here so
that no later change to the program moves the benchmark's inputs:

1. basis column i has its bottom-most nonzero in row i with a dominant
   pivot, so the basis is nonsingular and well conditioned;
2. the other structural columns are staircase columns (about 6 nonzeros),
   followed by an identity block of m columns;
3. x*: nonbasic at a finite bound, basic strictly inside (l, u); b = A x*;
4. y* ~ N(0, 1); reduced costs zero on the basis and signed by the active
   bound with |rc| >= 0.1 elsewhere; c = Aᵀ y* + rc.

Strict complementarity and the nonsingular basis make (x*, y*, z*, w*)
the unique optimum.  A fleet's matrix is fixed by a ``matrix_seed``: lane
0 is that seed's instance unchanged, and every other lane keeps A, l, u
and the basis and draws its own bound sides, basic values, y* and reduced
costs from a ``lane_seed``, so its optimum is known exactly too.

A configuration fixes both seeds, and a run's seed puts that one set of
lanes in an order of its own (:func:`make`): how many iterations the
slowest lane of a batch takes depends on the lanes, so lanes drawn from
the run's seed would change the work from run to run.

Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Fleet:
    """Lanes of one constraint matrix: ``rows``, ``cols``, ``vals`` (the
    COO triplets of A, m x n, every row an equality), ``l``, ``u`` shared;
    per lane (axis 0) ``b``, ``c`` and the optimum ``x``, ``y``, ``z``,
    ``w`` (z = max(rc, 0), w = max(-rc, 0)) and ``objective`` = c'x*."""

    m: int
    n: int
    n_struct: int
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    l: np.ndarray
    u: np.ndarray
    basic: np.ndarray
    b: np.ndarray
    c: np.ndarray
    x: np.ndarray
    y: np.ndarray
    z: np.ndarray
    w: np.ndarray
    objective: np.ndarray

    @property
    def lanes(self) -> int:
        return self.b.shape[0]

    def matvec(self, v: np.ndarray) -> np.ndarray:
        """A @ v for v of shape (n,) or (k, n), in float64."""
        v = np.atleast_2d(v)
        out = np.zeros((v.shape[0], self.m))
        for k in range(v.shape[0]):
            out[k] = np.bincount(self.rows, self.vals * v[k][self.cols],
                                 minlength=self.m)
        return out

    def rmatvec(self, v: np.ndarray) -> np.ndarray:
        """Aᵀ @ v for v of shape (m,) or (k, m), in float64."""
        v = np.atleast_2d(v)
        out = np.zeros((v.shape[0], self.n))
        for k in range(v.shape[0]):
            out[k] = np.bincount(self.cols, self.vals * v[k][self.rows],
                                 minlength=self.n)
        return out


def base_instance(m: int, n_struct: int, seed: int, width: int = 8) -> dict:
    """The constructed-optimum staircase LP, draw for draw as the port's
    ``constructed_optimum_lp`` makes it (``name`` gives (m, n_struct) from
    its NETLIB_SCALES; ``m=`` alone means n_struct = 2m)."""
    rng = np.random.default_rng(seed)
    n = n_struct + m

    rows, cols, vals = [], [], []
    basis_col_of_row = np.full(m, -1, np.int64)
    stride = max(1, n_struct // m)
    for j in range(n_struct):
        center = int(j * max(m - 1, 1) / max(n_struct - 1, 1))
        is_basis = (j % stride == 0) and basis_col_of_row[center] < 0
        if is_basis:
            bottom = center
            k = int(rng.integers(1, min(width, bottom + 1) + 1))
            above = bottom - 1 - rng.choice(
                min(width, max(bottom, 1)), size=max(k - 1, 0), replace=False
            )
            above = above[above >= 0]
            rows.append(bottom)
            cols.append(j)
            vals.append(float(rng.choice([-1, 1]) * (2.0 + 2.0 * rng.random())))
            for r in above:
                rows.append(int(r))
                cols.append(j)
                vals.append(float(0.3 * rng.standard_normal()))
            basis_col_of_row[bottom] = j
        else:
            k = int(rng.integers(3, width))
            rr = np.clip(center + rng.choice(2 * width, size=k, replace=False)
                         - width, 0, m - 1)
            for r in np.unique(rr):
                rows.append(int(r))
                cols.append(j)
                vals.append(float(rng.standard_normal()))
    for i in range(m):
        rows.append(i)
        cols.append(n_struct + i)
        vals.append(1.0)
    basic = np.where(basis_col_of_row >= 0, basis_col_of_row,
                     n_struct + np.arange(m))

    l = np.where(rng.random(n) < 0.7, 0.0, -1.0 - rng.random(n))
    u = l + 1.0 + 4.0 * rng.random(n)
    at_upper = rng.random(n) < 0.4
    x = np.where(at_upper, u, l)
    xb = rng.standard_normal(m)
    x[basic] = xb
    l[basic] = xb - 0.5 - rng.random(m)
    u[basic] = xb + 0.5 + rng.random(m)

    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float64)
    # b = A x and c = Aᵀ y + rc as scipy's CSR products sum them (in row
    # and column order), so the arrays equal the port's bit for bit.
    b = _csr_matvec(rows, cols, vals, m, x)
    y = rng.standard_normal(m)
    rc = np.where(at_upper, -(0.1 + rng.random(n)), 0.1 + rng.random(n))
    rc[basic] = 0.0
    c = _csr_matvec(cols, rows, vals, n, y) + rc
    return dict(m=m, n=n, n_struct=n_struct, rows=rows, cols=cols, vals=vals,
                l=l, u=u, basic=basic, b=b, c=c, x=x, y=y,
                z=np.maximum(rc, 0.0), w=np.maximum(-rc, 0.0),
                objective=float(c @ x))


def _csr_matvec(rows, cols, vals, nrows, v):
    """Σ_j a_ij v_j per row, each row's terms in ascending column order and
    added left to right, as scipy's CSR product adds them."""
    order = np.lexsort((cols, rows))
    r, t = rows[order], vals[order] * v[cols[order]]
    out = np.zeros(nrows)
    starts = np.searchsorted(r, np.arange(nrows))
    ends = np.searchsorted(r, np.arange(nrows), side="right")
    longest = int((ends - starts).max()) if nrows else 0
    for step in range(longest):  # column position within each row
        idx = starts + step
        live = idx < ends
        out[live] = out[live] + t[idx[live]]
    return out


def fleet(m: int, n_struct: int, matrix_seed: int, lane_seed: int, lanes: int,
          width: int = 8) -> Fleet:
    """``lanes`` LPs of one A, l, u and basis: lane 0 the base instance of
    ``matrix_seed``, lane k >= 1 drawn from the seed sequence
    (matrix_seed, lane_seed, k)."""
    base = base_instance(m, n_struct, matrix_seed, width)
    n, basic = base["n"], base["basic"]
    nonbasic = np.ones(n, bool)
    nonbasic[basic] = False
    l, u = base["l"], base["u"]
    per = {k: [base[k]] for k in ("b", "c", "x", "y", "z", "w", "objective")}
    for k in range(1, lanes):
        rng = np.random.default_rng([matrix_seed, lane_seed, k])
        at_upper = nonbasic & (rng.random(n) < 0.4)
        x = np.where(at_upper, u, l)
        # Basic values at least a quarter of the box inside each bound (the
        # boxes of basic columns are at least 1 wide).
        x[basic] = l[basic] + (u[basic] - l[basic]) * (0.25 + 0.5 * rng.random(len(basic)))
        y = rng.standard_normal(m)
        rc = np.where(at_upper, -(0.1 + rng.random(n)), 0.1 + rng.random(n))
        rc[basic] = 0.0
        b = _csr_matvec(base["rows"], base["cols"], base["vals"], m, x)
        c = _csr_matvec(base["cols"], base["rows"], base["vals"], n, y) + rc
        for key, v in (("b", b), ("c", c), ("x", x), ("y", y),
                       ("z", np.maximum(rc, 0.0)), ("w", np.maximum(-rc, 0.0)),
                       ("objective", float(c @ x))):
            per[key].append(v)
    return Fleet(m=m, n=n, n_struct=n_struct, rows=base["rows"], cols=base["cols"],
                 vals=base["vals"], l=l, u=u, basic=basic,
                 **{k: np.asarray(v) for k, v in per.items()})


PER_LANE = ("b", "c", "x", "y", "z", "w", "objective")


def make(config: dict, seed: int, lanes: int) -> Fleet:
    """The fleet a configuration file describes (``m``, ``n_struct``,
    ``width``, ``matrix_seed``, ``lane_seed``), its lanes in the order the
    run's ``seed`` draws."""
    f = fleet(config["m"], config["n_struct"], config["matrix_seed"], config["lane_seed"],
              lanes, config.get("width", 8))
    order = np.random.default_rng(seed).permutation(lanes)
    return dataclasses.replace(f, **{k: getattr(f, k)[order] for k in PER_LANE})
