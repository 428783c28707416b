"""The Adams–Johnson LP relaxation of a quadratic assignment problem of
size ``n`` (Netlib's QAP8, QAP12 and QAP15 at n = 8, 12, 15; Resende,
Ramakrishnan & Drezner, Operations Research 43(5), 1995), with lanes whose
optimum is known by construction.

The constraint matrix is the published one.  Variables:

- x_ij for i, j < n: column ``i * n + j``;
- y_ijkl for i < k and j != l, in lexicographic order of (i, j, k, l):
  columns n² onwards.  y_ijkl with i > k stands for y_klij.

Rows (every one an equality):

- rows 0 .. n-1: Σ_j x_ij = 1, row i;
- rows n .. 2n-1: Σ_i x_ij = 1, row n + j;
- n²(n-1) rows Σ_{l≠j} y_ijkl − x_ij = 0, one for each (i, j) and k ≠ i:
  row 2n + (i n + j)(n-1) + (k if k < i else k-1);
- n²(n-1) rows Σ_{k≠i} y_ijkl − x_ij = 0, one for each (i, j) and l ≠ j:
  row 2n + n²(n-1) + (i n + j)(n-1) + (l if l < j else l-1).

So y_ijkl (i < k) has +1 in four rows, (i, j, k) and (k, l, i) of the
first family and (i, j, l) and (k, l, j) of the second, and x_ij has +1
in its two assignment rows and −1 in its 2(n-1) linking rows: 2n²(n-1)
+ 2n rows, n² + n²(n-1)²/2 columns and 2n³(n-1) + 2n² nonzeros (6330,
22275 and 94950 at n = 15, the Netlib readme's QAP15 row less its
objective row).  An m-column identity block of slacks follows, as in the
other configurations (:mod:`lpbench.gen.constructed_optimum`).

Each lane's b, c and boxes are constructed as there, so that its optimum
is unique and exact (the published LP, with right-hand sides 1 and 0 and
Nugent's costs, is degenerate):

1. the basis: structural columns taken greedily (in an order the
   ``matrix_seed`` draws), a column entering with one of its rows that no
   column taken before touches as its pivot and only if none of its rows
   is an earlier pivot; slacks fill the other rows.  The pivot rows and
   the structural basics then form a ±1 diagonal block, and the basis is
   block-triangular with an identity block, so nonsingular;
2. l, u drawn from the ``matrix_seed``: l = 0 or −1 − U(0, 1), u = l + 1 +
   4 U(0, 1), and the basic columns' boxes at least 1 wide around 0;
3. per lane k (from the seed sequence (matrix_seed, lane_seed, k)): x*
   nonbasic at a bound (the upper one with probability 0.4), basic a
   quarter of its box or more inside each bound; b = A x*; y* ~ N(0, 1),
   reduced costs zero on the basis and signed by the active bound with
   |rc| >= 0.1 elsewhere; c = Aᵀ y* + rc.

Strict complementarity and the nonsingular basis make (x*, y*, z*, w*)
each lane's unique optimum.  Lanes keep A, l, u and the basis; lane k is
the same whatever the number of lanes, and a run's seed orders them
(:func:`make`).

Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from lpbench.gen.constructed_optimum import Fleet, _csr_matvec

PER_LANE = ("b", "c", "x", "y", "z", "w", "objective")


def counts(n: int) -> tuple[int, int, int]:
    """(rows, structural columns, structural nonzeros) of the relaxation of
    size ``n``."""
    return 2 * n * n * (n - 1) + 2 * n, n * n + n * n * (n - 1) ** 2 // 2, \
        2 * n**3 * (n - 1) + 2 * n * n


def structure(n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """(rows, cols, vals, m, n_struct) of the structural columns, the COO
    triplets in column order (see the module docstring)."""
    n1 = n - 1
    m, n_struct, _ = counts(n)
    second = 2 * n + n * n * n1

    def link(family, i, j, other, own):
        """The linking row of (i, j) in ``family`` (0: over k, 1: over l)
        for ``other`` (k or l), which differs from ``own`` (i or j)."""
        return (2 * n + family * n * n * n1 + (i * n + j) * n1
                + np.where(other < own, other, other - 1))

    # x_ij: its two assignment rows (+1) and its 2(n-1) linking rows (-1).
    i, j = np.divmod(np.arange(n * n), n)
    others = np.arange(n1)
    x_rows = np.concatenate([i[:, None], (n + j)[:, None],
                             2 * n + (i * n + j)[:, None] * n1 + others[None, :],
                             second + (i * n + j)[:, None] * n1 + others[None, :]], axis=1)
    x_vals = np.concatenate([np.ones((n * n, 2)), -np.ones((n * n, 2 * n1))], axis=1)
    # y_ijkl, i < k, j != l, lexicographic.
    ii, jj, kk, ll = (a.ravel() for a in np.meshgrid(*(np.arange(n),) * 4, indexing="ij"))
    keep = (ii < kk) & (jj != ll)
    ii, jj, kk, ll = ii[keep], jj[keep], kk[keep], ll[keep]
    y_rows = np.stack([link(0, ii, jj, kk, ii), link(1, ii, jj, ll, jj),
                       link(0, kk, ll, ii, kk), link(1, kk, ll, jj, ll)], axis=1)
    rows = np.concatenate([x_rows.ravel(), y_rows.ravel()]).astype(np.int64)
    cols = np.concatenate([np.repeat(np.arange(n * n), 2 * n),
                           n * n + np.repeat(np.arange(len(ii)), 4)]).astype(np.int64)
    vals = np.concatenate([x_vals.ravel(), np.ones(y_rows.size)])
    assert len(ii) + n * n == n_struct
    return rows, cols, vals, m, n_struct


def greedy_basis(rows, cols, m: int, n_struct: int, order) -> np.ndarray:
    """The basis of the module docstring's step 1: for each row its basic
    column, a structural column taken in ``order`` or the row's slack
    (n_struct + row)."""
    csc = np.argsort(cols, kind="stable")
    starts = np.searchsorted(cols[csc], np.arange(n_struct + 1))
    touched = np.zeros(m, bool)
    pivot = np.zeros(m, bool)
    basic = n_struct + np.arange(m)
    for j in order:
        support = rows[csc[starts[j]:starts[j + 1]]]
        if pivot[support].any():
            continue
        fresh = support[~touched[support]]
        if len(fresh) == 0:
            continue
        r = fresh[0]
        pivot[r] = True
        touched[support] = True
        basic[r] = j
    return basic


def base(n: int, matrix_seed: int) -> dict:
    """What the lanes share: the structure with its slack block, the basis
    and the boxes."""
    rows, cols, vals, m, n_struct = structure(n)
    rng = np.random.default_rng(matrix_seed)
    basic = greedy_basis(rows, cols, m, n_struct, rng.permutation(n_struct))
    rows = np.concatenate([rows, np.arange(m)])
    cols = np.concatenate([cols, n_struct + np.arange(m)])
    vals = np.concatenate([vals, np.ones(m)])
    nn = n_struct + m
    l = np.where(rng.random(nn) < 0.7, 0.0, -1.0 - rng.random(nn))
    u = l + 1.0 + 4.0 * rng.random(nn)
    l[basic] = -0.5 - rng.random(m)
    u[basic] = 0.5 + rng.random(m)
    return dict(m=m, n=nn, n_struct=n_struct, rows=rows, cols=cols, vals=vals,
                basic=basic, l=l, u=u)


def lane(shared: dict, matrix_seed: int, lane_seed: int, k: int) -> dict:
    """Lane ``k``'s b, c and exact optimum, from the seed sequence
    (matrix_seed, lane_seed, k)."""
    m, nn, basic = shared["m"], shared["n"], shared["basic"]
    l, u = shared["l"], shared["u"]
    rng = np.random.default_rng([matrix_seed, lane_seed, k])
    nonbasic = np.ones(nn, bool)
    nonbasic[basic] = False
    at_upper = nonbasic & (rng.random(nn) < 0.4)
    x = np.where(at_upper, u, l)
    x[basic] = l[basic] + (u[basic] - l[basic]) * (0.25 + 0.5 * rng.random(m))
    y = rng.standard_normal(m)
    rc = np.where(at_upper, -(0.1 + rng.random(nn)), 0.1 + rng.random(nn))
    rc[basic] = 0.0
    rows, cols, vals = shared["rows"], shared["cols"], shared["vals"]
    b = _csr_matvec(rows, cols, vals, m, x)
    c = _csr_matvec(cols, rows, vals, nn, y) + rc
    return dict(b=b, c=c, x=x, y=y, z=np.maximum(rc, 0.0), w=np.maximum(-rc, 0.0),
                objective=float(c @ x))


def fleet(n: int, matrix_seed: int, lane_seed: int, lanes: int) -> Fleet:
    """``lanes`` LPs of one A, l, u and basis (lane k from (matrix_seed,
    lane_seed, k))."""
    shared = base(n, matrix_seed)
    per = [lane(shared, matrix_seed, lane_seed, k) for k in range(lanes)]
    return Fleet(**shared, **{key: np.asarray([p[key] for p in per]) for key in PER_LANE})


def make(config: dict, seed: int, lanes: int) -> Fleet:
    """The fleet a configuration file describes (``n``, ``matrix_seed``,
    ``lane_seed``; ``m`` and ``n_struct``, where given, must be the
    relaxation's), its lanes in the order the run's ``seed`` draws."""
    m, n_struct, _ = counts(config["n"])
    if config.get("m", m) != m or config.get("n_struct", n_struct) != n_struct:
        raise ValueError(f"qap_relaxation: n = {config['n']} gives {m} rows and {n_struct}"
                         f" structural columns, not {config.get('m')} and"
                         f" {config.get('n_struct')}")
    f = fleet(config["n"], config["matrix_seed"], config["lane_seed"], lanes)
    order = np.random.default_rng(seed).permutation(lanes)
    return dataclasses.replace(f, **{k: getattr(f, k)[order] for k in PER_LANE})
