"""LandS, the two-stage stochastic LP of Louveaux & Smeers (1988), as the
deterministic equivalent of a sample of N scenarios (sample average
approximation), sized as Linderoth, Shapiro & Wright (Annals of OR 142,
2006, Table 1) list it: a first stage of 2 rows and 4 columns, a second
stage of 7 rows and 12 columns a scenario, 3 random right-hand sides.
Every replication has this A; only b (the demands) differs.

The constraint matrix is the published structure:

- x_i, i < 4, the capacities: columns 0 .. 3;
- y_ij^s, i < 4 the technology, j < 3 the demand mode: column
  4 + 12 s + 3 i + j;
- row 0: x_0 + x_1 + x_2 + x_3 (the minimum total capacity);
- row 1: 10 x_0 + 7 x_1 + 16 x_2 + 6 x_3 (the budget);
- per scenario s, rows 2 + 7 s + i (i < 4): Σ_j y_ij^s − x_i (capacity),
  rows 2 + 7 s + 4 + j (j < 3): Σ_i y_ij^s (demand).

So 2 + 7N rows, 4 + 12N structural columns and 8 + 28N nonzeros; each x_i
has N + 2 entries (a dense column), every y two.  An m-column identity
block of slacks follows, as in the other configurations
(:mod:`lpbench.gen.constructed_optimum`).

Each lane's b, c and boxes are constructed as in
:mod:`lpbench.gen.qap_relaxation`, so that its optimum is unique and exact
(the published demands and operating costs are not used):

1. the basis, taken greedily: the first-stage columns first, then the
   second-stage ones in an order the ``matrix_seed`` draws; a column enters
   with its last row that no column taken before touches as its pivot, and
   only if none of its rows is an earlier pivot; slacks fill the other
   rows.  The pivot rows and the structural basics form a ±1 diagonal
   block and the basis is block-triangular with an identity block, so
   nonsingular.  The four capacities are basic (pivots in the last
   scenario's capacity rows), as at LandS's own optimum, where every
   technology is built: their scalings grow as the iterates converge;
2. the boxes, and each lane's x*, y* and reduced costs, drawn as
   :mod:`lpbench.gen.qap_relaxation` draws them; b = A x* and c = Aᵀ y* +
   rc summed by ``np.bincount`` over the triplets, since the exact-order
   loop there takes a pass per entry of the longest row, 5002 passes for
   the capacities' columns.

Lanes keep A, l, u and the basis; lane k is the same whatever the number
of lanes, and a run's seed orders them (:func:`make`).

Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from lpbench.gen.constructed_optimum import Fleet
from lpbench.gen.qap_relaxation import PER_LANE

FIRST_ROWS, FIRST_COLS = 2, 4  # first stage
ROWS, COLS = 7, 12  # second stage, a scenario
BUDGET = (10.0, 7.0, 16.0, 6.0)  # row 1's coefficients


def counts(scenarios: int) -> tuple[int, int, int]:
    """(rows, structural columns, structural nonzeros) of the deterministic
    equivalent over ``scenarios`` scenarios."""
    return (FIRST_ROWS + ROWS * scenarios, FIRST_COLS + COLS * scenarios,
            2 * FIRST_COLS + 28 * scenarios)


def structure(scenarios: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """(rows, cols, vals, m, n_struct) of the structural columns, the COO
    triplets in column order (see the module docstring)."""
    N = scenarios
    m, n_struct, _ = counts(N)
    s = np.arange(N)
    cap = FIRST_ROWS + ROWS * s  # (N,) each scenario's first capacity row
    # x_i: rows 0 and 1, then its capacity row of every scenario (-1).
    x_rows = [np.concatenate([[0, 1], cap + i]) for i in range(FIRST_COLS)]
    x_vals = [np.concatenate([[1.0, BUDGET[i]], -np.ones(N)]) for i in range(FIRST_COLS)]
    # y_ij^s: its capacity row (s, i) and its demand row (s, j), both +1.
    i, j = np.divmod(np.arange(COLS), 3)
    y_rows = np.stack([cap[:, None] + i[None, :], cap[:, None] + 4 + j[None, :]], axis=-1)
    rows = np.concatenate(x_rows + [y_rows.ravel()]).astype(np.int64)
    cols = np.concatenate([np.full(N + 2, c) for c in range(FIRST_COLS)]
                          + [np.repeat(FIRST_COLS + np.arange(COLS * N), 2)]).astype(np.int64)
    vals = np.concatenate(x_vals + [np.ones(2 * COLS * N)])
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
        support = np.sort(rows[csc[starts[j]:starts[j + 1]]])
        if pivot[support].any():
            continue
        fresh = support[~touched[support]]
        if len(fresh) == 0:
            continue
        r = fresh[-1]
        pivot[r] = True
        touched[support] = True
        basic[r] = j
    return basic


def base(scenarios: int, matrix_seed: int) -> dict:
    """What the lanes share: the structure with its slack block, the basis
    and the boxes (drawn as :func:`lpbench.gen.qap_relaxation.base` draws
    them)."""
    rows, cols, vals, m, n_struct = structure(scenarios)
    rng = np.random.default_rng(matrix_seed)
    order = np.concatenate([np.arange(FIRST_COLS),
                            FIRST_COLS + rng.permutation(n_struct - FIRST_COLS)])
    basic = greedy_basis(rows, cols, m, n_struct, order)
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
    (matrix_seed, lane_seed, k), drawn as ``qap_relaxation.lane`` draws
    them; b and c summed by ``np.bincount`` over the triplets."""
    m, nn, basic = shared["m"], shared["n"], shared["basic"]
    l, u = shared["l"], shared["u"]
    rows, cols, vals = shared["rows"], shared["cols"], shared["vals"]
    rng = np.random.default_rng([matrix_seed, lane_seed, k])
    nonbasic = np.ones(nn, bool)
    nonbasic[basic] = False
    at_upper = nonbasic & (rng.random(nn) < 0.4)
    x = np.where(at_upper, u, l)
    x[basic] = l[basic] + (u[basic] - l[basic]) * (0.25 + 0.5 * rng.random(m))
    y = rng.standard_normal(m)
    rc = np.where(at_upper, -(0.1 + rng.random(nn)), 0.1 + rng.random(nn))
    rc[basic] = 0.0
    b = np.bincount(rows, vals * x[cols], minlength=m)
    c = np.bincount(cols, vals * y[rows], minlength=nn) + rc
    return dict(b=b, c=c, x=x, y=y, z=np.maximum(rc, 0.0), w=np.maximum(-rc, 0.0),
                objective=float(c @ x))


def fleet(scenarios: int, matrix_seed: int, lane_seed: int, lanes: int) -> Fleet:
    """``lanes`` LPs of one A, l, u and basis (lane k from (matrix_seed,
    lane_seed, k))."""
    shared = base(scenarios, matrix_seed)
    per = [lane(shared, matrix_seed, lane_seed, k) for k in range(lanes)]
    return Fleet(**shared, **{key: np.asarray([p[key] for p in per]) for key in PER_LANE})


def make(config: dict, seed: int, lanes: int) -> Fleet:
    """The fleet a configuration file describes (``scenarios``,
    ``matrix_seed``, ``lane_seed``; ``m`` and ``n_struct``, where given,
    must be the deterministic equivalent's), its lanes in the order the
    run's ``seed`` draws."""
    m, n_struct, _ = counts(config["scenarios"])
    if config.get("m", m) != m or config.get("n_struct", n_struct) != n_struct:
        raise ValueError(f"lands_saa: {config['scenarios']} scenarios give {m} rows and"
                         f" {n_struct} structural columns, not {config.get('m')} and"
                         f" {config.get('n_struct')}")
    f = fleet(config["scenarios"], config["matrix_seed"], config["lane_seed"], lanes)
    order = np.random.default_rng(seed).permutation(lanes)
    return dataclasses.replace(f, **{k: getattr(f, k)[order] for k in PER_LANE})
