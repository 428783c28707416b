"""The QAP relaxation's generator: the published counts at every size, the
Netlib readme's rows and columns, a nonsingular basis, each lane's exact
optimum, and lanes that do not depend on how many there are."""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as sla

from lpbench.gen import qap_relaxation as qap

SEED = 2**31 + 22  # seeds run past 2**31


@pytest.mark.parametrize("n", range(4, 16))
def test_counts_follow_the_formula(n):
    rows, cols, vals, m, n_struct = qap.structure(n)
    assert (m, n_struct, len(vals)) == (2 * n * n * (n - 1) + 2 * n,
                                         n * n + n * n * (n - 1) ** 2 // 2,
                                         2 * n**3 * (n - 1) + 2 * n * n)
    A = sp.csc_matrix((vals, (rows, cols)), shape=(m, n_struct))
    assert A.nnz == len(vals)  # no entry twice
    per_col = np.diff(A.indptr)
    assert np.all(per_col[:n * n] == 2 * n) and np.all(per_col[n * n:] == 4)
    assert np.all(np.diff(A.tocsr().indptr) == n)  # every row: n entries
    # x_ij: +1 in its two assignment rows, -1 in its linking rows; y: +1.
    assert A[:2 * n, :n * n].sum() == 2 * n * n and A[2 * n:, :n * n].sum() == -2 * n * n * (n - 1)
    assert np.all(A[:, n * n:].data == 1.0)


@pytest.mark.parametrize("n,m,n_struct", [(8, 912, 1632), (12, 3192, 8856), (15, 6330, 22275)])
def test_the_netlib_readmes_rows_and_columns(n, m, n_struct):
    # The readme counts the objective row too: 913, 3193, 6331.
    assert qap.counts(n)[:2] == (m, n_struct)
    if n == 15:
        assert qap.counts(n)[2] == 94950


@pytest.mark.parametrize("n", [4, 6, 8, 15])
def test_the_basis_is_nonsingular_and_holds_structural_columns(n):
    sh = qap.base(n, 0)
    assert sorted(sh["basic"]) == sorted(set(sh["basic"].tolist()))
    A = sp.csc_matrix((sh["vals"], (sh["rows"], sh["cols"])), shape=(sh["m"], sh["n"]))
    B = A[:, sh["basic"]].tocsc()
    lu = sla.splu(B)
    assert np.all(np.abs(lu.U.diagonal()) > 0.5)  # ±1 pivots
    assert 0.2 < np.mean(sh["basic"] < sh["n_struct"]) < 0.5
    if n <= 6:
        assert np.linalg.cond(B.toarray()) < 100


@pytest.mark.parametrize("n", [4, 6])
def test_every_lanes_optimum_has_zero_kkt_residuals(n):
    f = qap.fleet(n, 0, SEED, lanes=3)
    A = sp.csr_matrix((f.vals, (f.rows, f.cols)), shape=(f.m, f.n))
    for k in range(f.lanes):
        x, y, z, w = f.x[k], f.y[k], f.z[k], f.w[k]
        primal = np.abs(A @ x - f.b[k]).max() / (1 + np.abs(f.b[k]).max())
        dual = np.abs(A.T @ y + z - w - f.c[k]).max() / (1 + np.abs(f.c[k]).max())
        assert primal <= 1e-12 and dual <= 1e-12
        assert np.all(f.l <= x) and np.all(x <= f.u) and np.all(z >= 0) and np.all(w >= 0)
        assert np.all((z == 0) | (x == f.l)) and np.all((w == 0) | (x == f.u))
        off = np.ones(f.n, bool)
        off[f.basic] = False
        assert np.all(np.maximum(z, w)[off] >= 0.1)
        box = (f.u - f.l)[f.basic]
        inner = np.minimum(x - f.l, f.u - x)[f.basic]
        assert np.all(inner >= 0.25 * box - 1e-12) and np.all(box >= 1.0)
        assert f.objective[k] == pytest.approx(f.c[k] @ x, rel=1e-15)


def test_lane_0_is_the_same_for_any_lanes_and_a_seed_orders_them():
    one, four = qap.fleet(4, 0, 1, lanes=1), qap.fleet(4, 0, 1, lanes=4)
    for key in qap.PER_LANE:
        np.testing.assert_array_equal(getattr(one, key)[0], getattr(four, key)[0])
    for key in ("rows", "cols", "vals", "l", "u", "basic"):
        np.testing.assert_array_equal(getattr(one, key), getattr(four, key))
    assert not np.array_equal(four.b[1], four.b[0])
    cfg = dict(n=4, matrix_seed=0, lane_seed=1)
    a, b = qap.make(cfg, SEED, 4), qap.make(cfg, SEED + 1, 4)
    assert sorted(map(tuple, a.b)) == sorted(map(tuple, four.b)) == sorted(map(tuple, b.b))
    np.testing.assert_array_equal(qap.make(cfg, SEED, 1).b, one.b)  # one lane: lane 0
    with pytest.raises(ValueError):
        qap.make(dict(cfg, m=105), SEED, 1)
