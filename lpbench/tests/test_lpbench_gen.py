"""The frozen generator: lane 0 is the port's instance, every lane's optimum
satisfies the KKT conditions, and the lanes share A, l and u."""

import numpy as np
import pytest

from lpbench.gen import base_instance, fleet
from lpbench.gen.constructed_optimum import PER_LANE, make

SEED = 2**31 + 11  # seeds run past 2**31


@pytest.mark.parametrize("m,n_struct,name", [(27, 51, "afiro"), (64, 128, None),
                                             (96, 192, None)])
def test_lane0_equals_the_ports_instance(m, n_struct, name):
    from cholesky_is_magic_tpu_torch.utils.testing import constructed_optimum_lp

    sf, info = (constructed_optimum_lp(name, seed=SEED) if name
                else constructed_optimum_lp(m=m, seed=SEED))
    f = fleet(m, n_struct, SEED, 7, lanes=3)  # the matrix seed makes lane 0
    assert (f.m, f.n) == (sf.ncons, sf.nvars)
    for got, want in ((f.rows, sf.a_rows), (f.cols, sf.a_cols), (f.vals, sf.a_vals),
                      (f.b[0], sf.b), (f.c[0], sf.c), (f.l, sf.l), (f.u, sf.u),
                      (f.x[0], info["x"]), (f.y[0], info["y"]), (f.z[0], info["z"]),
                      (f.w[0], info["w"]), (f.basic, info["basic"])):
        np.testing.assert_array_equal(got, want)
    assert f.objective[0] == info["objective"]


def _dense(f):
    A = np.zeros((f.m, f.n))
    np.add.at(A, (f.rows, f.cols), f.vals)
    return A


@pytest.mark.parametrize("m,n_struct", [(27, 51), (64, 128), (200, 500)])
def test_every_lane_satisfies_kkt(m, n_struct):
    f = fleet(m, n_struct, 0, SEED, lanes=5)
    A = _dense(f)
    eps = np.finfo(np.float64).eps
    for k in range(f.lanes):
        x, y, z, w = f.x[k], f.y[k], f.z[k], f.w[k]
        scale = np.abs(A) @ np.abs(x) + np.abs(f.b[k])
        assert np.all(np.abs(A @ x - f.b[k]) <= 16 * eps * scale)
        dual = A.T @ y + z - w - f.c[k]
        assert np.all(np.abs(dual) <= 16 * eps * (np.abs(A.T) @ np.abs(y) + np.abs(f.c[k]) + 1))
        assert np.all(f.l <= x) and np.all(x <= f.u)
        assert np.all(z >= 0) and np.all(w >= 0)
        # Complementarity: a dual is nonzero only at its active bound, and
        # strictly (|rc| >= 0.1 off the basis, basic values inside).
        assert np.all((z == 0) | (x == f.l)) and np.all((w == 0) | (x == f.u))
        off = np.ones(f.n, bool)
        off[f.basic] = False
        assert np.all(np.maximum(z, w)[off] >= 0.1)
        inner = np.minimum(x - f.l, f.u - x)[f.basic]
        assert np.all(inner >= 0.25 - 1e-12)
        assert f.objective[k] == pytest.approx(f.c[k] @ x, rel=1e-15)


def test_lanes_share_a_l_u_and_differ_in_b_c():
    f = fleet(64, 128, 0, SEED, lanes=4)
    g = fleet(64, 128, 0, SEED, lanes=2)
    # A, l, u are one set of arrays for the fleet, and the same whatever
    # the lane count; each lane is its own draw.
    np.testing.assert_array_equal(f.vals, g.vals)
    np.testing.assert_array_equal(f.l, g.l)
    np.testing.assert_array_equal(f.u, g.u)
    np.testing.assert_array_equal(f.b[:2], g.b)
    np.testing.assert_array_equal(f.c[:2], g.c)
    assert f.b.shape == (4, 64) and f.c.shape == (4, f.n)
    for k in range(1, 4):
        assert not np.array_equal(f.b[k], f.b[0])
        assert not np.array_equal(f.c[k], f.c[0])


def test_the_lane_seed_decides_the_lanes_and_the_matrix_seed_the_matrix():
    a, b, c = (fleet(32, 64, 5, s, lanes=3) for s in (SEED, SEED, SEED + 1))
    np.testing.assert_array_equal(a.b, b.b)
    np.testing.assert_array_equal(a.c, b.c)
    # Another run seed: the same A, l, u and lane 0, other lanes.
    for key in ("rows", "cols", "vals", "l", "u", "basic"):
        np.testing.assert_array_equal(getattr(a, key), getattr(c, key))
    np.testing.assert_array_equal(a.b[0], c.b[0])
    assert not np.array_equal(a.b[1:], c.b[1:]) and not np.array_equal(a.c[1:], c.c[1:])
    # Another matrix seed: another A.
    d = fleet(32, 64, 6, SEED, lanes=3)
    assert not np.array_equal(a.vals, d.vals)


def test_base_instance_matches_lane0():
    f = fleet(40, 80, SEED, 3, lanes=2)
    base = base_instance(40, 80, SEED)
    np.testing.assert_array_equal(base["b"], f.b[0])
    np.testing.assert_array_equal(base["x"], f.x[0])


def test_a_runs_seed_orders_one_set_of_lanes():
    cfg = dict(m=40, n_struct=80, width=6, matrix_seed=3, lane_seed=4)
    ref = fleet(40, 80, 3, 4, lanes=6, width=6)
    a, b, c = (make(cfg, s, 6) for s in (SEED, SEED, SEED + 1))
    for key in ("rows", "cols", "vals", "l", "u", "basic"):
        np.testing.assert_array_equal(getattr(a, key), getattr(ref, key))
    np.testing.assert_array_equal(a.b, b.b)  # the same seed, the same order
    assert not np.array_equal(a.b, c.b)  # another seed, another order ...
    for f in (a, c):  # ... of the same lanes
        order = [int(np.flatnonzero((ref.b == f.b[k]).all(axis=1))[0]) for k in range(6)]
        assert sorted(order) == list(range(6))
        for key in PER_LANE:
            np.testing.assert_array_equal(getattr(f, key), getattr(ref, key)[order])
