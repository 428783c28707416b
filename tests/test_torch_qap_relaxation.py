"""The tile engine on the QAP relaxation, whose normal matrix fills in,
held against the plain float64 normal equations of
``lpbench/normal_plain.py`` on the CPU.

The relaxation's A (``lpbench/gen/qap_relaxation.py``) at n = 5 and 6
(210 and 372 rows, plus the slack block), blocks 16 and 32, with seeded
positive column scalings d and row boosts: the engine's factor in its
padded slot order against the plain N in the same order, its raw solve
and its refined solve against the plain solve.  Then a 4-lane n = 5 fleet
through ``batched_pdas(engine=)`` on the configuration's settings to each
lane's exact optimum.  Tolerances are each written with their reason.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cholesky_is_magic_tpu_torch.ingest.standard_form import scale_constraints
from cholesky_is_magic_tpu_torch.ops import sparse_ops
from cholesky_is_magic_tpu_torch.sparse.tiled import engine_for_sparse
from lpbench.gen import qap_relaxation as qap
from lpbench import normal_plain as plain

SEED = 2**31 + 22


def _engine(n, block, dtype):
    f = qap.fleet(n, 0, 1, lanes=1)
    vals, _ = scale_constraints(f.rows.astype(np.int32), f.vals, f.b[0])
    A = sp.csc_matrix((vals, (f.rows, f.cols)), shape=(f.m, f.n))
    return f, vals, engine_for_sparse(A, block=block, dtype=dtype, device="cpu")


def _dense_factor(eng, L):
    """The engine's compact tiles as one dense lower factor in slot order."""
    b = eng.b
    out = torch.zeros((eng.B * b, eng.B * b), dtype=L.dtype)
    for t, (i, j) in enumerate(eng.tiles):
        out[i * b:(i + 1) * b, j * b:(j + 1) * b] = L[t]
    return torch.tril(out)


@pytest.mark.parametrize("dtype,factor_tol,solve_tol", [
    # A Cholesky factor and its triangular solves are backward stable: the
    # factor's error ‖L Lᵀ − N‖ / ‖N‖ reads about 2u here (u the unit
    # roundoff), a solve's residual error under u.  Each tolerance gives
    # about ten times what was read (f64 2.3e-16 and 9e-18 against u =
    # 1.1e-16; f32 6.3e-8 and 4.4e-9 against u = 6e-8), and the forward
    # error is held to cond(N) times the solve's.
    (torch.float64, 1e-14, 1e-16),
    (torch.float32, 1e-6, 5e-8),
], ids=["f64", "f32"])
@pytest.mark.parametrize("n,block", [(5, 16), (5, 32), (6, 16), (6, 32)])
def test_engine_factor_and_solves_match_the_plain_normal_equations(n, block, dtype,
                                                                   factor_tol, solve_tol):
    f, vals, eng = _engine(n, block, dtype)
    rng = np.random.default_rng([SEED, n, block])
    d = np.exp(rng.uniform(-1.5, 1.5, f.n))
    boost = 1e-6 * rng.random(f.m)
    g = rng.standard_normal(f.m)
    assert sum(eng._n_syrk) > 0  # the factor fills in: Schur updates run

    dt = dict(dtype=dtype, device="cpu")
    d_t, boost_t, g_t = (torch.as_tensor(v, **dt) for v in (d, boost, g))
    tiles = eng.assemble_pairs(d_t, boost_t)
    L, invd, ok = eng.factorize(tiles)
    assert bool(ok)
    # The program is handed d and the boost in its dtype: the reference
    # takes those same values, widened.
    N_slot = plain.normal_matrix(f.rows, f.cols, vals, f.m, d_t.double().numpy(),
                                 boost_t.double().numpy(), perm=eng.pperm.numpy())
    assert plain.backward_error(N_slot, _dense_factor(eng, L)) <= factor_tol

    N = plain.normal_matrix(f.rows, f.cols, vals, f.m, d_t.double().numpy(),
                            boost_t.double().numpy())
    want = plain.solve(plain.factor(N), g_t.double())
    cond = float(torch.linalg.cond(N))
    E = sparse_ops.from_coo(f.rows, f.cols, vals, (f.m, f.n), **dt)
    ET = sparse_ops.from_coo(f.cols, f.rows, vals, (f.n, f.m), **dt)
    for steps in (0, 2):
        y, ok = eng.solve_normal_ell(E, ET, d_t, g_t, row_boost=boost_t, refine_steps=steps)
        assert bool(ok)
        assert plain.residual_error(N, y, g_t) <= solve_tol
        err = float(torch.linalg.norm(y.double() - want) / torch.linalg.norm(want))
        assert err <= cond * solve_tol, (steps, err, cond)


def test_the_reference_equals_a_dense_product():
    """The pair-wise formation is A·D²·Aᵀ + diag(boost), and the permuted
    form is that matrix with unit rows appended, reordered."""
    f = qap.fleet(4, 0, 1, lanes=1)
    A = np.zeros((f.m, f.n))
    np.add.at(A, (f.rows, f.cols), f.vals)
    rng = np.random.default_rng(SEED)
    d, boost = rng.random(f.n) + 0.5, rng.random(f.m)
    want = A @ np.diag(d**2) @ A.T + np.diag(boost)
    N = plain.normal_matrix(f.rows, f.cols, f.vals, f.m, d, boost).numpy()
    np.testing.assert_allclose(N, want, rtol=1e-14, atol=1e-13)
    perm = rng.permutation(f.m + 5)
    ext = np.eye(f.m + 5)
    ext[:f.m, :f.m] = want
    Np = plain.normal_matrix(f.rows, f.cols, f.vals, f.m, d, boost, perm=perm).numpy()
    np.testing.assert_allclose(Np, ext[perm][:, perm], rtol=1e-14, atol=1e-13)
    L = plain.factor(torch.as_tensor(want))
    g = rng.standard_normal(f.m)
    np.testing.assert_allclose(plain.solve(L, g).numpy(), np.linalg.solve(want, g),
                               rtol=1e-9)


def test_a_fleet_reaches_each_lanes_exact_optimum():
    """Four lanes of n = 5 on one engine, float64, the configuration's pdas
    settings with a tight gap: every lane optimal, at its own optimum."""
    from lpbench.drive import Driver
    from lpbench.reference import check

    config = {"generator": "qap_relaxation", "n": 5, "matrix_seed": 0, "lane_seed": 1,
              "dtype": "float64",
              "phases": {"phase1": {"solver": "pdas", "config": {
                  "max_iters": 200, "refine_steps": 2, "mehrotra": True,
                  "gap_tol": 1e-10}}}}
    traffic = {"entry": "sparse_fleet", "block": 16, "lanes": 4, "phases": ["phase1"]}
    drv = Driver(config, traffic, SEED, "cpu")
    drv.setup()
    call = drv.call()
    drv.to_host(call)
    assert drv.stopped(call) == 4
    got = check.worst(drv.fleet, drv.path, [drv.iterates(call)], "float64")
    # A 1e-10 gap in float64 puts x, y and the objective within about the
    # gap of the unique optimum (read: 1.3e-11, 1.0e-11, 4.9e-12; the
    # residuals 1.6e-13 and 3.2e-16): the limits leave about a hundred times.
    assert got["primal_res"] <= 1e-11 and got["dual_res"] <= 1e-13
    assert got["obj_err"] <= 1e-9 and got["x_err"] <= 1e-9 and got["y_err"] <= 1e-9
