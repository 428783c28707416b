"""The port's crossover on the fully sparse operand set (ELL / block-ELL
products and the tile engine's B·Bᵀ factorization), held against the JAX
package's on the CPU.

- ``solve(..., sparse=True, block=8, crossover=True)`` in f64 through both
  front doors: the same certificate decisions, objectives within 1e-10;
- the port alone in f32 (pdas, pdas_dd, presolved): certified, within 2e-6
  of the HiGHS optimum;
- crossover straight from a Mehrotra phase-1 stop at m = 192, block 64
  (``tests/test_crossover_phase1.py``'s case): the port's crossover on its
  own engine from JAX's phase-1 result, beside JAX's crossover of it."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cholesky_is_magic_tpu as cim
import cholesky_is_magic_tpu_torch as cimt
from cholesky_is_magic_tpu.ingest.mps import read_mps_string as j_read
from cholesky_is_magic_tpu.ingest.standard_form import StandardForm
from cholesky_is_magic_tpu.utils.testing import (
    random_lp,
    scipy_reference_solution,
    write_mps,
)
from cholesky_is_magic_tpu_torch import convert
from cholesky_is_magic_tpu_torch.ingest.mps import read_mps_string as t_read
from cholesky_is_magic_tpu_torch.ingest.standard_form import (
    StandardForm as TStandardForm,
)

jxo = importlib.import_module("cholesky_is_magic_tpu.solvers.crossover")
txo = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.crossover")
jpdas = importlib.import_module("cholesky_is_magic_tpu.solvers.pdas")
tpdas = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas")

torch.set_num_threads(1)

SAME = ("certified", "factor_ok", "repairs", "widened", "n_basic", "n_lower",
        "n_upper")


def _lp13():
    ineq = random_lp(13, n_ub=12, n_eq=4, n=14)
    status, fun, _ = scipy_reference_solution(ineq)
    assert status == 0
    return write_mps(ineq), fun


@pytest.mark.parametrize("solver", ["pdas", "pdas_dd"])
def test_front_door_sparse_matches_jax(solver):
    text, fun = _lp13()
    kw = dict(sparse=True, block=8, crossover=True)
    rj = cim.solve(j_read(text), solver, dtype=jnp.float64, **kw)
    rt = cimt.solve(t_read(text), solver, dtype=torch.float64, device="cpu", **kw)
    jc, tc = rj.summary["crossover"], rt.summary["crossover"]
    for k in SAME:
        assert tc[k] == jc[k], k
    assert {k: type(v) for k, v in tc.items()} == {k: type(v) for k, v in jc.items()}
    assert tc["certified"] and rt.status == "optimal"
    assert rt.objective == pytest.approx(rj.objective, rel=1e-10)
    assert rt.objective == pytest.approx(fun, rel=1e-9)
    np.testing.assert_allclose(rt.solution["y"], rj.solution["y"], atol=1e-8)
    np.testing.assert_allclose(rt.solution["reduced_costs"],
                               rj.solution["reduced_costs"], atol=1e-8)


@pytest.mark.parametrize("solver,kw", [
    ("pdas", {}), ("pdas_dd", {}), ("pdas_dd", dict(presolve=True)),
])
def test_sparse_f32_certifies(solver, kw):
    text, fun = _lp13()
    rt = cimt.solve(t_read(text), solver, sparse=True, block=8, crossover=True,
                    dtype=torch.float32, device="cpu", **kw)
    cert = rt.summary["crossover"]
    assert cert["certified"], cert
    assert cert["gap"] < 1e-7 and rt.summary["gap"] == cert["gap"]
    assert rt.objective == pytest.approx(fun, rel=2e-6, abs=2e-6)
    assert rt.result.x.dtype == torch.float32
    if kw:
        assert rt.summary["presolve"] and rt.solution["x"].shape == (14,)


def test_sparse_needs_its_engine():
    text, _ = _lp13()
    sf = cimt.to_standard_form(t_read(text))
    st, _ = tpdas.make_pdas_sparse(sf, block=8, dtype=torch.float64, device="cpu")
    res = tpdas.pdas(st, tpdas.PDASConfig(max_iters=3), engine=_)
    with pytest.raises(ValueError, match="engine"):
        txo.crossover(res, st.lp)


def _staircase_sf(m, seed=0):
    """tests/test_crossover_phase1.py's staircase LP at (m, 2m) with its slack
    insertion, as a JAX StandardForm, and its HiGHS optimum."""
    import scipy.sparse as sp
    from scipy.optimize import linprog

    rng = np.random.default_rng(seed)
    n = 2 * m
    n_eq = m // 3
    n_ub = m - n_eq

    def staircase(rows):
        width = max(6, n // max(rows, 1) + 4)
        ri, ci, vi = [], [], []
        for i in range(rows):
            start = int(i * max(n - width, 1) / max(rows, 1))
            k = rng.integers(3, width)
            cols = np.clip(
                start + rng.choice(width, size=min(k, width), replace=False),
                0, n - 1,
            )
            ri += [i] * len(cols)
            ci += list(cols)
            vi += list(rng.normal(size=len(cols)))
        return sp.csr_matrix((vi, (ri, ci)), shape=(rows, n))

    l = np.where(rng.random(n) < 0.7, 0.0, -1.0 - rng.random(n))
    u = l + 1.0 + 4.0 * rng.random(n)
    x0 = l + (u - l) * (0.2 + 0.6 * rng.random(n))
    A_ub = staircase(n_ub)
    b_ub = A_ub @ x0 + 0.05 + rng.random(n_ub)
    A_eq = staircase(n_eq)
    b_eq = A_eq @ x0
    c = rng.normal(size=n)
    ref = linprog(c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq,
                  bounds=np.stack([l, u], axis=1), method="highs")
    assert ref.status == 0
    ub, eq = A_ub.tocoo(), A_eq.tocoo()
    sf = StandardForm(
        nvars=n + n_ub, ncons=n_ub + n_eq,
        c=np.concatenate([c, np.zeros(n_ub)]),
        a_rows=np.concatenate([ub.row, eq.row + n_ub, np.arange(n_ub)]).astype(np.int32),
        a_cols=np.concatenate([ub.col, eq.col, n + np.arange(n_ub)]).astype(np.int32),
        a_vals=np.concatenate([ub.data, eq.data, np.ones(n_ub)]),
        b=np.concatenate([b_ub, b_eq]),
        row_type=np.concatenate([np.full(n_ub, StandardForm.ROW_LE, np.int8),
                                 np.full(n_eq, StandardForm.ROW_EQ, np.int8)]),
        l=np.concatenate([l, np.zeros(n_ub)]),
        u=np.concatenate([u, np.full(n_ub, np.inf)]),
        initial_vars=n,
    )
    return sf, ref.fun


def test_phase1_crossover_matches_jax():
    """m = 192, block 64, f64: JAX's Mehrotra phase-1 stop, crossed over by
    both packages on their own engines."""
    sj, fun = _staircase_sf(192)
    st = TStandardForm(**dataclasses.asdict(sj))
    jst, jeng = jpdas.make_pdas_sparse(sj, block=64, dtype=jnp.float64)
    p1 = jpdas.pdas(jst, jpdas.PDASConfig(max_iters=100, refine_steps=1,
                                          mehrotra=True), engine=jeng)
    assert float(p1.extra["gap"]) < 1e-3  # a loose phase-1 stop
    jout = jxo.crossover(p1, jst.lp, engine=jeng)
    tst, teng = tpdas.make_pdas_sparse(st, block=64, dtype=torch.float64,
                                       device="cpu")
    tres = convert.solve_result_from_numpy(p1, device="cpu", dtype=torch.float64)
    tout = txo.crossover(tres, tst.lp, engine=teng)
    jc, tc = jout.extra["crossover"], tout.extra["crossover"]
    for k in ("certified", "repairs"):
        assert tc[k] == jc[k], (k, jc[k], tc[k])
    assert tc["certified"]
    assert tc["gap"] < 1e-10 and tc["primal_rel"] < 1e-8 and tc["dual_rel"] < 1e-8
    assert float(tout.objective) == pytest.approx(fun, rel=2e-6)
    assert float(tout.objective) == pytest.approx(float(jout.objective), rel=1e-10)
