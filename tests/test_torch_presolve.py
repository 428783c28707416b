"""The port's host presolve and its ``solve(..., presolve=True)`` wiring,
held against the JAX package.

- For every rule case of ``tests/test_presolve.py`` the port's ``presolve``
  gives JAX's status, detail and steps, the same reduced ``StandardForm``
  (bit-equal arrays), the same ``restore`` and ``restore_duals`` within
  1e-12 on numpy-seeded reduced iterates;
- ``solve(..., presolve=True)`` in f64 on the CPU agrees with JAX's: the
  objective, x, y and reduced costs within 1e-8, the summary's
  ``obj_offset`` shift, and the infeasible early report;
- ``"affine"`` with presolve reaches afiro's published optimum to 1e-6.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cholesky_is_magic_tpu as cim
import cholesky_is_magic_tpu_torch as cimt
from cholesky_is_magic_tpu.ingest.presolve import presolve as j_presolve
from cholesky_is_magic_tpu.ingest.standard_form import StandardForm as JSF
from cholesky_is_magic_tpu.utils.testing import random_lp, write_mps
from cholesky_is_magic_tpu_torch.ingest.presolve import presolve as t_presolve
from cholesky_is_magic_tpu_torch.ingest.standard_form import StandardForm as TSF

torch.set_num_threads(1)

AFIRO = os.path.join(os.path.dirname(__file__), "fixtures", "afiro.mps")
OPTIMUM = -464.75314285714285
INF = np.inf

# The LPs of tests/test_presolve.py, by the test that holds each: (A, b, c,
# l, u).
CASES = {
    "fixed_and_singleton_chain": (
        [[2.0, 0.0, 0.0], [1.0, 0.0, 0.0], [1.0, 1.0, 1.0]], [4.0, 2.0, 6.0],
        [1.0, 1.0, 1.0], [0.0, 0.0, 0.0], [10.0, 10.0, 10.0]),
    "singleton_infeasible": (
        [[1.0, 0.0]], [50.0], [0.0, 0.0], [0.0, 0.0], [1.0, 1.0]),
    "empty_row_infeasible": (
        [[0.0, 0.0]], [1.0], [0.0, 0.0], [0.0, 0.0], [1.0, 1.0]),
    "empty_column_to_bound": (
        [[1.0, 0.0]], [1.0], [0.0, -3.0], [0.0, -1.0], [2.0, 5.0]),
    "empty_column_unbounded": (
        [[1.0, 0.0]], [1.0], [0.0, -3.0], [0.0, -1.0], [2.0, INF]),
    "crossed_bounds_infeasible": ([[1.0]], [1.0], [1.0], [2.0], [1.0]),
    "lmax_forcing_pins_support": (
        [[1.0, 1.0, 1.0, 0.0], [1.0, 1.0, 0.0, 1.0], [0.0, 0.0, 1.0, 1.0]],
        [3.0, 2.5, 1.5], [1.0, -1.0, 2.0, 0.5], [0.0] * 4,
        [1.0, 1.0, 1.0, 10.0]),
    "lmin_forcing_with_mixed_signs": (
        [[1.0, -1.0, 1.0, 0.0], [1.0, 1.0, 0.0, 1.0], [0.0, 0.0, 1.0, 1.0]],
        [-2.0, 2.5, 0.5], [1.0, 1.0, 1.0, 0.2], [0.0] * 4,
        [1.0, 2.0, 1.0, 10.0]),
    "activity_bound_infeasible": (
        [[1.0, 1.0, 1.0]], [5.0], [1.0, 1.0, 1.0], [0.0] * 3, [1.0] * 3),
    "forcing_dual_postsolve": (
        [[1.0, 1.0, 0.0, 0.0], [1.0, 0.0, 1.0, 1.0], [0.0, 1.0, -1.0, 2.0]],
        [2.0, 2.5, 0.2], [-3.0, -1.0, 2.0, 0.5], [0.0] * 4,
        [1.0, 1.0, 10.0, 10.0]),
    "detects_infeasible_through_api": (
        [[1.0, 0.0], [0.0, 1.0]], [5.0, 0.5], [1.0, 1.0], [0.0, 0.0],
        [1.0, 1.0]),
    "free_column_singleton": (
        [[2.0, 1.0, 1.0, 0.0], [0.0, 1.0, 1.0, 1.0], [0.0, 1.0, -1.0, 0.0]],
        [4.0, 6.0, 0.5], [0.5, 1.0, 1.0, 1.0], [-INF, 0.0, 0.0, 0.0],
        [INF, 10.0, 10.0, 10.0]),
    "doubleton_substitution_with_bound_transfer": (
        [[2.0, 1.0, 0.0, 0.0], [0.0, 1.0, 1.0, 1.0], [0.0, 0.0, 1.0, -1.0]],
        [8.0, 7.0, 1.0], [1.0, 1.0, 1.0, 0.3], [1.0, 0.0, 0.0, 0.0],
        [3.0, 10.0, 10.0, 10.0]),
    "doubleton_infeasible_transfer": (
        [[1.0, 1.0, 0.0], [0.0, 1.0, 1.0]], [10.0, 1.0], [0.0] * 3, [0.0] * 3,
        [1.0, 2.0, 1.0]),
    "dual_postsolve_matches_highs": (
        [[2.0, 1.0, 1.0, 0.0, 0.0], [0.0, 1.0, 1.0, 1.0, 0.0],
         [0.0, 1.0, -1.0, 0.0, 2.0], [0.0, 0.0, 1.0, 0.0, 1.0]],
        [4.0, 6.0, 0.5, 3.0], [0.5, 1.0, 1.0, 1.0, 0.2],
        [-INF, 0.0, 0.0, 0.0, 0.0], [INF, 10.0, 10.0, 10.0, 10.0]),
    "dual_postsolve_binding_transferred_bound": (
        [[1.0, 1.0, 0.0, 0.0], [1.0, 0.0, 1.0, 1.0], [0.0, 0.0, 1.0, -1.0]],
        [3.0, 6.0, 1.0], [-1.0, 0.0, 0.0, 0.1], [0.0] * 4,
        [10.0, 1.0, 10.0, 10.0]),
    "fixpoint_chain_free_then_doubleton": (
        [[1.0, 1.0, 1.0, 0.0], [0.0, 2.0, 0.0, 1.0], [0.0, 1.0, 1.0, 0.0]],
        [5.0, 8.0, 3.0], [0.0, 1.0, 2.0, 0.5], [-INF, 0.0, 0.0, 0.0],
        [INF, 4.0, 4.0, 8.0]),
}


def _kw(A, b, c, l, u):
    A = np.asarray(A, np.float64)
    m, n = A.shape
    r, k = np.nonzero(A)
    return dict(nvars=n, ncons=m, c=np.asarray(c, np.float64),
                a_rows=r.astype(np.int32), a_cols=k.astype(np.int32),
                a_vals=A[r, k], b=np.asarray(b, np.float64),
                row_type=np.zeros(m, np.int8), l=np.asarray(l, np.float64),
                u=np.asarray(u, np.float64), initial_vars=n)


def _fixed_random_kw():
    """TestEndToEnd's LP: random_lp(3) in standard form with five columns
    fixed outright."""
    from cholesky_is_magic_tpu.ingest.mps import read_mps_string

    rng = np.random.default_rng(11)
    ineq = random_lp(3, n_ub=20, n_eq=6, n=40, density=0.3)
    sf = cim.to_standard_form(read_mps_string(write_mps(ineq)))
    sf.u[5:10] = sf.l[5:10] = np.round(rng.random(5), 3)
    return {f: getattr(sf, f) for f in (
        "nvars", "ncons", "c", "a_rows", "a_cols", "a_vals", "b", "row_type",
        "l", "u", "initial_vars")}


def _pair(name):
    """The same StandardForm for each package, from independent copies."""
    kw = _fixed_random_kw() if name == "fixed_random" else _kw(*CASES[name])
    copy = lambda: {k: (v.copy() if isinstance(v, np.ndarray) else v)  # noqa: E731
                    for k, v in kw.items()}
    return JSF(**copy()), TSF(**copy())


SF_FIELDS = ("nvars", "ncons", "c", "a_rows", "a_cols", "a_vals", "b",
             "row_type", "l", "u", "initial_vars", "obj_sign")


@pytest.mark.parametrize("name", sorted(CASES) + ["fixed_random"])
def test_presolve_matches_jax(name):
    jsf, tsf = _pair(name)
    jred, jinfo = j_presolve(jsf)
    tred, tinfo = t_presolve(tsf)
    assert isinstance(tred, TSF)
    assert (tinfo.status, tinfo.detail) == (jinfo.status, jinfo.detail)
    assert len(tinfo.steps) == len(jinfo.steps)
    for ts, js in zip(tinfo.steps, jinfo.steps):
        assert len(ts) == len(js)
        for a, b in zip(ts, js):
            np.testing.assert_array_equal(a, b)
    assert tinfo.report() == jinfo.report()
    assert tinfo.obj_offset == jinfo.obj_offset
    for f in ("kept_cols", "kept_rows", "fixed_vals"):
        np.testing.assert_array_equal(getattr(tinfo, f), getattr(jinfo, f))
    for f in SF_FIELDS:
        np.testing.assert_array_equal(getattr(tred, f), getattr(jred, f))
    if jinfo.status in ("infeasible", "unbounded"):
        return
    rng = np.random.default_rng(len(name))
    x_red = None if jinfo.status == "solved" else rng.normal(size=jred.nvars)
    x_full = jinfo.restore(x_red)
    np.testing.assert_array_equal(tinfo.restore(x_red), x_full)
    y = rng.normal(size=jred.ncons)
    rc = rng.normal(size=jred.nvars)
    for xf in (None, x_full):
        jy, jrc = jinfo.restore_duals(jsf, y, rc, x_full=xf)
        ty, trc = tinfo.restore_duals(tsf, y, rc, x_full=xf)
        for a, b in ((jy, ty), (jrc, trc)):
            assert np.array_equal(np.isnan(a), np.isnan(b))
            a, b = np.nan_to_num(a), np.nan_to_num(b)
            assert np.max(np.abs(a - b), initial=0.0) <= 1e-12 * max(
                1.0, np.max(np.abs(a), initial=0.0))


SOLVE = dict(presolve=True, pad_multiple=8, max_iters=300, refine_steps=2)


@pytest.mark.parametrize("name", [
    "forcing_dual_postsolve", "dual_postsolve_matches_highs",
    "dual_postsolve_binding_transferred_bound", "fixed_random",
])
def test_solve_with_presolve_matches_jax(name):
    jsf, tsf = _pair(name)
    rj = cim.solve(jsf, "pdas_dd", dtype=jnp.float64, **SOLVE)
    rt = cimt.solve(tsf, "pdas_dd", dtype=torch.float64, device="cpu", **SOLVE)
    assert rt.status == rj.status
    assert rt.summary["presolve"] == rj.summary["presolve"]
    assert set(rt.summary) == set(rj.summary)
    assert rt.summary["iterations"] == rj.summary["iterations"]
    assert rt.summary["phase1_iterations"] == rj.summary["phase1_iterations"]
    assert rt.objective == pytest.approx(rj.objective, rel=1e-8, abs=1e-8)
    # The reduced solve's objective shifted by obj_offset into the full
    # space, where the restored solution's objective lives.
    for key in ("objective", "dual_objective"):
        assert rt.summary[key] == pytest.approx(rj.summary[key], rel=1e-8,
                                                abs=1e-8)
    assert rt.summary["objective"] == pytest.approx(
        rt.solution["standard_form_objective"], abs=1e-8)
    for key in ("x", "slacks", "y", "reduced_costs"):
        np.testing.assert_allclose(rt.solution[key], rj.solution[key],
                                   rtol=1e-8, atol=1e-8)
    assert rt.summary["gap_bound"] == pytest.approx(rj.summary["gap_bound"],
                                                    rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("name,solver", [
    ("detects_infeasible_through_api", "pdas"),
    ("activity_bound_infeasible", "affine"),
    ("empty_column_unbounded", "pdas_dd"),
    ("fixpoint_chain_free_then_doubleton", "pdas"),
])
def test_presolve_early_reports_match_jax(name, solver):
    """Presolve decides these alone: infeasible, unbounded, or solved
    outright, with no solver run."""
    jsf, tsf = _pair(name)
    rj = cim.solve(jsf, solver, presolve=True)
    rt = cimt.solve(tsf, solver, presolve=True, device="cpu")
    assert rt.status == rj.status and rt.result is None is rj.result
    assert rt.summary.keys() == rj.summary.keys()
    for k, v in rj.summary.items():
        if isinstance(v, float):
            assert rt.summary[k] == pytest.approx(v, rel=1e-12)
        else:
            assert rt.summary[k] == v
    assert rt.solution.keys() == rj.solution.keys()
    for k, v in rj.solution.items():
        np.testing.assert_allclose(rt.solution[k], v, rtol=1e-12)


@pytest.mark.parametrize("solver,sparse", [
    ("affine", False), ("affine", True), ("pdas", False),
])
def test_afiro_with_presolve(solver, sparse):
    """Every ported solver family takes ``presolve=True`` (affine dense and
    sparse, pdas); afiro comes back in the original space at its optimum."""
    kw = dict(presolve=True, pad_multiple=16, block=16, sparse=sparse,
              max_iters=600)
    rj = cim.solve(AFIRO, solver, dtype=jnp.float64, **kw)
    rt = cimt.solve(AFIRO, solver, dtype=torch.float64, device="cpu", **kw)
    assert rt.status == rj.status == "optimal"
    assert rt.summary["presolve"] == rj.summary["presolve"]
    assert rt.solution["x"].shape == rj.solution["x"].shape
    assert rt.objective == pytest.approx(rj.objective, rel=1e-6)
    rel = 1e-6 if solver == "affine" else 1e-4  # pdas stops at its 1e-4 gap
    assert rt.objective == pytest.approx(OPTIMUM, rel=rel)
    assert ("y" in rt.solution) == (solver != "affine")
