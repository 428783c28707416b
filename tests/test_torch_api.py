"""The port's front door, held against the JAX package.

``solve(afiro, "pdas_dd")`` in f64 agrees with the JAX package's within
1e-8 relative and reaches the published optimum; ``solve(afiro, "pdas")``
takes the same iterations; ``crossover=True`` gives the JAX package's
certificate (the same keys, Python types, ``certified`` and ``repairs``) and
polished duals, also after the presolve; the matrix-free family (alm, aalm,
selfdual) gives the JAX package's summary keys and types, and in f64 its
outer and inner counts, also after the presolve; and the combinations the
JAX package refuses raise its ValueError."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cholesky_is_magic_tpu as cim
import cholesky_is_magic_tpu_torch as cimt
from cholesky_is_magic_tpu_torch.ops import dd_cuda

torch.set_num_threads(1)

AFIRO = os.path.join(os.path.dirname(__file__), "fixtures", "afiro.mps")
SIMPLE = os.path.join(os.path.dirname(__file__), "fixtures", "simple.mps")
OPTIMUM = -464.75314285714285


def test_solve_pdas_dd_matches_jax_and_the_published_optimum():
    kw = dict(pad_multiple=16)
    rj = cim.solve(AFIRO, "pdas_dd", dtype=jnp.float64, **kw)
    before = dict(dd_cuda.LAUNCHES)
    rt = cimt.solve(AFIRO, "pdas_dd", dtype=torch.float64, device="cpu", **kw)
    assert dd_cuda.LAUNCHES == before  # CPU tensors take the plain path
    assert rt.status == rj.status == "optimal"
    for key in ("objective", "dual_objective"):
        assert rt.summary[key] == pytest.approx(rj.summary[key], rel=1e-8)
    for key in ("iterations", "phase1_iterations"):
        assert rt.summary[key] == rj.summary[key]
    assert rt.summary["gap"] < 1e-9
    assert rt.objective == pytest.approx(OPTIMUM, rel=1e-8)
    assert rt.summary["gap_bound"] == pytest.approx(rj.summary["gap_bound"],
                                                    rel=1e-3)
    np.testing.assert_allclose(rt.solution["x"], rj.solution["x"], atol=1e-6)
    np.testing.assert_allclose(rt.solution["y"], rj.solution["y"], atol=1e-6)
    # Warm restart: phase 1 is skipped.
    rw = cimt.solve(AFIRO, "pdas_dd", dtype=torch.float64, warm=rt,
                     device="cpu", **kw)
    assert rw.summary["phase1_iterations"] == 0
    assert rw.objective == pytest.approx(OPTIMUM, rel=1e-8)


def test_solve_pdas_matches_jax():
    kw = dict(pad_multiple=16)
    rj = cim.solve(AFIRO, "pdas", dtype=jnp.float64, **kw)
    rt = cimt.solve(AFIRO, "pdas", dtype=torch.float64, device="cpu", **kw)
    assert rt.status == rj.status == "optimal"
    assert rt.summary["iterations"] == rj.summary["iterations"]
    assert rt.objective == pytest.approx(rj.objective, rel=1e-8)
    assert rt.summary["gap_bound"] >= abs(rt.objective - OPTIMUM) / (1 + abs(OPTIMUM))


@pytest.mark.parametrize("solver,kw", [("pdas", {}), ("pdas_dd", {}),
                                       ("pdas_dd", dict(presolve=True))])
def test_solve_crossover_matches_jax(solver, kw):
    kw = dict(kw, pad_multiple=16, crossover=True)
    rj = cim.solve(AFIRO, solver, dtype=jnp.float64, **kw)
    rt = cimt.solve(AFIRO, solver, dtype=torch.float64, device="cpu", **kw)
    jc, tc = rj.summary["crossover"], rt.summary["crossover"]
    assert {k: type(v) for k, v in tc.items()} == {k: type(v) for k, v in jc.items()}
    assert tc["certified"] == jc["certified"] is True
    assert tc["repairs"] == jc["repairs"]
    assert tc["gap"] < 1e-9 and rt.summary["gap"] == tc["gap"]
    assert rt.objective == pytest.approx(OPTIMUM, rel=1e-9)
    for key in ("y", "reduced_costs"):
        np.testing.assert_allclose(rt.solution[key], rj.solution[key], atol=1e-8)
    assert rt.summary["gap_bound"] == pytest.approx(rj.summary["gap_bound"],
                                                    rel=1e-3, abs=1e-12)


@pytest.mark.parametrize("kw", [dict(solver="alm"), dict(solver="aalm"),
                                dict(solver="selfdual")])
def test_unported_front_door_options_raise(kw):
    """No family of the front door is unported any more: the three that
    raised NotImplementedError take, as in the JAX package, a ValueError
    for an option they do not take (crossover), and a family name that
    neither package knows raises ValueError in both."""
    from cholesky_is_magic_tpu import api as japi
    from cholesky_is_magic_tpu_torch import api as tapi

    solver = kw.pop("solver", "pdas_dd")
    for api, extra in ((japi, {}), (tapi, dict(device="cpu"))):
        with pytest.raises(ValueError):
            api.solve(AFIRO, solver, crossover=True, **extra)
        with pytest.raises(ValueError, match="unknown solver"):
            api.solve(AFIRO, solver + "_v2", **extra)


_DT = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}


@pytest.mark.parametrize("problem,solver,kw", [
    (SIMPLE, "alm", dict(pad_multiple=16, max_iters=300, dtype="f64")),
    (SIMPLE, "alm", dict(pad_multiple=16, max_iters=300, dtype="f32")),
    (SIMPLE, "aalm", dict(max_iters=60, dtype="f64")),
    (SIMPLE, "selfdual", dict(dtype="f64")),
    (SIMPLE, "alm", dict(pad_multiple=16, max_iters=300, presolve=True, dtype="f64")),
    (AFIRO, "alm", dict(pad_multiple=16, max_iters=60, dtype="f64")),
], ids=["alm-f64", "alm-f32", "aalm-f64", "selfdual-f64", "alm-presolve-f64",
        "afiro-alm-f64"])
def test_matrix_free_family_matches_jax(problem, solver, kw):
    """The summary's keys and types are the JAX package's; in f64 the
    counts are JAX's (simple: alm 5 / 77, aalm 25 / 370, selfdual 119,
    presolved alm 4 / 63; afiro: alm 9 / 1768) and the values within 1e-8
    relative (the final projected gradient within 1e-4: a difference of
    O(1) gradient terms).  In f32 (the aalm and selfdual runs take 2.15 M
    and 1 M inner iterations in JAX, too many for an eager CPU loop) alm is
    held to the JAX tests' bar, -7 within 1e-2."""
    jd, td = _DT[kw.pop("dtype")]
    rj = cim.solve(problem, solver, dtype=jd, **kw)
    before = dict(dd_cuda.LAUNCHES)
    rt = cimt.solve(problem, solver, dtype=td, device="cpu", **kw)
    assert dd_cuda.LAUNCHES == before
    assert {k: type(v) for k, v in rt.summary.items()} == {
        k: type(v) for k, v in rj.summary.items()}
    assert rt.status == rj.status == "optimal"
    ref = OPTIMUM if problem == AFIRO else -7.0
    key = "objective" if solver == "selfdual" else "value"
    if jd == jnp.float32:
        assert rt.summary[key] == pytest.approx(ref, abs=1e-2)
        return
    counts = (("iterations",) if solver == "selfdual"
              else ("outer_iterations", "inner_iterations"))
    for k in counts:
        assert rt.summary[k] == rj.summary[k]
    for k in (key, "violation") if solver != "selfdual" else (key,):
        assert rt.summary[k] == pytest.approx(rj.summary[k], rel=1e-8, abs=1e-14)
    assert rt.summary["pg"] == pytest.approx(rj.summary["pg"], rel=1e-4)
    assert rt.objective == pytest.approx(rj.objective, rel=1e-8)
    np.testing.assert_allclose(rt.solution["x"], rj.solution["x"], atol=1e-6)
    assert rt.summary[key] == pytest.approx(ref, abs=2e-3 if problem == AFIRO else 1e-4)
    if kw.get("presolve"):
        assert rt.summary["presolve"] == rj.summary["presolve"]


def _report(api):
    return api.SolveReport(solver="pdas", status="optimal", objective=0.0,
                           summary={}, result=None, sf=None, solution={})


@pytest.mark.parametrize("solver,kw", [
    ("alm", dict(sparse=True)),
    ("affine", dict(warm=True)),
    ("pdas", dict(warm=True, presolve=True)),
    ("affine", dict(crossover=True)),
    ("aalm", dict(sparse=True)),
    ("selfdual", dict(sparse=True)),
    ("alm", dict(warm=True)),
    ("selfdual", dict(warm=True)),
    ("aalm", dict(crossover=True)),
])
def test_invalid_front_door_combinations_raise_as_in_jax(solver, kw):
    """The JAX package's ValueErrors: sparse=True off affine/pdas/pdas_dd,
    warm off pdas/pdas_dd, warm with presolve, crossover off pdas/pdas_dd."""
    from cholesky_is_magic_tpu import api as japi
    from cholesky_is_magic_tpu_torch import api as tapi

    for api, extra in ((japi, {}), (tapi, dict(device="cpu"))):
        args = dict(kw, **extra)
        if args.get("warm"):
            args["warm"] = _report(api)
        with pytest.raises(ValueError):
            api.solve(AFIRO, solver, **args)
