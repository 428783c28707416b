"""The port's crossover (solvers/crossover.py) on dense operands, held
against the JAX package's on the CPU.

Both packages start from the same entry: a JAX pdas result (or a crafted
one) carried to the port by ``convert.solve_result_from_numpy``, on the
operand set carried by ``convert.device_lp_from_numpy``.  The basis
classification and the OMP completion are bit-equal; one polish pass fed
JAX's partition agrees within 1e-9 in f64 and 1e-6 in f32; the free-running
repair loop takes the same decisions (certified, repairs, widened, n_basic,
n_lower, n_upper) on every fixture, and the entry repair reports the same
infeasibility before and after.  JAX's compiles dominate the cost, so each
entry is built once per module."""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cholesky_is_magic_tpu as cim
from cholesky_is_magic_tpu.ingest import to_device_lp
from cholesky_is_magic_tpu.ingest.mps import read_mps_string
from cholesky_is_magic_tpu.solvers.result import SolveResult, Status
from cholesky_is_magic_tpu.utils.testing import (
    constructed_optimum_lp,
    random_lp,
    scipy_reference_solution,
    write_mps,
)
from cholesky_is_magic_tpu_torch import convert
from cholesky_is_magic_tpu_torch import sparse as tsparse

# The crossover modules (their packages re-export a function of the name).
jxo = importlib.import_module("cholesky_is_magic_tpu.solvers.crossover")
txo = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.crossover")
jpdas = importlib.import_module("cholesky_is_magic_tpu.solvers.pdas")

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}
SAME = ("certified", "factor_ok", "repairs", "widened", "n_basic", "n_lower",
        "n_upper")


def _t(v, dtype=None):
    return convert.tensor_from_numpy(np.asarray(v), device="cpu", dtype=dtype)


def _port(lp, res, tdt):
    return (convert.device_lp_from_numpy(lp, device="cpu", dtype=tdt),
            convert.solve_result_from_numpy(res, device="cpu", dtype=tdt))


def _jax_crossover(res, lp, **kw):
    """JAX's crossover, with the inputs and outputs of every polish pass
    recorded (its _polish_jit wrapped for the call)."""
    calls = []
    orig = jxo._polish_jit

    def recorded(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls.append(([np.asarray(a) for a in args[1:7]], out))
        return out

    jxo._polish_jit = recorded
    try:
        return jxo.crossover(res, lp, **kw), calls
    finally:
        jxo._polish_jit = orig


@functools.lru_cache(maxsize=None)
def _random_entry(seed, dt):
    """random_lp(seed) at pad 32, its HiGHS optimum, the JAX pdas iterate
    stopped at the 1e-4 gap, and JAX's crossover of it."""
    ineq = random_lp(seed, n_ub=10, n_eq=3, n=12)
    status, fun, _ = scipy_reference_solution(ineq)
    assert status == 0
    sf = cim.to_standard_form(read_mps_string(write_mps(ineq)))
    lp = to_device_lp(sf, pad_multiple=32, dtype=DTYPES[dt][0])
    res = jpdas.pdas(jpdas.make_pdas(lp), jpdas.PDASConfig(gap_tol=1e-4))
    out, calls = _jax_crossover(res, lp)
    return lp, res, fun, out, calls


def _cert_equal(jc, tc, keys=SAME):
    for k in keys:
        assert tc[k] == jc[k], (k, jc[k], tc[k])
    assert set(tc) == set(jc)


# ---- classify_basis ----------------------------------------------------------


@pytest.mark.parametrize("case", ["free_and_padded", "one_sided", "random"])
def test_classify_basis_is_bit_equal(case):
    if case == "free_and_padded":  # TestClassify's two cases
        x, z, w = [0.5, 1e8 - 1.0, 0.0, 0.0], [0.0, 0.0, 5.0, 0.0], [0.0] * 4
        l, u = [0.0, -1e8, 0.0, -1.0], [1.0, 1e8, 1.0, 1.0]
        mask = [True, True, True, False]
    elif case == "one_sided":
        x, z, w = [0.0, 1.0], [3.0, 0.0], [0.0, 3.0]
        l, u, mask = [0.0, -1e8], [1e8, 1.0], [True, True]
    else:  # 200 rows: clamped, one-sided, free and padded bounds
        rng = np.random.default_rng(0)
        n = 200
        kind = rng.integers(0, 4, n)
        lo = -rng.random(n) * 3
        l = np.where(kind == 1, -1e8, np.where(kind == 3, -1e9, lo))
        u = np.where(kind == 2, 1e8, np.where(kind == 3, 1e9, lo + 1 + rng.random(n)))
        box_l, box_u = np.where(kind == 1, -5.0, l), np.where(kind == 2, 5.0, u)
        x = box_l + (box_u - box_l) * rng.choice([0.0, 1e-6, 0.5, 1 - 1e-6, 1.0], n)
        z = np.abs(rng.normal(size=n)) * rng.choice([0.0, 1e-6, 1.0], n)
        w = np.abs(rng.normal(size=n)) * rng.choice([0.0, 1e-6, 1.0], n)
        mask = rng.random(n) < 0.9
    for dt in ("f32", "f64"):
        jdt, tdt = DTYPES[dt]
        jm = jxo.classify_basis(*(jnp.asarray(v, jdt) for v in (x, z, w, l, u)),
                                jnp.asarray(mask))
        tm = txo.classify_basis(*(_t(v, tdt) for v in (x, z, w, l, u)), _t(mask))
        for a, b in zip(jm, tm):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    if case == "free_and_padded":
        basic, at_lower, _ = tm
        assert basic[0] and basic[1] and at_lower[2] and basic[3]


# ---- _omp_select --------------------------------------------------------------


def _deficit_fixture(seed=0, m=60, n=120, k_missing=4):
    """TestOMPCompletion's fixture: a basis missing a few columns and the
    basic-only least-squares residual."""
    rng = np.random.default_rng(seed)
    A = np.where(rng.random((m, n)) < 0.08, rng.normal(size=(m, n)), 0.0)
    A[:, :m] += np.eye(m)
    basic = np.zeros(n, bool)
    basic[:m - 10] = True
    missing = rng.choice(np.flatnonzero(~basic), k_missing, replace=False)
    x_star = np.zeros(n)
    x_star[basic] = rng.random(m - 10) + 0.5
    x_star[missing] = rng.random(k_missing) + 0.5
    raw = A @ x_star - A @ np.where(basic, x_star, 0.0)
    coef, *_ = np.linalg.lstsq(A[:, basic], raw, rcond=None)
    return A, basic, missing, raw - A[:, basic] @ coef, raw


def _omp_cases():
    A, basic, _, r0, raw = _deficit_fixture()
    n = A.shape[1]
    stop = 1e-9 * (1.0 + np.abs(raw).max())
    yield "deficit", A, r0, basic, ~basic, np.zeros(n, bool), 32, stop
    A4 = np.eye(4, 6)
    A4[:, 4] = [1.0, 1.0, 0.0, 0.0]
    A4[:, 5] = [0.0, 1.0, 1.0, 0.0]
    b4 = np.array([True, True, True, False, False, False])
    r4 = np.array([0.0, 0.0, 0.0, 1.0])
    yield "sign_blocked", A4, r4, b4, np.zeros(6, bool), ~b4, 8, 1e-9
    at_lower = np.zeros(6, bool)
    at_lower[3] = True
    yield "sign_allowed", A4, r4, b4, at_lower, np.zeros(6, bool), 8, 1e-9
    A, basic, missing, r0, raw = _deficit_fixture(seed=7)
    rng = np.random.default_rng(11)
    A2 = np.hstack([A, A[:, [missing[0]]] + 1e-4 * rng.normal(size=(A.shape[0], 8))])
    b2 = np.concatenate([basic, np.zeros(8, bool)])
    yield ("decoys", A2, r0, b2, ~b2, np.zeros(A2.shape[1], bool), 32,
           1e-9 * (1.0 + np.abs(raw).max()))


@pytest.mark.parametrize("case", [c[0] for c in _omp_cases()])
def test_omp_select_matches(case):
    _, A, r0, basic, el, eu, k, stop = next(c for c in _omp_cases() if c[0] == case)
    col_norm = np.maximum(np.linalg.norm(A, axis=0), 1e-30)
    jsel, jres = jxo._omp_select(sp.csc_matrix(A), r0, basic, el, eu, col_norm, k, stop)
    tsel, tres = txo._omp_select(sp.csc_matrix(A), r0, basic, el, eu, col_norm, k, stop)
    np.testing.assert_array_equal(tsel, jsel)
    assert tres == pytest.approx(jres, rel=1e-12, abs=1e-300)
    if case == "sign_blocked":
        assert not tsel.any() and tres == pytest.approx(1.0)
    if case == "sign_allowed":
        assert tsel[3] and int(tsel.sum()) == 1


def test_host_helpers_match():
    lp, *_ = _random_entry(7, "f32")
    tlp = convert.device_lp_from_numpy(lp, device="cpu")
    np.testing.assert_array_equal(txo._column_norms(tlp), jxo._column_norms(lp))
    assert (txo._host_csc(tlp) != jxo._host_csc(lp)).nnz == 0


# ---- one polish pass, in lockstep -----------------------------------------


@pytest.mark.parametrize("dt,rtol", [("f64", 1e-9), ("f32", 1e-6)])
def test_polish_pass_in_lockstep(dt, rtol):
    """Every polish pass of JAX's crossover on random_lp(7)'s 1e-4 iterate,
    replayed through the port's _polish on JAX's own inputs and partition."""
    lp, _, _, _, calls = _random_entry(7, dt)
    tdt = DTYPES[dt][1]
    tlp = convert.device_lp_from_numpy(lp, device="cpu", dtype=tdt)
    cfg = txo.CrossoverConfig()
    for args, jout in calls:
        x, x_lo, y0 = (_t(a, tdt) for a in args[:3])
        basic, at_lower, at_upper = (_t(a) for a in args[3:])
        tout = txo._polish(tlp, x, x_lo, y0, basic, at_lower, at_upper, cfg)
        jx, jy, jcert = jout[0], jout[1], jout[9]
        tcert = txo._cert_to_host(tout[9])
        for j, t in ((jx, tout[0]), (jy, tout[1])):
            a = np.asarray(j.hi, np.float64) + np.asarray(j.lo, np.float64)
            b = t.hi.double().numpy() + t.lo.double().numpy()
            assert np.all(np.abs(a - b) <= rtol * (1.0 + np.abs(a)))
        for k in ("certified", "n_basic", "n_lower", "n_upper"):
            assert tcert[k] == jcert[k], k
    # The last pass certifies in both, every field below its bar.
    for c in (jcert, tcert):
        assert bool(c["certified"]) and bool(c["factor_ok"])
        assert float(c["primal_rel"]) < cfg.primal_tol
        assert float(c["dual_rel"]) < cfg.dual_tol
        assert float(c["gap"]) < cfg.gap_tol
    l, u, mask = (np.asarray(v, np.float64) for v in (lp.l, lp.u, lp.col_mask))
    bscale = max(np.abs(np.where(mask * (np.abs(v) < cfg.clamp), v, 0.0)).max()
                 for v in (l, u))
    for c in (jcert, tcert):
        assert float(c["bound_violation"]) < cfg.primal_tol * (1.0 + bscale)


# ---- the repair loop, free-running -------------------------------------------


@pytest.mark.parametrize("seed,dt", [(0, "f32"), (7, "f32"), (5, "f64")])
def test_crossover_matches_jax(seed, dt):
    lp, res, fun, jout, _ = _random_entry(seed, dt)
    tlp, tres = _port(lp, res, DTYPES[dt][1])
    tout = txo.crossover(tres, tlp)
    jc, tc = jout.extra["crossover"], tout.extra["crossover"]
    _cert_equal(jc, tc)
    assert tc["certified"]
    assert int(tout.status) == Status.OPTIMAL
    if dt == "f64":
        assert float(tout.objective) == pytest.approx(float(jout.objective), rel=1e-11)
        assert float(tout.objective) == pytest.approx(fun, rel=1e-10, abs=1e-10)
    else:
        assert float(tout.objective) == pytest.approx(fun, rel=2e-6, abs=2e-6)
    # The polished result carries the extras the front door reads.
    for k in ("gap", "dual_objective", "x_lo", "y", "w", "z"):
        assert k in tout.extra
    assert tout.x.dtype == DTYPES[dt][1]


WIDEN_MPS = """NAME          WIDEN
ROWS
 N  COST
 E  R1
 E  R2
 E  R3
COLUMNS
    X1        COST      1.0        R1        1.0
    X2        COST      2.0        R1        1.0
    X2        R2        1.0        R3        1.0
    X3        COST      1.0        R2        1.0
RHS
    RHS       R1        1.0005     R2        1.0005
    RHS       R3        0.0005
BOUNDS
 UP BND       X1        2.0
 UP BND       X2        2.0
 UP BND       X3        2.0
ENDATA
"""

DEMOTE_MPS = """NAME          DEMOTE
ROWS
 N  COST
 E  R1
COLUMNS
    X1        COST      1.0        R1        1.0
    X2        COST      2.0        R1        1.0
RHS
    RHS       R1        1.0002
BOUNDS
 UP BND       X1        2.0
 UP BND       X2        2.0
ENDATA
"""


def _adversarial(mps, x, y, z):
    """TestWidenRepair's / TestDemoteRepair's crafted entry at pad 4: the
    iterate sits at the optimum with a stale dual that misreads one column."""
    sf = cim.to_standard_form(read_mps_string(mps))
    lp = to_device_lp(sf, pad_multiple=4, dtype=jnp.float32)
    m_pad, n_pad = lp.A.shape
    f32 = lambda v, k: jnp.asarray(np.pad(v, (0, k - len(v))), jnp.float32)  # noqa: E731
    xj = f32(x, n_pad)
    res = SolveResult(
        x=xj, objective=jnp.vdot(lp.c, xj),
        status=jnp.asarray(Status.OPTIMAL, jnp.int32),
        iterations=jnp.asarray(10, jnp.int32), residual_norm=jnp.asarray(0.0),
        extra={"y": f32(y, m_pad), "w": jnp.zeros(n_pad, jnp.float32),
               "z": f32(z, n_pad), "gap": jnp.asarray(1e-6)},
    )
    return lp, res


@pytest.mark.parametrize("fixture,ablation", [
    ("widen", {}), ("widen", dict(widen_dual_tol=0.0)),
    ("demote", {}), ("demote", dict(demote_near_tol=0.0, widen_dual_tol=0.0)),
])
def test_repair_fixtures_match_jax(fixture, ablation):
    if fixture == "widen":
        lp, res = _adversarial(WIDEN_MPS, [1.0, 5e-4, 1.0], [1.0, 1.0, 0.0],
                               [0.0, 2e-3, 0.0])
    else:
        lp, res = _adversarial(DEMOTE_MPS, [1.0, 2e-4], [1.0], [0.0, 1e-5])
    jout, calls = _jax_crossover(res, lp, config=jxo.CrossoverConfig(**ablation))
    tlp, tres = _port(lp, res, torch.float32)
    cfg = txo.CrossoverConfig(**ablation)
    tout = txo.crossover(tres, tlp, config=cfg)
    jc, tc = jout.extra["crossover"], tout.extra["crossover"]
    _cert_equal(jc, tc)
    # Every pass of JAX's loop, replayed through the port's _polish.
    for args, jpass in calls:
        x, x_lo, y0 = (_t(a, torch.float32) for a in args[:3])
        tpass = txo._polish(tlp, x, x_lo, y0, *(_t(a) for a in args[3:]), cfg)
        a = np.asarray(jpass[0].hi, np.float64) + np.asarray(jpass[0].lo, np.float64)
        b = tpass[0].hi.double().numpy() + tpass[0].lo.double().numpy()
        assert np.all(np.abs(a - b) <= 1e-6 * (1.0 + np.abs(a)))
        assert txo._cert_to_host(tpass[9])["certified"] == bool(jpass[9]["certified"])
    assert tc["certified"] == (not ablation)
    if ablation:  # the failed certificate returns the entry untouched
        assert tout.x is tres.x and int(tout.status) == int(tres.status)
        assert tout.extra["crossover"] is tc and "x_lo" not in tout.extra
    elif fixture == "widen":
        assert tc["widened"] == 1 and tc["repairs"] >= 1
        assert float(tout.objective) == pytest.approx(2.001, rel=1e-6)
        assert float(tout.x[1]) == pytest.approx(5e-4, rel=1e-3)
    else:
        assert tc["repairs"] >= 1
        assert float(tout.objective) == pytest.approx(1.0002, rel=1e-6)
        assert float(tout.x[1]) == pytest.approx(0.0, abs=1e-9)
    if fixture == "widen" and ablation:
        assert tc["primal_rel"] > 1e-4 and tc["widened"] == 0
    if fixture == "demote" and ablation:
        assert tc["dual_rel"] > 1e-3


# ---- the entry repair ------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _entry_lp(seed, dt):
    sf, info = constructed_optimum_lp(m=64, seed=seed)
    lp = to_device_lp(sf, pad_multiple=16, dtype=DTYPES[dt][0])
    p1 = jpdas.pdas(jpdas.make_pdas(lp),
                    jpdas.PDASConfig(max_iters=300, refine_steps=2))
    return lp, info, p1


def _perturbed(seed, dt):
    """TestEntryRepair's entry: a diffuse ~1e-3 primal perturbation over
    every real column of a converged pdas iterate."""
    import dataclasses

    lp, info, p1 = _entry_lp(seed, dt)
    rng = np.random.default_rng(seed + 7)
    dx = jnp.asarray(1e-3 * rng.standard_normal(p1.x.shape), p1.x.dtype) * lp.col_mask
    x = p1.x + dx
    r = np.asarray(lp.A) @ np.asarray(x) - np.asarray(lp.b)
    return lp, info, dataclasses.replace(
        p1, x=x, residual_norm=jnp.asarray(np.linalg.norm(r), p1.x.dtype))


@pytest.mark.parametrize("dt,rtol", [("f32", 1e-6), ("f64", 1e-10)])
def test_entry_repair_matches_jax(dt, rtol):
    lp, info, pert = _perturbed(0, dt)
    tlp, tres = _port(lp, pert, DTYPES[dt][1])
    tout = txo.crossover(tres, tlp)
    tc = tout.extra["crossover"]
    x_lo = jnp.zeros_like(pert.x)
    _, _, pv0, pv1 = jxo._entry_repair_jit(lp, pert.x, x_lo, jxo.CrossoverConfig())
    assert tc["entry_repair_pviol"][0] == pytest.approx(float(pv0), rel=rtol)
    assert tc["entry_repair_pviol"][1] == pytest.approx(float(pv1), rel=rtol)
    assert tc["entry_repair_pviol"][1] < 1e-2 * tc["entry_repair_pviol"][0]
    assert tc["certified"]
    assert float(tout.objective) == pytest.approx(info["objective"], rel=2e-6)


def test_clean_entry_pays_nothing():
    """A converged entry passes the gate (no repair, no key) and certifies."""
    lp, info, p1 = _entry_lp(0, "f32")
    tlp, tres = _port(lp, p1, torch.float32)
    tout = txo.crossover(tres, tlp)
    tc = tout.extra["crossover"]
    assert "entry_repair_pviol" not in tc
    assert tc["certified"]
    assert float(tout.objective) == pytest.approx(info["objective"], rel=2e-6)
    # The gate off: no repair even on the perturbed entry.
    lp, _, pert = _perturbed(0, "f32")
    tlp, tres = _port(lp, pert, torch.float32)
    tc = txo.crossover(tres, tlp, config=txo.CrossoverConfig(entry_repair_tol=0.0))
    assert "entry_repair_pviol" not in tc.extra["crossover"]


def test_dense_engine_raises():
    """A sparse engine of the dense A (ported; afiro is held against the
    JAX package's engine in tests/test_torch_dense_engine.py): the f32
    entry polished with the tiles takes the decisions of JAX's dense
    crossover of it, the objective within 2e-6 of JAX's."""
    lp, res, _fun, jout, _calls = _random_entry(7, "f32")
    tlp, tres = _port(lp, res, torch.float32)
    eng = tsparse.engine_for(tlp.A, block=16, device="cpu")
    tout = txo.crossover(tres, tlp, engine=eng)
    _cert_equal(jout.extra["crossover"], tout.extra["crossover"])
    assert float(tout.objective) == pytest.approx(float(jout.objective), rel=2e-6)
