"""The port's dense-A tile engine (``sparse.tiled.engine_for``: assemble,
prepare_normal, solve_normal) and the solvers that take it on a dense
state, held against the JAX package in f64 on the CPU.

- the engine's tables (tiles, pperm, the range-assembly windows and
  destinations, both costs) are equal on the patterns of
  tests/test_tiled.py at blocks 8 and 16;
- ``assemble`` in scan and in range mode is within 1e-12 of JAX's, and
  the two modes within 1e-12 of each other;
- ``solve_normal`` is within 1e-10 of JAX's with 0 and 2 refinement
  steps, with 12 PCG steps on tests/test_krylov.py's banded problem, and
  on a singular normal matrix (ok False and a zero solution in both, then
  the dbound retry, ok True in both);
- pdas on afiro (block 16) and pdas_dd on random_lp seed 2 with the engine
  take JAX's status and iteration count, every recorded iterate within
  1e-6; affine scaling with the engine takes JAX's count and, driven in
  lockstep from JAX's iterates, JAX's branch and stop at every iteration
  (on an LP whose f64 count does not follow rounding, ROADMAP §3 item 2);
  crossover on afiro's pdas stop with the engine takes JAX's certificate
  decisions, the objective within 1e-10.

JAX's compiles dominate the cost, so each JAX solve runs once."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cholesky_is_magic_tpu as cim
from cholesky_is_magic_tpu.ingest import to_device_lp
from cholesky_is_magic_tpu.ingest.mps import read_mps_string
from cholesky_is_magic_tpu.sparse import tiled as jtiled
from cholesky_is_magic_tpu.utils.testing import random_lp, write_mps
from cholesky_is_magic_tpu_torch import convert
from cholesky_is_magic_tpu_torch.sparse import tiled as ttiled
from test_torch_affine import AFIRO, OPTIMUM, _lockstep
from test_torch_affine import _lps as _affine_lps

# The solver modules (their packages re-export functions of the same name).
jpdas = importlib.import_module("cholesky_is_magic_tpu.solvers.pdas")
tpdas = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas")
jdd = importlib.import_module("cholesky_is_magic_tpu.solvers.pdas_dd")
tdd = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas_dd")
jaff = importlib.import_module("cholesky_is_magic_tpu.solvers.affine")
taff = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.affine")
jxo = importlib.import_module("cholesky_is_magic_tpu.solvers.crossover")
txo = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.crossover")

torch.set_num_threads(1)


def _pattern(kind, seed=7):
    """tests/test_tiled.py's patterns: random with a dominant diagonal at
    two densities, and three independent blocks."""
    rng = np.random.default_rng(seed)
    if kind == "blocks":
        A = np.zeros((96, 192))
        for k in range(3):
            blk = (rng.random((32, 64)) < 0.2) * rng.normal(size=(32, 64))
            blk[np.arange(32), np.arange(32)] += 2.0
            A[32 * k: 32 * (k + 1), 64 * k: 64 * (k + 1)] = blk
        return A, rng
    density = {"sparse": 0.10, "denser": 0.20}[kind]
    A = (rng.random((72, 120)) < density) * rng.normal(size=(72, 120))
    A[np.arange(72), np.arange(72)] += 2.0
    return A, rng


CASES = [("sparse", 8), ("denser", 16), ("blocks", 16)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


def _engines(A, block):
    return (jtiled.engine_for(A, block=block),
            ttiled.engine_for(torch.from_numpy(A), block=block, device="cpu"))


@pytest.mark.parametrize("kind,block", CASES)
def test_engine_tables_equal(kind, block):
    A, _ = _pattern(kind)
    je, te = _engines(A, block)
    assert (te.B, te.b, te.NT, te.tiles, te.dropped_updates) == (
        je.B, je.b, je.NT, je.tiles, je.dropped_updates)
    assert (te.Rmax_asm, te.range_cost, te.scan_cost, te.assemble_mode) == (
        je.Rmax_asm, je.range_cost, je.scan_cost, je.assemble_mode)
    for f in ("pperm", "asm_lo", "asm_dst", "tile_i", "tile_j", "diag_ids",
              "rows_ids", "syrk_dst"):
        t = getattr(te, f)
        np.testing.assert_array_equal(np.asarray(getattr(je, f)),
                                      t.numpy() if isinstance(t, torch.Tensor) else t)


@pytest.mark.parametrize("kind,block", CASES)
def test_assemble_modes_match(kind, block):
    """Scan and range mode against JAX's (tests/test_tiled.py:118), with a
    boost on some rows and zero padded rows at the end."""
    A, rng = _pattern(kind)
    A = np.vstack([A, np.zeros((5, A.shape[1]))])
    m, n = A.shape
    je, te = _engines(A, block)
    d = rng.random(n) + 0.5
    boost = (rng.random(m) < 0.1).astype(np.float64)
    boost[-5:] = 1.0
    out = {}
    for mode in ("scan", "range"):
        tj = je.assemble(jnp.asarray(A), jnp.asarray(d), jnp.asarray(boost), mode=mode)
        out[mode] = te.assemble(torch.from_numpy(A), torch.from_numpy(d),
                                torch.from_numpy(boost), mode=mode).numpy()
        assert _rel(tj, out[mode]) <= 1e-12
    assert _rel(out["scan"], out["range"]) <= 1e-12
    np.testing.assert_array_equal(out["scan"][te.NT], 0.0)


def _solve_pair(A, block, d, g, **kw):
    je, te = _engines(A, block)
    fj = jax.jit(lambda d_, g_: je.solve_normal(jnp.asarray(A), d_, g_, **kw))
    yj, okj = fj(jnp.asarray(d), jnp.asarray(g))
    yt, okt = te.solve_normal(torch.from_numpy(A), torch.from_numpy(d),
                              torch.from_numpy(g), **kw)
    return np.asarray(yj), bool(okj), yt.numpy(), bool(okt)


@pytest.mark.parametrize("refine_steps", [0, 2])
def test_solve_normal_matches(refine_steps):
    A, rng = _pattern("sparse", seed=11)
    # IPM-like column scales (cond(N) ~ 1e6): refinement has work to do.
    d = 10.0 ** rng.uniform(-1.5, 1.5, size=A.shape[1])
    g = rng.normal(size=A.shape[0])
    yj, okj, yt, okt = _solve_pair(A, 16, d, g, refine_steps=refine_steps)
    assert okj and okt
    assert _rel(yj, yt) <= 1e-10


def test_krylov_solve_matches():
    """12 PCG steps on tests/test_krylov.py:142's banded problem (m = 256,
    block 64, kappa spread 1e4)."""
    rng = np.random.default_rng(1)
    m, band = 256, 6
    n = 2 * m
    rows = np.repeat(np.arange(m), band)
    cols = (2 * rows + np.tile(np.arange(band), m)) % n
    A = sp.csc_matrix((rng.normal(size=rows.size), (rows, cols)), shape=(m, n)).toarray()
    d = np.exp(rng.uniform(0, np.log(1e4), size=n))
    g = rng.normal(size=m)
    yj, okj, yt, okt = _solve_pair(A, 64, d, g, refine_steps=0, krylov_steps=12)
    assert okj and okt
    assert _rel(yj, yt) <= 1e-10
    Ad = A * d[None, :]
    assert _rel(np.linalg.solve(Ad @ Ad.T, g), yt) <= 1e-10


def test_singular_and_dbound_retry_match():
    A, rng = _pattern("sparse", seed=3)
    d = rng.random(A.shape[1]) + 0.5
    d[:40] = 0.0  # rows whose only coupling is through zeroed columns
    A = A.copy()
    A[:, 40:][:5] = 0.0  # ... so these five rows of N are exactly zero
    g = rng.normal(size=A.shape[0])
    yj, okj, yt, okt = _solve_pair(A, 8, d, g)
    assert not okj and not okt
    np.testing.assert_array_equal(yt, 0.0)
    yj, okj, yt, okt = _solve_pair(A, 8, d, g, dbound=1e-6)
    assert okj and okt
    assert _rel(yj, yt) <= 1e-10


def _afiro_lp():
    sf = cim.to_standard_form(cim.read_mps_file(AFIRO))
    return to_device_lp(sf, pad_multiple=16, dtype=jnp.float64)


def _assert_trajectories(jr, tr):
    """The same status and count; every recorded iterate (hi + lo for the
    dd loop) within 1e-6 relative to max(1, |x|)."""
    assert tr.status_name == jr.status_name == "optimal"
    k = int(jr.iterations)
    assert int(tr.iterations) == k
    trace_j, trace_t = jr.extra["trace"], tr.extra["trace"]
    xj = np.asarray(trace_j["x"], np.float64)[:k]
    xt = trace_t["x"].numpy()[:k]
    if "x_lo" in trace_j:
        xj = xj + np.asarray(trace_j["x_lo"], np.float64)[:k]
        xt = xt + trace_t["x_lo"].numpy()[:k]
    scale = np.maximum(1.0, np.abs(xj).max(axis=1, keepdims=True))
    assert np.all(np.abs(xj - xt) / scale < 1e-6)


@pytest.fixture(scope="module")
def afiro_pdas():
    """tests/test_netlib.py:118: pdas on afiro with engine_for(A, 16), in
    both packages from the same state (its 1e-4 stop feeds crossover)."""
    jst = jpdas.make_pdas(_afiro_lp())
    tst = convert.pdas_state_from_numpy(jst, device="cpu")
    je = jtiled.engine_for(jst.lp.A, block=16)
    te = ttiled.engine_for(tst.lp.A, block=16, device="cpu")
    kw = dict(max_iters=300, record_iterates=True)
    jr = jpdas.pdas(jst, jpdas.PDASConfig(**kw), engine=je)
    tr = tpdas.pdas(tst, tpdas.PDASConfig(**kw), engine=te)
    return jst, je, jr, tst, te, tr


def test_pdas_afiro_with_engine(afiro_pdas):
    *_, jr, _tst, _te, tr = afiro_pdas
    _assert_trajectories(jr, tr)
    assert float(tr.objective) == pytest.approx(OPTIMUM, rel=1e-4)


def test_pdas_dd_with_engine():
    """tests/test_pdas_dd.py:67's flow on random_lp seed 2, in f64."""
    ineq = random_lp(2, n_ub=24, n_eq=6, n=32, bounded=True)
    sf = cim.to_standard_form(read_mps_string(write_mps(ineq)))
    jst = jdd.make_pdas_dd(to_device_lp(sf, pad_multiple=64, dtype=jnp.float64))
    tst = convert.pdas_dd_state_from_numpy(jst, device="cpu")
    je = jtiled.engine_for(jst.lp.A, block=16)
    te = ttiled.engine_for(tst.lp.A, block=16, device="cpu")
    kw = dict(max_iters=300, gap_tol=1e-8, refine_steps=3, record_iterates=True)
    jr = jdd.pdas_dd(jst, jpdas.PDASConfig(**kw), engine=je)
    tr = tdd.pdas_dd(tst, tpdas.PDASConfig(**kw), engine=te)
    _assert_trajectories(jr, tr)
    assert float(tr.extra["gap"]) < 1e-7


def test_affine_with_engine_matches():
    """Affine scaling with the engine (block 8: 5 panels) on
    tests/test_sparse_pipeline.py's problem(1): the loop takes JAX's status
    and count, x within 1e-6, and driven in lockstep from JAX's iterates
    it takes JAX's branch and stop at every iteration.  (On afiro the stop
    of the f64 loop with the engine follows rounding in the JAX package
    itself: a sign test on a descent of ~1e-11 ends its jitted step at 20
    iterations, its loop at 25; the port's loop stops at 22, both optimal
    within 1e-7 of the optimum; ROADMAP §3 item 2.)"""
    jlp, tlp = _affine_lps("sparse1")
    jst, tst = jaff.make_affine_state(jlp), taff.make_affine_state(tlp)
    je = jtiled.engine_for(jst.lp.A, block=8)
    te = ttiled.engine_for(tst.lp.A, block=8, device="cpu")
    assert te.B == 5
    jcfg, tcfg = jaff.AffineConfig(max_iters=400), taff.AffineConfig(max_iters=400)
    jr = jaff.affine_scaling(jst, jcfg, engine=je)
    tr = taff.affine_scaling(tst, tcfg, engine=te)
    assert tr.status_name == jr.status_name == "optimal"
    assert int(tr.iterations) == int(jr.iterations)
    xj, xt = np.asarray(jr.x), tr.x.numpy()
    assert np.max(np.abs(xj - xt) / np.maximum(1.0, np.abs(xj))) < 1e-6
    assert float(tr.objective) == pytest.approx(float(jr.objective), rel=1e-8)
    k, code = _lockstep(jst, tst, jcfg, tcfg, je, te)
    assert (k, code) == (int(jr.iterations), 0)


def test_crossover_afiro_with_engine(afiro_pdas):
    """afiro's f64 pdas stop at the 1e-4 gap, polished with the engine."""
    jst, je, res, *_ = afiro_pdas
    jout = jxo.crossover(res, jst.lp, engine=je)
    tlp = convert.device_lp_from_numpy(jst.lp, device="cpu")
    tres = convert.solve_result_from_numpy(res, device="cpu")
    te = ttiled.engine_for(tlp.A, block=16, device="cpu")
    tout = txo.crossover(tres, tlp, engine=te)
    jc, tc = jout.extra["crossover"], tout.extra["crossover"]
    for key in ("certified", "factor_ok", "repairs", "widened", "n_basic",
                "n_lower", "n_upper"):
        assert tc[key] == jc[key], key
    assert tc["certified"]
    assert float(tout.objective) == pytest.approx(float(jout.objective), rel=1e-10)
    assert float(tout.objective) == pytest.approx(OPTIMUM, rel=1e-9)
