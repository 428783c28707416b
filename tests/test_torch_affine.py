"""The port's primal affine-scaling driver, held against the JAX package.

- ``make_affine_state`` (degenerate widening, the four start cases, a warm
  ``x0``) is bit-equal in f64;
- one ``_project``, ``_scaling_step`` (centering or not, and with the
  slack-cap retry forced) and ``_repair_iteration`` agree to 1e-12
  relative in f64;
- driven from JAX's iterate at every iteration, the port takes the same
  branch and the same stop, its next iterate within 1e-6, so it stops
  after as many iterations;
- the whole loop, started from the same state, gives the same status, x
  within 1e-6, the objective within 1e-8 relative and the same
  ``record_trace`` arrays in f64, dense and fully sparse, and the same
  iteration count except where the end game's rounding decides the stop
  (simple, afiro: see LOOP_CASES);
- the JAX package's own f64 count on afiro moves when its start moves by
  one ulp (the witness for LOOP_CASES' spread);
- f32 afiro after row equilibration stops at its iterate floor within
  2e-3 of the optimum, as ``tests/test_netlib.py:71-87`` pins it;
- f32 sparse on the m = 2048 constructed LP: the port's objective error
  follows JAX's through the approach, and its iteration and repair counts
  lie within F32_SPREAD of JAX's, whose own count moves by one ulp too;
- ``solve(afiro, "affine")`` gives JAX's summary.

Run as a script (``JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 PYTHONPATH=. python
tests/test_torch_affine.py 2048,0,128,32 16384,0,128,64``), it prints the
sparse comparison for each ``m,seed,block,bits`` given (bits 32 or 64).
"""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cholesky_is_magic_tpu as cim
import cholesky_is_magic_tpu_torch as cimt
from cholesky_is_magic_tpu.ingest import to_device_lp
from cholesky_is_magic_tpu.ingest.mps import read_mps_string as j_read
from cholesky_is_magic_tpu.ingest.standard_form import StandardForm as JSF
from cholesky_is_magic_tpu.utils.testing import random_lp, write_mps
from cholesky_is_magic_tpu_torch import convert
from cholesky_is_magic_tpu_torch.ingest.mps import read_mps_string as t_read
from cholesky_is_magic_tpu_torch.ingest.standard_form import StandardForm as TSF
from cholesky_is_magic_tpu_torch.ops import dd_cuda

# The solver modules (their packages re-export functions of the same name).
jaff = importlib.import_module("cholesky_is_magic_tpu.solvers.affine")
taff = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.affine")

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
AFIRO = os.path.join(FIXTURES, "afiro.mps")
OPTIMUM = -464.75314285714285
UNBOUNDED_MPS = """NAME UNB
ROWS
 N  O
 E  R
COLUMNS
    X  O  -1.0
    S  R  1.0
RHS
    H  R  1.0
ENDATA
"""


def _text(name):
    """MPS text of a named LP (the cases of tests/test_solvers.py)."""
    if name in ("simple", "maxrange", "afiro"):
        return open(os.path.join(FIXTURES, f"{name}.mps")).read()
    if name == "unbounded":
        return UNBOUNDED_MPS
    if name.startswith("rlp"):  # random_lp(seed), tests/test_solvers.py:49
        return write_mps(random_lp(int(name[3:]), bounded=True))
    assert name == "sparse1"  # problem(1) of tests/test_sparse_pipeline.py
    return write_mps(random_lp(1, n_ub=24, n_eq=6, n=32, bounded=True))


def _sfs(name):
    text = _text(name)
    return (cim.to_standard_form(j_read(text)),
            cimt.to_standard_form(t_read(text)))


def _lps(name, pad=8, dtype=jnp.float64):
    """The same padded LP for JAX and, bit for bit, for the port."""
    lp = to_device_lp(_sfs(name)[0], pad_multiple=pad, dtype=dtype)
    return lp, convert.device_lp_from_numpy(lp, device="cpu")


def _close(j, t, rtol=1e-12):
    a = np.asarray(j, np.float64)
    b = t.numpy().astype(np.float64)
    scale = max(1.0, float(np.max(np.abs(a), initial=0.0)))
    assert float(np.max(np.abs(a - b), initial=0.0)) <= rtol * scale


def _box_lp():
    """Columns in every start case of make-affine-state: both sides free,
    low side free (at -inf and at -1e12), high side free, a finite box,
    and two degenerate boxes (l = u, and u - l = 1e-7); padded to 16."""
    A = np.array([[1.0, 2.0, 0.0, 1.0, 0.0, 1.0, 0.0],
                  [0.0, 1.0, 1.0, 0.0, 3.0, 0.0, 1.0]])
    r, c = np.nonzero(A)
    l = np.array([-np.inf, -np.inf, 0.5, -2.0, 1.5, 0.0, -1e12])
    u = np.array([np.inf, 4.0, np.inf, 3.0, 1.5, 1e-7, 7.0])
    kw = dict(nvars=7, ncons=2, c=np.arange(7.0) - 3.0, a_rows=r.astype(np.int32),
              a_cols=c.astype(np.int32), a_vals=A[r, c], b=np.array([1.0, 2.0]),
              row_type=np.zeros(2, np.int8), l=l, u=u, initial_vars=7)
    lp = to_device_lp(JSF(**kw), pad_multiple=16, dtype=jnp.float64)
    return lp, convert.device_lp_from_numpy(lp, device="cpu")


@pytest.mark.parametrize("warm", [False, True])
def test_make_affine_state_is_bit_equal(warm):
    jlp, tlp = _box_lp()
    x0 = None
    if warm:
        x0 = np.random.default_rng(0).normal(size=jlp.c.shape[0]) * 5.0
    js = jaff.make_affine_state(jlp, None if x0 is None else jnp.asarray(x0))
    ts = taff.make_affine_state(tlp, None if x0 is None else torch.from_numpy(x0))
    for a, b in ((js.x, ts.x), (js.lp.l, ts.lp.l), (js.lp.u, ts.lp.u)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # The degenerate columns were widened, the padded ones kept.
    assert float(ts.lp.u[4]) == 1.5 + 5e7 and float(ts.lp.l[4]) == 1.5 - 5e-7
    assert float(ts.lp.l[10]) == -1.0 and float(ts.x[10]) == 0.0


def _states(name):
    jlp, tlp = _lps(name)
    return jaff.make_affine_state(jlp), taff.make_affine_state(tlp)


def _cfgs(**kw):
    return jaff.AffineConfig(**kw), taff.AffineConfig(**kw)


@pytest.mark.parametrize("name", ["afiro", "rlp3"])
def test_one_step_helpers_match(name):
    js, ts = _states(name)
    jcfg, tcfg = _cfgs()
    jl, tl = js.lp, ts.lp
    jslack = jaff._slack(jl.l, js.x, jl.u, jcfg.max_slack, jl.col_mask)
    tslack = taff._slack(tl.l, ts.x, tl.u, tcfg.max_slack, tl.col_mask)
    _close(jslack, tslack)
    jdg, jok = jaff._project(jl, jslack, jl.c, 1)
    tdg, tok = taff._project(tl, tslack, tl.c, 1)
    assert bool(jok) and bool(tok)
    _close(jdg, tdg)
    for centering in (False, True):
        jout = jaff._scaling_step(js, jnp.asarray(centering), jcfg)
        tout = taff._scaling_step(ts, centering, tcfg)
        for a, b in zip(jout, tout):
            _close(a, b)
    jres = jaff._residual(jl, js.x)
    tres = taff._residual(tl, ts.x)
    _close(jres, tres)
    for a, b in zip(jaff._repair_iteration(js, jres, jcfg),
                    taff._repair_iteration(ts, tres, tcfg)):
        _close(a, b)


def test_scaling_step_retry_matches(monkeypatch):
    """A factorization reported failed at the 1e8 slack cap is retried at
    sqrt(1e8) in both packages (the box LP's free column sits at the 1e8
    cap)."""
    def failing_at_the_big_cap(project, xp):
        def wrapped(lp, scale, *a, **k):
            dg, ok = project(lp, scale, *a, **k)
            return dg, ok & (xp.max(scale) < 1e6)
        return wrapped

    jlp, tlp = _box_lp()
    js, ts = jaff.make_affine_state(jlp), taff.make_affine_state(tlp)
    assert float(torch.max(taff._slack(ts.lp.l, ts.x, ts.lp.u, 1e8,
                                       ts.lp.col_mask))) > 1e6
    monkeypatch.setattr(jaff, "_project", failing_at_the_big_cap(jaff._project, jnp))
    monkeypatch.setattr(taff, "_project", failing_at_the_big_cap(taff._project, torch))
    jcfg, tcfg = _cfgs()
    jout = jaff._scaling_step(js, jnp.asarray(False), jcfg)
    tout = taff._scaling_step(ts, False, tcfg)
    assert bool(jout[1]) and bool(tout[1])
    for a, b in zip(jout, tout):
        _close(a, b)
    # The retry's smaller slack cap moved the step.
    monkeypatch.undo()
    assert not torch.equal(tout[0], taff._scaling_step(ts, False, tcfg)[0])


# (name, max_iters, status, spread): ``spread`` is how far the free-running
# counts may differ, the gap measured (simple: port 17, JAX 15; afiro: port
# 25, JAX 26).  The end game scales N by slacks from 1e-8 to 1e8, so a
# rounding difference grows ~10x per iteration, and the stop reads the sign
# of g·c at ~1e-15 (simple) or a repair step fires one iteration apart
# (afiro).  The JAX package itself takes 23 iterations on afiro, not 26,
# when its start moves by one ulp
# (test_jax_afiro_count_moves_with_its_start); on the other LPs the counts
# agree.
LOOP_CASES = [
    ("simple", 200, "optimal", 2),
    ("maxrange", 300, "optimal", 0),
    ("rlp0", 400, "optimal", 0),
    ("rlp3", 400, "optimal", 0),
    ("unbounded", 50, "unbounded", 0),
    ("afiro", 600, "optimal", 1),
]


def _lockstep(jst, tst, jcfg, tcfg, jeng=None, teng=None):
    """Both packages' iteration functions driven from JAX's iterate at every
    iteration, with the driver's branch and stop of each package; asserts
    the same branch, the same (cont, status), the next iterate within 1e-6
    (one step's normal solve has a condition number up to ~1e16 in the end
    game) and the trace values of the shared iterate within 1e-9.  Returns
    (iterations, status code)."""
    import jax

    jlp, tlp = jst.lp, tst.lp

    @jax.jit
    def jstep(x, needs_repair, centering):
        st = jaff.AffineState(x=x, lp=jlp)
        r = jaff._residual(jlp, x)
        return jax.lax.cond(
            needs_repair,
            lambda: jaff._repair_iteration(st, r, jcfg, jeng),
            lambda: jaff._optimize_iteration(st, centering, jcfg, jeng))

    jtol = jcfg.residual_tol * jnp.asarray(jlp.m, jlp.c.dtype)
    ttol = tcfg.residual_tol * torch.tensor(float(tlp.m), dtype=tlp.c.dtype)
    x, i, cont, status = jst.x, 0, True, 0
    while i < jcfg.max_iters:
        xt = torch.from_numpy(np.array(x))
        jr, tr = jaff._residual(jlp, x), taff._residual(tlp, xt)
        jnorm, tnorm = jnp.linalg.norm(jr), torch.linalg.norm(tr)
        needs = bool(jnorm > jtol)
        assert bool(tnorm > ttol) == needs
        if not ((cont or needs) and status == 0):
            break
        centering = (i + 1) % jcfg.recenter_every == 0
        jx, jcont, jstat = jstep(x, needs, centering)
        st = taff.AffineState(x=xt, lp=tlp)
        tx, tcont, tstat = (
            taff._repair_iteration(st, tr, tcfg, teng) if needs
            else taff._optimize_iteration(st, centering, tcfg, teng))
        assert bool(tcont) == bool(jcont) and int(tstat) == int(jstat)
        _close(jx, tx, 1e-6)
        _close(jnorm, tnorm, 1e-9)
        _close(jnp.dot(x, jlp.c), torch.dot(xt, tlp.c), 1e-9)
        x, i, cont, status = jx, i + 1, bool(jcont), int(jstat)
    return i, status


@pytest.mark.parametrize("name,max_iters,status,spread", LOOP_CASES)
def test_affine_iterations_match_in_lockstep(name, max_iters, status, spread):
    """From the same iterate the port takes JAX's branch and stop at every
    iteration, so along JAX's trajectory it stops after as many iterations
    as JAX's driver."""
    jlp, tlp = _lps(name, pad=16 if name == "afiro" else 8)
    jcfg, tcfg = _cfgs(max_iters=max_iters)
    k, code = _lockstep(jaff.make_affine_state(jlp),
                        taff.make_affine_state(tlp), jcfg, tcfg)
    jr = jaff.affine_scaling(jaff.make_affine_state(jlp), jcfg)
    # afiro: JAX's own iteration, jitted one step at a time, stops at 25
    # where its jitted loop stops at 26 (its end game, see LOOP_CASES).
    assert abs(k - int(jr.iterations)) <= (spread if name == "afiro" else 0)
    assert code in (0, int(jr.status))


@pytest.mark.parametrize("name,max_iters,status,spread", LOOP_CASES)
def test_affine_loop_matches(name, max_iters, status, spread):
    jlp, tlp = _lps(name, pad=16 if name == "afiro" else 8)
    jcfg, tcfg = _cfgs(max_iters=max_iters, record_trace=True)
    jr = jaff.affine_scaling(jaff.make_affine_state(jlp), jcfg)
    tr = taff.affine_scaling(taff.make_affine_state(tlp), tcfg)
    assert tr.status_name == jr.status_name == status
    kj, kt = int(jr.iterations), int(tr.iterations)
    assert abs(kt - kj) <= spread
    xj, xt = np.asarray(jr.x), tr.x.numpy()
    assert np.max(np.abs(xj - xt) / np.maximum(1.0, np.abs(xj))) < 1e-6
    assert float(tr.objective) == pytest.approx(float(jr.objective), rel=1e-8)
    k = min(kj, kt)
    for key in ("objective", "residual", "step"):
        a = np.asarray(jr.extra["trace"][key])
        b = tr.extra["trace"][key].numpy()
        assert np.isnan(b[kt:]).all() and not np.isnan(b[:kt]).any()
        # Where the counts agree the iterates agree too; the end games of
        # simple and afiro part by more than rounding (see LOOP_CASES).
        if spread == 0:
            np.testing.assert_allclose(b[:k], a[:k], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tr.extra["trace"]["objective"].numpy()[:k],
                               np.asarray(jr.extra["trace"]["objective"])[:k],
                               rtol=1e-6)
    if name == "afiro":
        assert float(tr.objective) == pytest.approx(OPTIMUM, rel=1e-6)


def test_jax_afiro_count_moves_with_its_start():
    """The witness for LOOP_CASES' afiro spread: the JAX package's own f64
    loop on afiro stops at another iteration when each start entry moves
    by one ulp, at the same optimum."""
    jlp, _ = _lps("afiro", pad=16)
    js = jaff.make_affine_state(jlp)
    cfg = jaff.AffineConfig(max_iters=600)
    moved = np.where(np.asarray(jlp.col_mask),
                     np.nextafter(np.array(js.x), np.inf), np.array(js.x))
    r0 = jaff.affine_scaling(js, cfg)
    r1 = jaff.affine_scaling(jaff.AffineState(x=jnp.asarray(moved), lp=js.lp), cfg)
    assert r0.status_name == r1.status_name == "optimal"
    assert int(r1.iterations) != int(r0.iterations)
    for r in (r0, r1):
        assert float(r.objective) == pytest.approx(OPTIMUM, rel=1e-6)


def test_affine_f32_afiro_stops_at_its_floor():
    """f32 afiro, rows equilibrated: the iterate floor within 2e-3 of the
    optimum (f32 iteration counts follow the summation order, so none is
    asserted)."""
    from cholesky_is_magic_tpu_torch.ingest.device import to_device_lp as t_lp

    sf = cimt.rescale_sf(_sfs("afiro")[1])
    lp = t_lp(sf, pad_multiple=16, dtype=torch.float32, device="cpu")
    res = taff.affine_scaling(taff.make_affine_state(lp),
                              taff.AffineConfig(max_iters=600, refine_steps=2))
    assert res.status_name == "optimal"
    assert float(res.objective) == pytest.approx(OPTIMUM, rel=2e-3)


@pytest.mark.parametrize("name", ["sparse1", "afiro"])
def test_sparse_affine_matches(name):
    jsf, tsf = _sfs(name)
    jst, jeng = jaff.make_affine_state_sparse(jsf, block=16, dtype=jnp.float64)
    tst, teng = taff.make_affine_state_sparse(tsf, block=16, dtype=torch.float64,
                                              device="cpu")
    for a, b in ((jst.x, tst.x), (jst.lp.l, tst.lp.l), (jst.lp.u, tst.lp.u),
                 (jst.lp.b, tst.lp.b), (jst.lp.c, tst.lp.c)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jr = jaff.affine_scaling(jst, jaff.AffineConfig(max_iters=200), engine=jeng)
    before = dict(dd_cuda.LAUNCHES)
    tr = taff.affine_scaling(tst, taff.AffineConfig(max_iters=200), engine=teng)
    assert dd_cuda.LAUNCHES == before  # CPU tensors take the plain path
    assert tr.status_name == jr.status_name == "optimal"
    assert int(tr.iterations) == int(jr.iterations)
    assert float(tr.objective) == pytest.approx(float(jr.objective), rel=1e-8)
    if name == "afiro":
        assert float(tr.objective) == pytest.approx(OPTIMUM, rel=1e-4)
    else:
        # Same algebra as the dense path, same trajectory (JAX :178).
        lp = convert.device_lp_from_numpy(
            to_device_lp(jsf, pad_multiple=16, dtype=jnp.float64), device="cpu")
        td = taff.affine_scaling(taff.make_affine_state(lp))
        assert int(td.iterations) == int(tr.iterations)


def test_solve_affine_summary_matches_jax():
    rj = cim.solve(AFIRO, "affine", dtype=jnp.float64, pad_multiple=16)
    rt = cimt.solve(AFIRO, "affine", dtype=torch.float64, device="cpu",
                    pad_multiple=16)
    assert set(rt.summary) == set(rj.summary) == {
        "status", "objective", "iterations", "residual"}
    assert rt.summary["status"] == rj.summary["status"] == "optimal"
    # afiro's count follows rounding in its end game (LOOP_CASES).
    assert abs(rt.summary["iterations"] - rj.summary["iterations"]) <= 1
    assert rt.summary["objective"] == pytest.approx(rj.summary["objective"],
                                                    rel=1e-8)
    assert rt.summary["residual"] == pytest.approx(rj.summary["residual"],
                                                   abs=1e-10)
    assert rt.objective == pytest.approx(OPTIMUM, rel=1e-6)
    assert "y" not in rt.solution and "gap_bound" not in rt.summary
    np.testing.assert_allclose(rt.solution["x"], rj.solution["x"], atol=1e-6)
    assert isinstance(rt.sf, TSF)


def test_sparse_affine_f32_constructed_lp_matches_jax():
    """Sparse f32 at block 16 on the m = 256 constructed LP: both packages
    stop optimal within 1e-4 of the optimum known by construction (f32
    counts follow the summation order, so none is asserted)."""
    from cholesky_is_magic_tpu.utils.testing import constructed_optimum_lp as j_lp
    from cholesky_is_magic_tpu_torch.utils.testing import constructed_optimum_lp as t_lp

    jsf, info = j_lp(m=256, seed=0)
    tsf, tinfo = t_lp(m=256, seed=0)
    assert tinfo["objective"] == info["objective"]
    jst, jeng = jaff.make_affine_state_sparse(jsf, block=16, dtype=jnp.float32)
    tst, teng = taff.make_affine_state_sparse(tsf, block=16, dtype=torch.float32,
                                              device="cpu")
    np.testing.assert_array_equal(np.asarray(jst.x), tst.x.numpy())
    jr = jaff.affine_scaling(jst, engine=jeng)
    tr = taff.affine_scaling(tst, engine=teng)
    ref = info["objective"]
    assert tr.status_name == jr.status_name == "optimal"
    for r in (jr, tr):
        assert float(r.objective) == pytest.approx(ref, rel=1e-4)


def _sparse_runs(m, seed, block, bits=32, jax_starts=(0.0,)):
    """The fully sparse affine solve of ``constructed_optimum_lp(m, seed)``
    at ``block`` in float``bits``: the JAX package's from its start moved
    one ulp toward each of ``jax_starts`` (0.0: not moved), and the port's.  Each
    run as (status, iterations, repair steps, objective error by iteration,
    final objective error), errors relative to the optimum known by
    construction."""
    from cholesky_is_magic_tpu.utils.testing import constructed_optimum_lp as j_lp
    from cholesky_is_magic_tpu_torch.utils.testing import constructed_optimum_lp as t_lp

    jsf, info = j_lp(m=m, seed=seed)
    tsf, _ = t_lp(m=m, seed=seed)
    ref = info["objective"]

    def summary(r):
        k = int(r.iterations)
        trace = r.extra["trace"]
        repairs = int(np.sum(np.asarray(trace["residual"])[:k] > 1e-6 * m))
        err = np.abs(np.asarray(trace["objective"], np.float64)[:k] - ref) / abs(ref)
        return (r.status_name, k, repairs, err,
                abs(float(r.objective) - ref) / abs(ref))

    jdt, tdt = (jnp.float32, torch.float32) if bits == 32 else (jnp.float64, torch.float64)
    jst, jeng = jaff.make_affine_state_sparse(jsf, block=block, dtype=jdt)
    jcfg = jaff.AffineConfig(record_trace=True)
    jax_runs = []
    for toward in jax_starts:
        x = np.array(jst.x)
        if toward:
            x = np.nextafter(x, x.dtype.type(toward))
        st = jaff.AffineState(x=jnp.asarray(x), lp=jst.lp)
        jax_runs.append(summary(jaff.affine_scaling(st, jcfg, engine=jeng)))
    tst, teng = taff.make_affine_state_sparse(tsf, block=block, dtype=tdt, device="cpu")
    port = summary(taff.affine_scaling(tst, taff.AffineConfig(record_trace=True),
                                       engine=teng))
    return jax_runs, port


# How far the port's f32 sparse iteration and repair counts may lie from
# JAX's.  Both packages reach the end game (objective error ~1e-3) together;
# there an optimize step and a repair step alternate until an optimize step
# reads g·c > 0 in f32 noise, so the count follows rounding: the JAX
# package's own count at m = 2048 goes 27 -> 29 from a start one ulp higher.
F32_SPREAD = 4


def test_sparse_affine_f32_count_follows_jax():
    """f32, block 128, the m = 2048 constructed LP (the JAX package: 27
    iterations, 10 repair steps): both optimal within 1e-4; the objective
    errors within 10% of each other while JAX's is above 1e-3; the counts
    within F32_SPREAD; JAX's own count moves with its start."""
    (j0, j1), port = _sparse_runs(2048, 0, 128, jax_starts=(0.0, np.inf))
    assert port[0] == j0[0] == j1[0] == "optimal"
    assert j1[1] != j0[1]
    assert abs(port[1] - j0[1]) <= F32_SPREAD
    assert abs(port[2] - j0[2]) <= F32_SPREAD
    approach = int(np.argmax(j0[3] < 1e-3))
    assert approach >= 10
    np.testing.assert_allclose(port[3][:approach], j0[3][:approach], rtol=0.1)
    for r in (j0, j1, port):
        assert r[4] <= 1e-4



def test_sparse_affine_f64_constructed_lp_takes_jax_counts():
    """f64, block 128, the m = 2048 constructed LP: JAX's iteration and
    repair counts (24 and 3), the objective error by iteration within 10% of
    JAX's, the final one within 1e-8 of JAX's and below 1e-7."""
    (j,), port = _sparse_runs(2048, 0, 128, bits=64)
    assert port[0] == j[0] == "optimal"
    assert port[1:3] == j[1:3]
    np.testing.assert_allclose(port[3], j[3], rtol=0.1)
    assert abs(port[4] - j[4]) <= 1e-8
    assert max(port[4], j[4]) <= 1e-7

if __name__ == "__main__":
    import sys

    import jax

    assert jax.config.jax_enable_x64, "run with JAX_ENABLE_X64=1, as conftest does"
    for spec in sys.argv[1:]:
        m, seed, block, bits = map(int, spec.split(","))
        runs, port = _sparse_runs(m, seed, block, bits, (0.0, np.inf, -np.inf))
        for tag, r in zip(("JAX", "JAX +1 ulp", "JAX -1 ulp", "port"), runs + [port]):
            print(f"m={m} seed={seed} block={block} f{bits} {tag}: {r[0]}, {r[1]} iterations,"
                  f" {r[2]} repair steps, objective error {r[4]:.3e}")
        ej, et = runs[0][3], port[3]
        k = min(len(ej), len(et))
        apart = np.abs(et[:k] - ej[:k]) > 0.1 * ej[:k]
        print(f"  errors within 10% of JAX's to iteration {int(np.argmax(apart)) if apart.any() else k}")
        for tag, e in (("JAX", ej), ("port", et)):
            print(f"  {tag} objective error by iteration: " + " ".join(f"{v:.1e}" for v in e))
