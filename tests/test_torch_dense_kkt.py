"""The port's dense normal equations, Krylov refinement, KKT elimination,
backend seam and affine helpers, held against the JAX package in f64.

Tolerance: 1e-12 relative (ROADMAP: host code and double-word arithmetic
bit-equal or <= 1e-12 relative in f64).  The factorizations and triangular
solves are two different LAPACK/BLAS call paths (XLA's and PyTorch's), so
results agree to a small multiple of cond·eps, not bit for bit; the
problems below have cond(N) <= ~1e3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cholesky_is_magic_tpu.kkt import newton as jkkt
from cholesky_is_magic_tpu.ops import dense as jdense
from cholesky_is_magic_tpu.ops import krylov as jkrylov
from cholesky_is_magic_tpu import sparse as jsparse
from cholesky_is_magic_tpu.solvers import affine as jaff
from cholesky_is_magic_tpu.sparse import tiled as jtiled
from cholesky_is_magic_tpu_torch.ingest.device import DeviceLP
from cholesky_is_magic_tpu_torch.kkt import newton as tkkt
from cholesky_is_magic_tpu_torch.ops import dense as tdense
from cholesky_is_magic_tpu_torch.ops import krylov as tkrylov
from cholesky_is_magic_tpu_torch.solvers import affine as taff
from cholesky_is_magic_tpu_torch.solvers import backend as tbackend
from cholesky_is_magic_tpu_torch import sparse as tsparse

torch.set_num_threads(1)

RTOL = 1e-12


def _pair(v):
    v = np.asarray(v)
    return jnp.asarray(v), torch.from_numpy(v.copy())


def _close(j, t, rtol=RTOL):
    a = np.asarray(j, np.float64)
    b = t.detach().numpy().astype(np.float64)
    scale = max(1.0, float(np.max(np.abs(a), initial=0.0)))
    assert a.shape == b.shape
    assert float(np.max(np.abs(a - b), initial=0.0)) <= rtol * scale


def _normal_problem(seed, m=24, n=40, pad_rows=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    if pad_rows:
        A[m - pad_rows:] = 0.0
    d = rng.random(n) + 0.5
    g = rng.normal(size=m)
    boost = np.zeros(m)
    if pad_rows:
        boost[m - pad_rows:] = 1.0
        g[m - pad_rows:] = 0.0
    return A, d, g, boost


def test_normal_matrix_and_factor():
    A, d, _g, boost = _normal_problem(0, pad_rows=3)
    (jA, tA), (jd, td), (jb, tb) = _pair(A), _pair(d), _pair(boost)
    jN, tN = jdense.normal_matrix(jA, jd, jb), tdense.normal_matrix(tA, td, tb)
    _close(jN, tN)
    jf, tf = jdense.factorize(jN), tdense.factorize(tN)
    assert bool(jf.ok) and bool(tf.ok)
    _close(jf.L, tf.L)
    _close(jdense.rcond_estimate(jf.L), tdense.rcond_estimate(tf.L))
    (jr, tr) = _pair(np.random.default_rng(1).normal(size=A.shape[0]))
    _close(jdense.chol_solve(jf.L, jr), tdense.chol_solve(tf.L, tr))
    jx, jok = jdense.solve_spd(jN, jr, refine_steps=2)
    tx, tok = tdense.solve_spd(tN, tr, refine_steps=2)
    assert bool(jok) and bool(tok)
    _close(jx, tx)


@pytest.mark.parametrize("N", [np.zeros((8, 8)), -np.eye(6),
                               np.diag([1.0, 2.0, -1e-3, 4.0])])
def test_non_pd_gives_ok_false_and_identity(N):
    """torch's cholesky_ex returns a partial factor that can look finite:
    ok must come from info as well (JAX maps its NaN factor to ok=False)."""
    (jN, tN) = _pair(N)
    jf, tf = jdense.factorize(jN), tdense.factorize(tN)
    assert not bool(jf.ok) and not bool(tf.ok)
    np.testing.assert_array_equal(tf.L.numpy(), np.eye(N.shape[0]))
    x, ok = tdense.solve_spd(tN, torch.ones(N.shape[0], dtype=tN.dtype))
    assert not bool(ok) and torch.all(x == 0)


@pytest.mark.parametrize("true_residual", [False, True])
@pytest.mark.parametrize("singular", [False, True])
def test_prepare_normal_matches(singular, true_residual):
    """prepare_normal with and without the dbound retry (a rank-deficient
    N fails the plain factor and succeeds jittered), refined against the
    assembled N or the unassembled operator."""
    A, d, g, boost = _normal_problem(2, pad_rows=2)
    if singular:
        A = np.vstack([A[:6], A[:6]])
        d, g, boost = d, g[:12], np.zeros(12)
    (jA, tA), (jd, td), (jg, tg), (jb, tb) = map(_pair, (A, d, g, boost))
    kw = dict(refine_steps=2, true_residual=true_residual, dbound=1e-5)
    jfn, jok = jdense.prepare_normal(jA, jd, row_boost=jb, **kw)
    tfn, tok = tdense.prepare_normal(tA, td, row_boost=tb, **kw)
    assert bool(jok) and bool(tok)
    _close(jfn(jg), tfn(tg), rtol=1e-9 if singular else RTOL)
    _close(jdense.operator_residual(jA * jd, jfn(jg), jg, jb),
           tdense.operator_residual(tA * td, tfn(tg), tg, tb),
           rtol=1e-9 if singular else RTOL)
    _, jok0 = jdense.solve_normal(jA, jd, jg, row_boost=jb, refine_steps=0)
    _, tok0 = tdense.solve_normal(tA, td, tg, row_boost=tb, refine_steps=0)
    assert bool(jok0) == bool(tok0) == (not singular)


@pytest.mark.parametrize("gate", [None, True, False])
def test_krylov_refinement_matches(gate):
    A, d, g, boost = _normal_problem(3, pad_rows=2)
    (jA, tA), (jd, td), (jg, tg), (jb, tb) = map(_pair, (A, d, g, boost))
    kw = dict(refine_steps=1, true_residual=True, krylov_steps=4)
    jfn, _ = jdense.prepare_normal(
        jA, jd, row_boost=jb, krylov_gate=None if gate is None else jnp.asarray(gate), **kw)
    tfn, _ = tdense.prepare_normal(
        tA, td, row_boost=tb, krylov_gate=None if gate is None else torch.tensor(gate), **kw)
    _close(jfn(jg), tfn(tg))
    AD = A * d
    jres = jkrylov.dense_residual_dd(jA * jd, jg, jb)
    tres = tkrylov.dense_residual_dd(tA * td, tg, tb)
    from cholesky_is_magic_tpu.ops.dd import dd_from as jfrom
    from cholesky_is_magic_tpu_torch.ops.dd import dd_from as tfrom

    (jx, tx) = _pair(np.linalg.solve(AD @ AD.T + np.diag(boost), g))
    _close(jres(jfrom(jx)), tres(tfrom(tx)))
    _close(jkrylov.dense_normal_apply(jA * jd, jb)(jg),
           tkrylov.dense_normal_apply(tA * td, tb)(tg))


def test_inverse_method_is_not_ported():
    """The name predates the port of ``method="inverse"`` (held against the
    JAX package in tests/test_torch_batched.py); a method that neither
    package has raises."""
    A, d, _g, _b = _normal_problem(4)
    with pytest.raises(ValueError):
        tdense.prepare_normal(torch.from_numpy(A), torch.from_numpy(d),
                              method="cholmod")


def _kkt_inputs(seed, m=20, n=36):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)) * (rng.random((m, n)) < 0.3)
    A[np.arange(m), np.arange(m)] += 2.0
    pos = lambda k: 0.1 + rng.random(k)
    sl, su, w, z = pos(n), pos(n), pos(n), pos(n)
    su[:3] = 1e8  # filtered upper bounds (FILTER_THRESHOLD)
    sl[3:5] = 1e8
    e, f, g, h = rng.random(n), rng.random(n), rng.random(m), rng.random(n)
    return A, (sl, su, w, z), (e, f, g, h)


@pytest.mark.parametrize("seed", [0, 1])
def test_kkt_newton_matches(seed):
    A, vec, rhs = _kkt_inputs(seed)
    (jA, tA) = _pair(A)
    jv, tv = zip(*map(_pair, vec))
    jr, tr = zip(*map(_pair, rhs))
    jred = jkkt.kkt_reduce(*jv, *jr[:2], jr[3])
    tred = tkkt.kkt_reduce(*tv, *tr[:2], tr[3])
    for a, b in zip(jred, tred):
        if a.dtype == jnp.bool_:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        else:
            _close(a, b)
    jop = jkkt.dense_kkt_operator(jA, refine_steps=2)
    top = tkkt.dense_kkt_operator(tA, refine_steps=2)
    jd = jkkt.solve_kkt_newton(*jv, jop, *jr)
    td = tkkt.solve_kkt_newton(*tv, top, *tr)
    for a, b in zip(jd[:4], td[:4]):
        _close(a, b)
    assert bool(jd.ok) and bool(td.ok)
    _close(jkkt.kkt_residuals(*jv, jop, *jr, jd),
           tkkt.kkt_residuals(*tv, top, *tr, td), rtol=1e-9)
    y = np.random.default_rng(seed + 7).normal(size=A.shape[0])
    (jy, ty) = _pair(y)
    jb = jkkt.kkt_backsub(jred, *jv, *jr[:2], jy, jA.T @ jy, jd.ok)
    tb = tkkt.kkt_backsub(tred, *tv, *tr[:2], ty, tA.T @ ty, td.ok)
    for a, b in zip(jb[:4], tb[:4]):
        _close(a, b)
    assert tkkt.FILTER_THRESHOLD == jkkt.FILTER_THRESHOLD


def _unfiltered_kkt_inputs(seed, m=24, n=40):
    """tests/test_sparse_ops.py:70-85's system: every bound present (no
    filtered row), so every block residual of an exact solve is rounding."""
    rng = np.random.default_rng(seed)
    A = (rng.random((m, n)) < 0.1) * rng.normal(size=(m, n))
    A[np.arange(m), np.arange(m)] += 2.0
    pos = lambda k: 0.1 + 10 * rng.random(k)  # noqa: E731
    vec = (pos(n), pos(n), pos(n), pos(n))
    rhs = (rng.random(n), rng.random(n), rng.random(m), rng.random(n))
    return A, vec, rhs


def _engines(A, kind, block=8):
    """The same sparse engine of A's pattern in both packages."""
    import scipy.sparse as sp

    if kind == "tiled":
        return (jtiled.engine_for(A, block=block),
                tsparse.engine_for(A, block=block, device="cpu"))
    plan = lambda mod: mod.analyze(sp.csc_matrix(A), block=block, use_native=False)  # noqa: E731
    return (jsparse.BlockSparseCholesky(plan(jsparse)),
            tsparse.BlockSparseCholesky(plan(tsparse), device="cpu"))


@pytest.mark.parametrize("refine_steps", [0, 2])
@pytest.mark.parametrize("kind", ["tiled", "block_sparse"])
def test_sparse_kkt_operator_matches(kind, refine_steps):
    """The KKT elimination over a sparse engine of the dense A
    (tests/test_sparse_ops.py:68-95): the deltas within 1e-10 of JAX's and
    every block residual below 1e-8."""
    A, vec, rhs = _unfiltered_kkt_inputs(4)
    jA, tA = _pair(A)
    jv, tv = zip(*map(_pair, vec))
    jr, tr = zip(*map(_pair, rhs))
    je, te = _engines(A, kind)
    jop = jkkt.sparse_kkt_operator(jA, je, refine_steps=refine_steps)
    top = tkkt.sparse_kkt_operator(tA, te, refine_steps=refine_steps)
    jd = jkkt.solve_kkt_newton(*jv, jop, *jr)
    td = tkkt.solve_kkt_newton(*tv, top, *tr)
    assert bool(jd.ok) and bool(td.ok)
    for a, b in zip(jd[:4], td[:4]):
        _close(a, b, rtol=1e-10)
    res = tkkt.kkt_residuals(*tv, top, *tr, td)
    assert float(res.max()) < 1e-8
    _close(jkkt.kkt_residuals(*jv, jop, *jr, jd), res, rtol=1e-8)


def test_checked_newton_flags_a_zero_a():
    """solve_kkt_newton_checked (tests/test_kkt.py:131): a zero A fails
    the factorization; both packages flag it and report the same block
    residuals.  On a sound A it keeps ok and JAX's residuals."""
    n, m = 5, 3
    one = np.ones(n)
    jone, tone = _pair(one)
    jg, tg = _pair(np.ones(m))
    jA, tA = _pair(np.zeros((m, n)))
    jd, jres = jkkt.solve_kkt_newton_checked(
        jone, jone, jone, jone, jkkt.dense_kkt_operator(jA), jone, jone, jg, jone)
    td, tres = tkkt.solve_kkt_newton_checked(
        tone, tone, tone, tone, tkkt.dense_kkt_operator(tA), tone, tone, tg, tone)
    assert not bool(jd.ok) and not bool(td.ok)
    _close(jres, tres)
    A, vec, rhs = _unfiltered_kkt_inputs(5)
    jA, tA = _pair(A)
    jv, tv = zip(*map(_pair, vec))
    jr, tr = zip(*map(_pair, rhs))
    jd, jres = jkkt.solve_kkt_newton_checked(*jv, jkkt.dense_kkt_operator(jA), *jr)
    td, tres = tkkt.solve_kkt_newton_checked(*tv, tkkt.dense_kkt_operator(tA), *tr)
    assert bool(jd.ok) and bool(td.ok)
    _close(jres, tres, rtol=1e-8)
    # A tolerance below the residuals flips ok in both.
    tight = float(tres.max()) / 2
    assert not bool(jkkt.solve_kkt_newton_checked(
        *jv, jkkt.dense_kkt_operator(jA), *jr, tol=tight)[0].ok)
    assert not bool(tkkt.solve_kkt_newton_checked(
        *tv, tkkt.dense_kkt_operator(tA), *tr, tol=tight)[0].ok)


def test_backend_seam():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(6, 9))
    A[4:] = 0.0
    mask = np.arange(6) < 4
    lp = DeviceLP(
        A=torch.from_numpy(A), c=torch.zeros(9, dtype=torch.float64),
        b=torch.zeros(6, dtype=torch.float64), l=torch.zeros(9, dtype=torch.float64),
        u=torch.ones(9, dtype=torch.float64), row_mask=torch.from_numpy(mask),
        col_mask=torch.ones(9, dtype=torch.bool),
        row_type=torch.zeros(6, dtype=torch.int8), m=4, n=9,
    )
    mv, rmv = tbackend.mv_rmv(lp)
    v, u = rng.normal(size=9), rng.normal(size=6)
    np.testing.assert_allclose(mv(torch.from_numpy(v)).numpy(), A @ v, rtol=1e-14)
    np.testing.assert_allclose(rmv(torch.from_numpy(u)).numpy(), A.T @ u, rtol=1e-14)
    boost = tbackend.row_boost(lp)
    assert boost.dtype == torch.float64 and boost.tolist() == [0, 0, 0, 0, 1, 1]
    d = torch.from_numpy(rng.random(9) + 0.5)
    solve_fn, ok = tbackend.prepare_normal_backend(lp, None, d, boost, 1)
    y = solve_fn(torch.from_numpy(u))
    N = (A * d.numpy()) @ (A * d.numpy()).T + np.diag(boost.numpy())
    assert bool(ok)
    np.testing.assert_allclose(y.numpy(), np.linalg.solve(N, u), rtol=1e-10)
    # A dense state with a sparse engine of its A: the same solve by tiles.
    eng = tsparse.engine_for(A, block=4, device="cpu")
    solve_fn, ok = tbackend.prepare_normal_backend(lp, eng, d, boost, 1)
    assert bool(ok)
    np.testing.assert_allclose(solve_fn(torch.from_numpy(u)).numpy(), y.numpy(),
                               rtol=1e-10)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tbackend.prepare_normal_backend(lp, None, d, boost, 1, mesh=object())
    # The engine's per-lane form (a lane of a batch of dense states) on one
    # lane: the same solve.
    solve_fn, ok = tbackend.prepare_normal_backend(lp, eng, d, boost, 1, per_lane=True)
    assert bool(ok)
    np.testing.assert_allclose(solve_fn(torch.from_numpy(u)).numpy(), y.numpy(),
                               rtol=1e-10)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_affine_helpers_equal(dtype):
    rng = np.random.default_rng(6)
    n = 40
    l = np.where(rng.random(n) < 0.2, -1e30, -rng.random(n) * 3).astype(dtype)
    u = np.where(rng.random(n) < 0.2, 1e30, rng.random(n) * 3 + 0.5).astype(dtype)
    x = np.clip(rng.normal(size=n), l, u).astype(dtype)
    x[:3] = l[:3]  # on a bound
    g = np.where(rng.random(n) < 0.1, 0.0, rng.normal(size=n)).astype(dtype)
    mask = rng.random(n) < 0.9
    (jl, tl), (ju, tu), (jx, tx), (jg, tg), (jm, tm) = map(_pair, (l, u, x, g, mask))
    eq = lambda a, b: np.testing.assert_array_equal(np.asarray(a), b.numpy())
    eq(jaff._into_interior(jx, jl, ju, jm), taff._into_interior(tx, tl, tu, tm))
    eq(jaff._slack(jl, jx, ju, 1e4, jm), taff._slack(tl, tx, tu, 1e4, tm))
    eq(jaff._centering_direction(jl, jx, ju, jm),
       taff._centering_direction(tl, tx, tu, tm))
    eq(jaff._max_step(jl, jx, ju, jg, jm), taff._max_step(tl, tx, tu, tg, tm))
