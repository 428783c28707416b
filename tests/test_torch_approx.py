"""The port's APPROX (solvers/approx.py), held against the JAX package.

Both packages take the same inputs: the JAX package's operands, carried
across as NumPy by ``convert``, and iterates drawn from a numpy seed.

- ``make_approx_selfdual`` (host NumPy in both): bit-equal fields;
- the complementarity scatter: bit-equal to ``.at[].add`` with repeated
  indices, in f32 and f64;
- ``make_alm_subproblem`` dense and ELL / block-ELL, ``value_and_gradient``,
  ``quad_violations``, ``projected_gradient_norm``,
  ``complementarity_violation`` and ``dual_value`` at seeded iterates: within
  1e-12 relative in f64 (the products sum in another order);
- ``approx`` in f64: the same iteration count, x within 1e-6;
- the chunked loop at one iteration a chunk: bit-equal to the default chunk;
- ``_approx_dd`` on dense and block-ELL f32 operands at a fixed budget
  (accuracy 0): z within 1e-6 relative of JAX's.
"""

import dataclasses
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cholesky_is_magic_tpu as cim
from cholesky_is_magic_tpu.ingest import to_device_lp as j_to_device_lp
from cholesky_is_magic_tpu.ingest.device import to_sparse_lp as j_to_sparse_lp
from cholesky_is_magic_tpu.ingest.mps import read_mps_string
from cholesky_is_magic_tpu.ops import dd as jddm
from cholesky_is_magic_tpu.utils.testing import random_lp, write_mps
from cholesky_is_magic_tpu_torch import convert
from cholesky_is_magic_tpu_torch.ops import dd as tddm

japprox = importlib.import_module("cholesky_is_magic_tpu.solvers.approx")
tapprox = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.approx")

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
REL = 1e-12  # f64 host and product arithmetic, another summation order


def _sf(name):
    if name == "random":
        ineq = random_lp(7, n_ub=24, n_eq=8, n=48, density=0.3)
        return cim.to_standard_form(read_mps_string(write_mps(ineq)))
    return cim.to_standard_form(cim.read_mps_file(os.path.join(FIXTURES, name)))


def _dense(name, pad=8, dtype=jnp.float64):
    jlp = j_to_device_lp(_sf(name), pad_multiple=pad, dtype=dtype)
    return jlp, convert.device_lp_from_numpy(jlp, device="cpu")


def _sparse(name, frac=1.0, dtype=jnp.float64):
    jlp = j_to_sparse_lp(_sf(name), dtype=dtype, bell_max_dense_frac=frac)
    return jlp, convert.sparse_lp_from_numpy(jlp, device="cpu")


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _close(t, j, rel=REL):
    t, j = _np(t), _np(j)
    scale = max(float(np.max(np.abs(j), initial=0.0)), 1e-300)
    assert t.shape == j.shape
    assert float(np.max(np.abs(t - j), initial=0.0)) <= rel * scale


_FIELDS = ("q", "s", "beta", "c_lin", "nu", "l", "u", "z0",
           "comp_a0", "comp_b0", "comp_sign")


@pytest.mark.parametrize("name,kw", [
    ("simple.mps", dict(complementarity=True, pad_multiple=8)),
    ("simple.mps", dict(complementarity=False, pad_multiple=8)),
    ("simple.mps", dict(l1_penalty=0.1, pad_multiple=8)),
    ("simple.mps", dict(complementarity=True, scale=False)),
    ("afiro.mps", dict(complementarity=True, pad_multiple=16)),
    ("afiro.mps", dict(complementarity=False, l1_penalty=0.5)),
])
def test_make_approx_selfdual_is_bit_equal(name, kw):
    jlp, tlp = _dense(name)
    jp = japprox.make_approx_selfdual(jlp, **kw)
    tp = tapprox.make_approx_selfdual(tlp, **kw)
    assert (tp.n_quads, tp.n_vars) == (jp.n_quads, jp.n_vars)
    assert tp.QB is None and tp.QTB is None
    np.testing.assert_array_equal(_np(tp.Q), np.asarray(jp.Q))
    for f in _FIELDS:
        np.testing.assert_array_equal(_np(getattr(tp, f)), np.asarray(getattr(jp, f)))
        assert getattr(tp, f).dtype == torch.float64
    for f in ("comp_a", "comp_b"):
        np.testing.assert_array_equal(_np(getattr(tp, f)), np.asarray(getattr(jp, f)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_complementarity_scatter_is_the_sequential_sum(dtype):
    """g.at[idx].add(vals) with indices repeated up to 12 times and values
    over 16 decades, where the order of the sums shows in the bits."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        idx = rng.integers(0, 5, size=40)
        vals = (rng.normal(size=40) * 10.0 ** rng.integers(-8, 8, size=40)).astype(dtype)
        g0 = rng.normal(size=5).astype(dtype)
        want = np.asarray(jnp.asarray(g0).at[jnp.asarray(idx, jnp.int32)].add(vals))
        got = tapprox._scatter_add(torch.from_numpy(g0), torch.from_numpy(idx),
                                   torch.from_numpy(vals),
                                   tapprox._occurrence_passes(idx, "cpu"))
        np.testing.assert_array_equal(got.numpy(), want)


def _subproblems(kind, name, seed=0):
    """(JAX problem, port problem) of the ALM subproblem at a seeded lam."""
    rng = np.random.default_rng(seed)
    if kind == "dense":
        jlp, tlp = _dense(name)
    else:
        jlp, tlp = _sparse(name, frac=1e4 if kind == "bell" else 0.0)
        assert (jlp.EB is not None) == (kind == "bell") == (tlp.EB is not None)
    lam = rng.normal(size=np.asarray(jlp.b).shape)
    mu = 37.5
    jp = japprox.make_alm_subproblem(jlp, jnp.asarray(lam), mu)
    tp = tapprox.make_alm_subproblem(tlp, torch.from_numpy(lam), mu)
    return jp, tp, rng


@pytest.mark.parametrize("kind", ["dense", "ell", "bell"])
@pytest.mark.parametrize("name", ["simple.mps", "random"])
def test_alm_subproblem_and_its_terms_match(kind, name):
    jp, tp, rng = _subproblems(kind, name)
    for f in ("q", "s", "beta", "c_lin", "nu", "l", "u", "z0"):
        _close(getattr(tp, f), getattr(jp, f))
    # Seeded iterates, in and out of the box.
    for _ in range(3):
        v = rng.normal(size=np.asarray(jp.c_lin).shape) * 3.0
        g_off = rng.normal(size=v.shape)
        jv, tv = jnp.asarray(v), torch.from_numpy(v)
        jval, jg, jmax = japprox.value_and_gradient(jp, jv)
        tval, tg, tmax = tapprox.value_and_gradient(tp, tv)
        _close(tval, jval)
        _close(tg, jg)
        _close(tmax, jmax)
        _close(tapprox.quad_violations(tp, tv), japprox.quad_violations(jp, jv))
        _close(tapprox.dual_value(tp, tv), japprox.dual_value(jp, jv))
        _close(tapprox.projected_gradient_norm(tp, tv, torch.from_numpy(g_off)),
               japprox.projected_gradient_norm(jp, jv, jnp.asarray(g_off)))
        np.testing.assert_array_equal(_np(tapprox.project_box(tp, tv)),
                                      np.asarray(japprox.project_box(jp, jv)))


@pytest.mark.parametrize("name", ["simple.mps", "afiro.mps"])
def test_selfdual_terms_match(name):
    jlp, tlp = _dense(name)
    jp = japprox.make_approx_selfdual(jlp, complementarity=True, pad_multiple=8)
    tp = convert.approx_problem_from_numpy(jp, device="cpu")
    assert tp.comp_a.shape[0] > 0 and len(tp.comp_a_passes) >= 1
    rng = np.random.default_rng(1)
    for _ in range(3):
        v = rng.normal(size=np.asarray(jp.c_lin).shape)
        jv, tv = jnp.asarray(v), torch.from_numpy(v)
        for jt, tt in zip(japprox.value_and_gradient(jp, jv),
                          tapprox.value_and_gradient(tp, tv)):
            _close(tt, jt)
        _close(tapprox.complementarity_violation(tp, tv),
               japprox.complementarity_violation(jp, jv))
        # The step itself is elementwise: bit-equal.
        theta = 0.37
        g = rng.normal(size=v.shape) * (rng.random(v.shape) < 0.8)
        args = (np.asarray(jp.nu), theta, g, np.asarray(jp.l), np.asarray(jp.u))
        np.testing.assert_array_equal(
            _np(tapprox._solve_coordinate(tv, *(torch.tensor(a, dtype=torch.float64)
                                                for a in args))),
            np.asarray(japprox._solve_coordinate(jv, *(jnp.asarray(a) for a in args))))


def test_approx_takes_jax_counts_in_f64():
    """selfdual(simple) at the front door's settings (JAX: 119 iterations)
    and simple's ALM subproblem at lam = 0: the same iteration count, x
    within 1e-6."""
    jlp, tlp = _dense("simple.mps")
    for build, kw in (
        (lambda mod, lp: mod.make_approx_selfdual(lp, complementarity=True),
         dict(max_iters=1_000_000, accuracy=1e-9)),
        (lambda mod, lp: mod.make_alm_subproblem(lp, 0.0 * lp.b, 10.0),
         dict(max_iters=20_000, accuracy=1e-7)),
    ):
        jr = japprox.approx(build(japprox, jlp), **kw)
        tr = tapprox.approx(build(tapprox, tlp), **kw)
        assert int(tr.iterations) == int(jr.iterations)
        assert tr.slots >= int(tr.iterations)
        np.testing.assert_allclose(_np(tr.x), np.asarray(jr.x), atol=1e-6)
        _close(tr.pg, jr.pg, rel=1e-4)
        assert float(tr.value) == pytest.approx(float(jr.value), rel=1e-10, abs=1e-14)
    # No budget: no iteration, as the while_loop's cond fails at once.
    r = tapprox.approx(build(tapprox, tlp), 0)
    assert int(r.iterations) == r.slots == 0 and float(r.pg) == np.inf


@pytest.mark.parametrize("chunk", [1, 5])
def test_chunked_loop_is_bit_equal_to_other_chunk_lengths(monkeypatch, chunk):
    """The stop test is read once per chunk and every iteration is masked,
    so the chunk length changes neither the iterate nor the count, in the
    f64 driver nor in the double-word one."""
    jlp, tlp = _dense("simple.mps")
    prob = tapprox.make_approx_selfdual(tlp, complementarity=True)
    _, dlp = _dense("random", dtype=jnp.float32)
    dprob = tapprox.make_alm_subproblem(dlp, torch.zeros_like(dlp.b), 100.0)
    x0 = tddm.dd_from(torch.zeros_like(dlp.c))

    def run():
        r = tapprox.approx(prob, 1_000_000, accuracy=1e-9)
        d = tapprox._approx_dd(dlp, dprob, torch.zeros_like(dlp.b), 100.0, x0,
                               torch.tensor(4.0, dtype=torch.float32), 300)
        return r, d

    r0, d0 = run()
    monkeypatch.setattr(tapprox, "_CHUNK", chunk)
    r1, d1 = run()
    assert int(r1.iterations) == int(r0.iterations) == 119
    np.testing.assert_array_equal(_np(r1.x), _np(r0.x))
    np.testing.assert_array_equal(_np(r1.pg), _np(r0.pg))
    np.testing.assert_array_equal(_np(r1.value), _np(r0.value))
    assert int(d1[2]) == int(d0[2]) < 300
    for a, b in ((d1[0].hi, d0[0].hi), (d1[0].lo, d0[0].lo), (d1[1], d0[1]),
                 (d1[3].hi, d0[3].hi)):
        np.testing.assert_array_equal(_np(a), _np(b))
    # One iteration a chunk runs no masked iteration; a longer chunk may.
    assert r1.slots >= int(r1.iterations) and (chunk > 1 or r1.slots == 119)


@pytest.mark.parametrize("kind", ["dense", "bell"])
def test_approx_dd_matches_jax_at_a_fixed_budget(kind):
    """f32 operands, accuracy 0 (never met): 200 iterations in both
    packages; z within 1e-6 relative of JAX's, r_z and pg beside it."""
    if kind == "dense":
        jlp, tlp = _dense("random", dtype=jnp.float32)
    else:
        jlp, tlp = _sparse("random", frac=8.0, dtype=jnp.float32)
    rng = np.random.default_rng(5)
    lam = (rng.normal(size=np.asarray(jlp.b).shape) * 0.1).astype(np.float32)
    x0 = rng.normal(size=np.asarray(jlp.c).shape).astype(np.float32)
    mu = 100.0
    jp = japprox.make_alm_subproblem(jlp, jnp.asarray(lam), mu)
    tp = tapprox.make_alm_subproblem(tlp, torch.from_numpy(lam), mu)
    jz, jpg, jit, jr = japprox._approx_dd(
        jlp, jp, jnp.asarray(lam), jnp.asarray(mu, jnp.float32),
        jddm.dd_from(jnp.asarray(x0)), jnp.asarray(0.0, jnp.float32), 200)
    tz, tpg, tit, tr, ran = tapprox._approx_dd(
        tlp, tp, torch.from_numpy(lam), torch.tensor(mu, dtype=torch.float32),
        tddm.dd_from(torch.from_numpy(x0)), torch.tensor(0.0), 200)
    assert int(tit) == int(jit) == ran == 200
    z_j = np.asarray(jz.hi, np.float64) + np.asarray(jz.lo, np.float64)
    z_t = _np(tz.hi).astype(np.float64) + _np(tz.lo).astype(np.float64)
    _close(z_t, z_j, rel=1e-6)
    r_j = np.asarray(jr.hi, np.float64) + np.asarray(jr.lo, np.float64)
    r_t = _np(tr.hi).astype(np.float64) + _np(tr.lo).astype(np.float64)
    assert np.max(np.abs(r_t - r_j)) <= 1e-5 * max(1.0, np.max(np.abs(r_j)))
    assert float(tpg) == pytest.approx(float(jpg), rel=1e-3)


def test_dd_ops_need_block_ell_operands():
    jlp, tlp = _sparse("random", frac=0.0, dtype=jnp.float32)
    assert jlp.EB is None and tlp.EB is None
    for mod, lp in ((japprox, jlp), (tapprox, tlp)):
        with pytest.raises(ValueError, match="block-ELL"):
            mod._dd_ops(lp)
    # The ELL products serve the f32 subproblem all the same.
    tp = tapprox.make_alm_subproblem(tlp, torch.zeros_like(tlp.b), 10.0)
    assert tp.QB is None and tp.QTB is None
    bad = dataclasses.replace(tlp, EB=_sparse("random", frac=8.0)[1].ETB)
    with pytest.raises(ValueError, match="EB shape"):
        tapprox.make_alm_subproblem(bad, torch.zeros_like(tlp.b), 10.0)
