"""The port's ALM family (solvers/alm.py), held against the JAX package.

Both packages start from the same operands (the JAX package's, carried
across by ``convert``):

- ``alm``, ``aalm``, ``adcd`` and ``alm_iteration`` in f64 on simple.mps:
  the same outer and inner counts, value and violation within 1e-8
  relative, the final projected gradient within 1e-4, x within 1e-6;
  ``record_trace``'s series within 1e-8;
- ``make_alm``'s state: bit-equal bounds, mu, omega, nu;
- the ELL / block-ELL operands (``SparseLP``) against the dense ones
  (TestSparseALM): the same value within 1e-6;
- the double-word driver (TestALMDD): the dense cold start meets the JAX
  test's own bars in f32 (violation and pg < 1e-5, value within 1e-3 of
  scipy's), and the sparse two-phase protocol at a bounded budget: the dd
  phase lands below the f32 phase's violation, as in JAX's run of the
  same budget;
- ``dd_gradient`` without block-ELL operands raises the JAX package's
  ValueError.
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
from cholesky_is_magic_tpu.utils.testing import (
    random_lp,
    scipy_reference_solution,
    write_mps,
)
from cholesky_is_magic_tpu_torch import convert
from cholesky_is_magic_tpu_torch.ingest.device import to_sparse_lp as t_to_sparse_lp
from cholesky_is_magic_tpu_torch.ingest.standard_form import (
    to_standard_form as t_to_standard_form,
)
from cholesky_is_magic_tpu_torch.ingest.mps import read_mps_file as t_read_mps_file

jalm = importlib.import_module("cholesky_is_magic_tpu.solvers.alm")
talm = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.alm")

torch.set_num_threads(1)

SIMPLE = os.path.join(os.path.dirname(__file__), "fixtures", "simple.mps")
REL = 1e-8  # f64 values after the same iterations


def _simple(dtype=jnp.float64, pad=8):
    sf = cim.to_standard_form(cim.read_mps_file(SIMPLE))
    jlp = j_to_device_lp(sf, pad_multiple=pad, dtype=dtype)
    return jlp, convert.device_lp_from_numpy(jlp, device="cpu")


def _random(seed, dtype=jnp.float32, **kw):
    ineq = random_lp(seed, **kw)
    status, fun, _ = scipy_reference_solution(ineq)
    assert status == 0
    return cim.to_standard_form(read_mps_string(write_mps(ineq))), fun


def _same(tr, jr, rel=REL):
    """Two ALMResults: the same counts, values within ``rel``."""
    assert int(tr.outer_iterations) == int(jr.outer_iterations)
    assert int(tr.inner_iterations) == int(jr.inner_iterations)
    for key in ("value", "violation"):
        assert float(getattr(tr, key)) == pytest.approx(float(getattr(jr, key)),
                                                        rel=rel, abs=1e-14)
    # The inner projected gradient at the stop is a difference of O(1)
    # gradient terms: ulp-level changes of the iterate move it ~1e-6.
    assert float(tr.pg) == pytest.approx(float(jr.pg), rel=1e-4)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), atol=1e-6)
    np.testing.assert_allclose(tr.multipliers.numpy(), np.asarray(jr.multipliers),
                               rtol=1e-6, atol=1e-8)


@pytest.fixture(scope="module")
def simple64():
    return _simple()


def test_make_alm_state_is_bit_equal(simple64):
    jlp, tlp = simple64
    for kw in (dict(), dict(mu=100.0)):
        js, ts = jalm.make_alm(jlp, **kw), talm.make_alm(tlp, **kw)
        for f in ("mu", "omega", "nu", "multipliers", "mult_l", "mult_u"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)))
    ts2 = convert.alm_state_from_numpy(js, device="cpu")
    assert ts2.lp.m == tlp.m and float(ts2.mu) == 100.0


@pytest.mark.parametrize("driver,cfg", [
    ("alm", dict(inner_iters=50_000, max_outer=100, record_trace=True)),
    ("aalm", dict(inner_iters=50_000, max_outer=100)),
    ("adcd", dict(max_outer=100)),
])
def test_drivers_take_jax_counts_in_f64(simple64, driver, cfg):
    """TestALM's drivers on simple.mps (JAX: alm 5 / 77 at pad 16 through
    the front door; here pad 8)."""
    jlp, tlp = simple64
    jr = getattr(jalm, driver)(jalm.make_alm(jlp), config=jalm.ALMConfig(**cfg))
    tr = getattr(talm, driver)(talm.make_alm(tlp), config=talm.ALMConfig(**cfg))
    _same(tr, jr)
    assert float(tr.value) == pytest.approx(-7.0, abs=5e-2)
    if driver != "adcd":
        assert tr.inner_slots >= int(tr.inner_iterations)
    if cfg.get("record_trace"):
        k = int(jr.outer_iterations)
        for key in ("violation", "mu", "pg", "value"):
            np.testing.assert_allclose(tr.trace[key][:k].numpy(),
                                       np.asarray(jr.trace[key])[:k], rtol=REL)
            assert np.isnan(tr.trace[key][k:].numpy()).all()


def test_warm_restart_from_multipliers_matches_jax(simple64):
    """TestALM.test_warm_start_multipliers: make_alm with prior multipliers
    and mu = 100, restarted from the solved x."""
    jlp, tlp = simple64
    cfg = dict(inner_iters=50_000, max_outer=100)
    j1 = jalm.alm(jalm.make_alm(jlp), config=jalm.ALMConfig(**cfg))
    t1 = talm.alm(talm.make_alm(tlp), config=talm.ALMConfig(**cfg))
    j2 = jalm.alm(jalm.make_alm(jlp, mu=100.0, multipliers=j1.multipliers),
                  x0=j1.x, config=jalm.ALMConfig(**cfg))
    t2 = talm.alm(talm.make_alm(tlp, mu=100.0, multipliers=t1.multipliers),
                  x0=t1.x, config=talm.ALMConfig(**cfg))
    _same(t2, j2)
    assert int(t2.outer_iterations) <= int(t1.outer_iterations)


def test_v1_lancelot_iteration_matches_jax_step_by_step(simple64):
    jlp, tlp = simple64
    js, ts = jalm.make_alm(jlp), talm.make_alm(tlp)
    jx, tx = jnp.zeros_like(jlp.c), torch.zeros_like(tlp.c)
    for _ in range(12):
        js, jx, jviol, jval = jalm.alm_iteration(js, jx)
        ts, tx, tviol, tval = talm.alm_iteration(ts, tx)
        assert float(tval) == pytest.approx(float(jval), rel=REL)
        np.testing.assert_allclose(tviol.numpy(), np.asarray(jviol), atol=1e-9)
        for f in ("mu", "nu", "omega"):
            assert float(getattr(ts, f)) == pytest.approx(float(getattr(js, f)), rel=REL)
    assert float(torch.max(torch.abs(tviol))) < 1e-3
    assert float(tval) == pytest.approx(-7.0, abs=1e-2)


def test_adcd_iteration_matches_jax(simple64):
    jlp, tlp = simple64
    js, ts = jalm.make_alm(jlp), talm.make_alm(tlp)
    jx, tx = jnp.zeros_like(jlp.c), torch.zeros_like(tlp.c)
    for step in range(100):
        has_x = step > 0
        js, jx, jdone, jpg = jalm.adcd_iteration(js, jx, jnp.asarray(has_x))
        ts, tx, tdone, tpg = talm.adcd_iteration(ts, tx, has_x)
        assert bool(tdone) == bool(jdone)
        assert float(tpg) == pytest.approx(float(jpg), rel=1e-6)
        if bool(jdone):
            break
    assert bool(tdone)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6)


def test_ell_alm_matches_dense():
    """TestSparseALM: the ELL operands give the dense value within 1e-6
    (and both give the JAX package's sparse counts)."""
    sf_j = cim.to_standard_form(cim.read_mps_file(SIMPLE))
    sf_t = t_to_standard_form(t_read_mps_file(SIMPLE))
    _, dense = _simple()
    sparse = t_to_sparse_lp(sf_t, dtype=torch.float64, device="cpu")
    assert sparse.EB is None and sparse.ETB is None  # the byte gate rejects
    cfg = talm.ALMConfig(inner_iters=50_000, max_outer=100)
    r_dense = talm.alm(talm.make_alm(dense), config=cfg)
    r_sparse = talm.alm(talm.make_alm(sparse), config=cfg)
    assert float(r_sparse.value) == pytest.approx(float(r_dense.value), abs=1e-6)
    assert float(r_sparse.violation) < 1e-5
    jr = jalm.alm(jalm.make_alm(j_to_sparse_lp(sf_j, dtype=jnp.float64)),
                  config=jalm.ALMConfig(inner_iters=50_000, max_outer=100))
    _same(r_sparse, jr)
    # The block-ELL renderings, where the gate lets them through.
    bell = t_to_sparse_lp(sf_t, dtype=torch.float64, device="cpu",
                          bell_max_dense_frac=1e4)
    assert bell.EB is not None and bell.ETB is not None
    r_bell = talm.alm(talm.make_alm(bell), config=cfg)
    assert float(r_bell.value) == pytest.approx(float(r_dense.value), abs=1e-6)


def test_dd_gradient_dense_cold_start():
    """TestALMDD.test_dd_gradient_dense_path in f32 (JAX: 9 / 609), held
    to that test's own bars."""
    sf, fun = _random(2)
    jlp = j_to_device_lp(sf, pad_multiple=8, dtype=jnp.float32)
    tlp = convert.device_lp_from_numpy(jlp, device="cpu")
    kw = dict(max_outer=40, inner_iters=10_000, violation_tol=1e-5, pg_tol=1e-5,
              omega_floor=1e-7, dd_gradient=True)
    res = talm.alm(talm.make_alm(tlp), config=talm.ALMConfig(**kw))
    assert float(res.violation) < 1e-5
    assert float(res.pg) < 1e-5
    assert float(res.value) == pytest.approx(fun, rel=1e-3, abs=1e-3)
    assert res.x.dtype == torch.float32
    assert res.inner_slots >= int(res.inner_iterations)


def test_dd_gradient_sparse_two_phase_at_a_bounded_budget():
    """TestALMDD's two-phase protocol on block-ELL f32 operands, at a
    budget the CPU runs in seconds (JAX's unbounded run: 30 / 224514 then
    5 / 14941): an f32 phase, then the dd phase warm-started from its
    multipliers with mu reset to 100.  Both packages run the same budget;
    the dd phase must not be a no-op, in either: it lands below the f32
    phase's violation.  At this budget the f32 phase has not reached its
    floor, so the projected gradient is not compared across phases."""
    sf, fun = _random(7, n_ub=24, n_eq=8, n=48, density=0.3)
    jlp = j_to_sparse_lp(sf, dtype=jnp.float32, bell_max_dense_frac=8.0)
    tlp = convert.sparse_lp_from_numpy(jlp, device="cpu")
    assert tlp.EB is not None and tlp.ETB is not None
    kwA = dict(max_outer=6, inner_iters=400, violation_tol=1e-5, pg_tol=1e-5,
               omega_floor=1e-6)
    kwB = dict(kwA, dd_gradient=True, omega_floor=1e-7, max_outer=3)
    out = {}
    for name, mod, lp in (("jax", jalm, jlp), ("port", talm, tlp)):
        resA = mod.alm(mod.make_alm(lp), config=mod.ALMConfig(**kwA))
        resB = mod.alm(mod.make_alm(lp, mu=100.0, multipliers=resA.multipliers),
                       x0=resA.x, config=mod.ALMConfig(**kwB))
        out[name] = [float(r) for r in (resA.pg, resA.violation, resB.pg,
                                        resB.violation, resB.value)]
        assert int(resB.outer_iterations) == 3
    for pgA, vA, pgB, vB, value in out.values():
        assert vB < vA and np.isfinite(pgB)
        assert value == pytest.approx(fun, rel=1e-3)
    # The port's f32 phase follows JAX's violation within 5% (f32 sums in
    # another order), and its dd phase reaches 1e-4.
    assert out["port"][1] == pytest.approx(out["jax"][1], rel=5e-2)
    assert out["port"][3] < 1e-4


def test_dd_gradient_requires_block_ell_operands():
    sf, _ = _random(3, n_ub=24, n_eq=8, n=48, density=0.3)
    jlp = j_to_sparse_lp(sf, dtype=jnp.float32, bell_max_dense_frac=0.0)
    tlp = convert.sparse_lp_from_numpy(jlp, device="cpu")
    assert jlp.EB is None and tlp.EB is None
    for mod, lp in ((jalm, jlp), (talm, tlp)):
        with pytest.raises(ValueError, match="block-ELL"):
            mod.alm(mod.make_alm(lp), config=mod.ALMConfig(dd_gradient=True))


def test_f32_alm_stays_f32_and_configs_match():
    """The port's ALMConfig is the JAX package's, field for field; an f32
    solve keeps its iterate and multipliers in f32."""
    assert ([(f.name, f.default) for f in dataclasses.fields(talm.ALMConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(jalm.ALMConfig)])
    _, tlp = _simple(dtype=jnp.float32)
    res = talm.alm(talm.make_alm(tlp), config=talm.ALMConfig(
        violation_tol=1e-4, pg_tol=1e-4, omega_floor=1e-4, inner_iters=50_000))
    assert res.x.dtype == res.multipliers.dtype == torch.float32
    assert float(res.violation) < 1e-4
    assert float(res.value) == pytest.approx(-7.0, abs=1e-2)
