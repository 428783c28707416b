"""The port's fully sparse pipeline (SparseKKTLP + ELL / block-ELL products
+ the pair-schedule tile engine), held against the JAX package in f64.

- ``make_pdas_sparse`` builds equal states, operands and engines;
- ``pdas(engine=...)`` and ``pdas_dd(engine=...)``, started from the same
  state, give the same status and iteration count, and every recorded
  pre-step iterate x within 1e-6 (relative to max(1, |x|));
- ``solve(afiro, "pdas_dd", sparse=True, block=16)`` reaches JAX's
  objective within 1e-8 and the published optimum within 1e-6.

No dense (m, n) operand exists anywhere on this path."""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cholesky_is_magic_tpu as cim
import cholesky_is_magic_tpu_torch as cimt
from cholesky_is_magic_tpu.ingest.mps import read_mps_string as j_read
from cholesky_is_magic_tpu.ops import dd as jddm
from cholesky_is_magic_tpu.utils.testing import (
    constructed_optimum_lp,
    random_lp,
    write_mps,
)
from cholesky_is_magic_tpu_torch.ingest.device import SparseKKTLP
from cholesky_is_magic_tpu_torch.ingest.mps import read_mps_string as t_read
from cholesky_is_magic_tpu_torch.ops.dd import DD
from cholesky_is_magic_tpu_torch.sparse import tiled_cuda
from cholesky_is_magic_tpu_torch.utils.testing import (
    constructed_optimum_lp as t_constructed_optimum_lp,
)

# The solver modules (their packages re-export functions of the same name).
jpdas = importlib.import_module("cholesky_is_magic_tpu.solvers.pdas")
jdd = importlib.import_module("cholesky_is_magic_tpu.solvers.pdas_dd")
tpdas = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas")
tdd = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas_dd")

torch.set_num_threads(1)

AFIRO = os.path.join(os.path.dirname(__file__), "fixtures", "afiro.mps")
OPTIMUM = -464.75314285714285


def _sfs(name):
    """The same LP as the JAX and the port StandardForm."""
    if name == "co64":
        return (constructed_optimum_lp(m=64, seed=0)[0],
                t_constructed_optimum_lp(m=64, seed=0)[0])
    if name == "afiro":
        text = open(AFIRO).read()
    else:
        text = write_mps(random_lp(int(name[3:]), n_ub=24, n_eq=6, n=32,
                                   bounded=True))
    return (cim.to_standard_form(j_read(text)),
            cimt.to_standard_form(t_read(text)))


def _states(name, block=16):
    sj, st = _sfs(name)
    jst, jeng = jpdas.make_pdas_sparse(sj, block=block, dtype=jnp.float64)
    tst, teng = tpdas.make_pdas_sparse(st, block=block, dtype=torch.float64,
                                       device="cpu")
    return jst, jeng, tst, teng


@pytest.mark.parametrize("name", ["afiro", "rlp2"])
def test_make_pdas_sparse_states_equal(name):
    jst, jeng, tst, teng = _states(name)
    assert isinstance(tst.lp, SparseKKTLP)
    for f in ("x", "y", "w", "z"):
        np.testing.assert_array_equal(np.asarray(getattr(jst, f)),
                                      getattr(tst, f).numpy())
    for f in ("c", "b", "l", "u", "row_mask", "col_mask"):
        np.testing.assert_array_equal(np.asarray(getattr(jst.lp, f)),
                                      getattr(tst.lp, f).numpy())
    assert (tst.lp.m, tst.lp.n) == (jst.lp.m, jst.lp.n)
    for f, parts in (("E", ("indices", "values")), ("ET", ("indices", "values")),
                     ("EB", ("blocks", "bcols")), ("ETB", ("blocks", "bcols"))):
        a, b = getattr(jst.lp, f), getattr(tst.lp, f)
        assert (a is None) == (b is None)
        for p in parts if a is not None else ():
            np.testing.assert_array_equal(np.asarray(getattr(a, p)),
                                          getattr(b, p).numpy())
    assert (teng.B, teng.NT, teng.n_pairs) == (jeng.B, jeng.NT, jeng.n_pairs)
    np.testing.assert_array_equal(np.asarray(jeng.asm_w), teng.asm_w.numpy())


def _dd_start(jst, phase1_x, y, w, z):
    """The JAX dd finisher state from phase-1 iterates (mu-recentered
    duals), and the same state carried to the port's operand set."""
    w, z = jdd.mu_recentered_duals(jnp.asarray(phase1_x), jst.lp.l, jst.lp.u,
                                   jnp.asarray(w), jnp.asarray(z),
                                   jst.lp.col_mask)
    vals = [np.asarray(v) for v in (phase1_x, y, w, z)]
    jdd_st = jdd.PDASDDState(*(jddm.dd_from(jnp.asarray(v)) for v in vals),
                             lp=jst.lp)
    to_dd = lambda v: DD(torch.tensor(v), torch.zeros(v.shape,  # noqa: E731
                                                      dtype=torch.float64))
    return jdd_st, [to_dd(v) for v in vals]


def _same_trajectory(jr, tr, key_lo=None):
    assert tr.status_name == jr.status_name
    k = int(jr.iterations)
    assert int(tr.iterations) == k
    xj = np.asarray(jr.extra["trace"]["x"], np.float64)[:k]
    xt = tr.extra["trace"]["x"].numpy().astype(np.float64)[:k]
    if key_lo:
        xj = xj + np.asarray(jr.extra["trace"][key_lo], np.float64)[:k]
        xt = xt + tr.extra["trace"][key_lo].numpy().astype(np.float64)[:k]
    scale = np.maximum(1.0, np.abs(xj).max(axis=1, keepdims=True))
    assert np.all(np.abs(xj - xt) / scale < 1e-6)


@pytest.mark.parametrize("name,mehrotra", [("rlp2", False), ("rlp4", False),
                                           ("co64", True)])
def test_sparse_pdas_and_pdas_dd_trajectories_match(name, mehrotra):
    jst, jeng, tst, teng = _states(name)
    kw = dict(max_iters=300, refine_steps=2, record_iterates=True,
              mehrotra=mehrotra)
    before = dict(tiled_cuda.LAUNCHES)
    jr = jpdas.pdas(jst, jpdas.PDASConfig(**kw), engine=jeng)
    tr = tpdas.pdas(tst, tpdas.PDASConfig(**kw), engine=teng)
    _same_trajectory(jr, tr)
    assert float(tr.objective) == pytest.approx(float(jr.objective), rel=1e-8)

    jdd_st, tvals = _dd_start(jst, jr.x, jr.extra["y"], jr.extra["w"],
                              jr.extra["z"])
    tdd_st = tdd.PDASDDState(*tvals, lp=tst.lp)
    kw.update(gap_tol=1e-9)
    jr2 = jdd.pdas_dd(jdd_st, jpdas.PDASConfig(**kw), engine=jeng)
    tr2 = tdd.pdas_dd(tdd_st, tpdas.PDASConfig(**kw), engine=teng)
    _same_trajectory(jr2, tr2, key_lo="x_lo")
    assert tr2.status_name == "optimal"
    assert float(tr2.objective) == pytest.approx(float(jr2.objective),
                                                 rel=1e-10)
    assert tiled_cuda.LAUNCHES == before  # CPU tensors take the plain path


def test_solve_afiro_sparse_matches_jax_and_the_published_optimum():
    kw = dict(sparse=True, block=16)
    rj = cim.solve(AFIRO, "pdas_dd", dtype=jnp.float64, **kw)
    rt = cimt.solve(AFIRO, "pdas_dd", dtype=torch.float64, device="cpu", **kw)
    assert rt.status == rj.status == "optimal"
    assert rt.objective == pytest.approx(rj.objective, rel=1e-8)
    assert rt.objective == pytest.approx(OPTIMUM, rel=1e-6)
    for key in ("iterations", "phase1_iterations"):
        assert rt.summary[key] == rj.summary[key]
    assert rt.summary["gap_bound"] == pytest.approx(rj.summary["gap_bound"],
                                                    rel=1e-3)
    np.testing.assert_allclose(rt.solution["y"], rj.solution["y"], atol=1e-6)
    # Warm restart on the sparse path: phase 1 is skipped.
    rw = cimt.solve(AFIRO, "pdas_dd", dtype=torch.float64, warm=rt,
                     device="cpu", **kw)
    assert rw.summary["phase1_iterations"] == 0
    assert rw.objective == pytest.approx(OPTIMUM, rel=1e-6)


def test_solve_sparse_pdas_and_the_engine_contract():
    rt = cimt.solve(AFIRO, "pdas", sparse=True, block=16, dtype=torch.float64,
                    device="cpu")
    assert rt.status == "optimal"
    assert rt.objective == pytest.approx(OPTIMUM, rel=1e-3)
    _, st = _sfs("afiro")
    tst, teng = tpdas.make_pdas_sparse(st, block=16, dtype=torch.float64,
                                       device="cpu")
    with pytest.raises(ValueError, match="engine"):
        tpdas.pdas(tst)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tpdas.pdas(tst, engine=teng, mesh=object())
