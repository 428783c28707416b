"""The port's pdas_dd finisher loop and its pieces, held against the JAX
package in f64.

The loops start from the bit-identical state (the JAX make_pdas_dd state
after a JAX phase 1, carried by ``convert.pdas_dd_state_from_numpy``) and
must give the same status, the same iteration count, and every recorded
iterate x within 1e-6 (relative to max(1, |x|)); the dd violation,
objectives and make_pdas_dd's dual reset are held to 1e-12 relative."""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cholesky_is_magic_tpu as cim
from cholesky_is_magic_tpu.ingest import to_device_lp
from cholesky_is_magic_tpu.utils.testing import constructed_optimum_lp
from cholesky_is_magic_tpu_torch import convert

# The solver modules (their packages re-export functions of the same name).
jpdas = importlib.import_module("cholesky_is_magic_tpu.solvers.pdas")
jdd = importlib.import_module("cholesky_is_magic_tpu.solvers.pdas_dd")
tpdas = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas")
tdd = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas_dd")

torch.set_num_threads(1)

AFIRO = os.path.join(os.path.dirname(__file__), "fixtures", "afiro.mps")


def _lp(name):
    if name == "afiro":
        sf = cim.to_standard_form(cim.read_mps_file(AFIRO))
        return to_device_lp(sf, pad_multiple=16, dtype=jnp.float64)
    sf, _ = constructed_optimum_lp(m=64, seed=0)
    return to_device_lp(sf, pad_multiple=64, dtype=jnp.float64)


def _close(j, t, rtol=1e-12):
    a = np.asarray(j, np.float64)
    b = t.numpy().astype(np.float64)
    scale = max(1.0, float(np.max(np.abs(a), initial=0.0)))
    assert float(np.max(np.abs(a - b), initial=0.0)) <= rtol * scale


def _dd_pair(j, t, rtol=1e-12):
    _close(np.asarray(j.hi, np.float64) + np.asarray(j.lo, np.float64),
           t.hi + t.lo, rtol)


def _dd_start(name, **kw):
    """A JAX phase 1 (pdas to 1e-4), the JAX dd state built from it, and
    the same state carried to the port."""
    lp = _lp(name)
    phase1 = jpdas.pdas(jpdas.make_pdas(lp),
                        jpdas.PDASConfig(max_iters=300, refine_steps=2))
    jst = jdd.make_pdas_dd(lp, warm=phase1, **kw)
    return phase1, jst, convert.pdas_dd_state_from_numpy(jst)


@pytest.mark.parametrize("mehrotra", [False, True])
@pytest.mark.parametrize("name", ["afiro", "co64"])
def test_pdas_dd_trajectory_matches(name, mehrotra):
    _p1, jst, tst = _dd_start(name)
    kw = dict(max_iters=300, gap_tol=1e-9, refine_steps=2,
              record_iterates=True, mehrotra=mehrotra)
    jr = jdd.pdas_dd(jst, jpdas.PDASConfig(**kw))
    tr = tdd.pdas_dd(tst, tpdas.PDASConfig(**kw))
    assert tr.status_name == jr.status_name == "optimal"
    k = int(jr.iterations)
    assert int(tr.iterations) == k
    tj, tt = jr.extra["trace"], tr.extra["trace"]
    xj = np.asarray(tj["x"], np.float64)[:k] + np.asarray(tj["x_lo"], np.float64)[:k]
    xt = (tt["x"].numpy().astype(np.float64)[:k]
          + tt["x_lo"].numpy().astype(np.float64)[:k])
    scale = np.maximum(1.0, np.abs(xj).max(axis=1, keepdims=True))
    assert np.all(np.abs(xj - xt) / scale < 1e-6)
    assert float(tr.objective) == pytest.approx(float(jr.objective), rel=1e-10)
    assert float(tr.extra["gap"]) < 1e-9


def test_pdas_dd_pieces_match():
    phase1, jst, tst = _dd_start("afiro")
    # make_pdas_dd (with the mu dual reset) from the same phase-1 result.
    tp1 = convert.pdas_state_from_numpy(jpdas.PDASState(
        x=phase1.x, y=phase1.extra["y"], w=phase1.extra["w"],
        z=phase1.extra["z"], lp=_lp("afiro")))
    tst2 = tdd.make_pdas_dd(tp1.lp, warm=tp1)
    for f in ("x", "y", "w", "z"):
        _dd_pair(getattr(jst, f), getattr(tst2, f))
    for a, b in zip(jdd._dd_violation(jst), tdd._dd_violation(tst)):
        if isinstance(a, tuple):
            _dd_pair(a, b)
        else:
            _close(a, b)
    for a, b in zip(jdd._dd_objectives(jst), tdd._dd_objectives(tst)):
        _dd_pair(a, b)
    # Entry repair (Dikin min-norm correction), forced on.
    cfg = dict(entry_repair_tol=1e-30, entry_repair_refines=2)
    js, jp0, jp1 = jdd._entry_repair(jst, jpdas.PDASConfig(**cfg), None, None)
    ts, tp0, tp1_ = tdd._entry_repair(tst, tpdas.PDASConfig(**cfg))
    _dd_pair(js.x, ts.x, rtol=1e-10)
    _close(jp0, tp0)
    _close(jp1, tp1_, rtol=1e-6)


def test_pdas_dd_krylov_gated_matches():
    """The PCG refinement path inside the loop (gated by the gap)."""
    _p1, jst, tst = _dd_start("afiro")
    kw = dict(max_iters=6, gap_tol=1e-9, refine_steps=2, krylov_steps=3,
              krylov_gate_gap=1e-6)
    jr = jdd.pdas_dd(jst, jpdas.PDASConfig(**kw))
    tr = tdd.pdas_dd(tst, tpdas.PDASConfig(**kw))
    assert tr.status_name == jr.status_name
    assert int(tr.iterations) == int(jr.iterations)
    _close(jr.x, tr.x, rtol=1e-6)
