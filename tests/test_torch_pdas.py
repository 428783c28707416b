"""The port's pdas loop, held against the JAX package in f64.

Both solvers start from the bit-identical state (the JAX make_pdas state
carried over by ``convert.pdas_state_from_numpy``) and must give the same
status, the same iteration count, and every recorded pre-step iterate x
within 1e-6 (BASELINE.md's trajectory metric, relative to max(1, |x|)).
The construction helpers (make_pdas with warm/blend/push, the violation,
objectives and ratio tests) are held to 1e-12 relative."""

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
tpdas = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas")

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


def _cfg_pair(**kw):
    return jpdas.PDASConfig(**kw), tpdas.PDASConfig(**kw)


@pytest.mark.parametrize("mehrotra", [False, True])
@pytest.mark.parametrize("name", ["afiro", "co64"])
def test_pdas_trajectory_matches(name, mehrotra):
    lp = _lp(name)
    jst = jpdas.make_pdas(lp)
    tst = convert.pdas_state_from_numpy(jst)
    jcfg, tcfg = _cfg_pair(max_iters=300, record_iterates=True,
                           mehrotra=mehrotra)
    jr, tr = jpdas.pdas(jst, jcfg), tpdas.pdas(tst, tcfg)
    assert tr.status_name == jr.status_name == "optimal"
    k = int(jr.iterations)
    assert int(tr.iterations) == k
    xj = np.asarray(jr.extra["trace"]["x"])[:k]
    xt = tr.extra["trace"]["x"].numpy()[:k]
    scale = np.maximum(1.0, np.abs(xj).max(axis=1, keepdims=True))
    assert np.all(np.abs(xj - xt) / scale < 1e-6)
    for key in ("gap", "objective", "step"):
        a = np.asarray(jr.extra["trace"][key])[:k]
        b = tr.extra["trace"][key].numpy()[:k]
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-9)
    assert float(tr.objective) == pytest.approx(float(jr.objective), rel=1e-8)
    assert float(tr.extra["gap"]) == pytest.approx(float(jr.extra["gap"]),
                                                   rel=1e-4, abs=1e-12)


def test_make_pdas_and_helpers_match():
    lp = _lp("afiro")
    tlp = convert.device_lp_from_numpy(lp)
    rng = np.random.default_rng(0)
    jst, tst = jpdas.make_pdas(lp), tpdas.make_pdas(tlp)
    for f in ("x", "y", "w", "z"):
        _close(getattr(jst, f), getattr(tst, f))
    for f in ("A", "b", "l", "u"):
        _close(getattr(jst.lp, f), getattr(tst.lp, f))
    n, m = jst.x.shape[0], jst.y.shape[0]
    warm = [rng.normal(size=n), rng.normal(size=m), rng.random(n), rng.random(n)]
    jw = jpdas.PDASState(*map(jnp.asarray, warm), lp=None)
    tw = tpdas.PDASState(*map(torch.from_numpy, warm), lp=None)
    for kw in (dict(), dict(warm_blend=0.2), dict(warm_push=1e-2)):
        a = jpdas.make_pdas(lp, warm=jw, **kw)
        b = tpdas.make_pdas(tlp, warm=tw, **kw)
        for f in ("x", "y", "w", "z"):
            _close(getattr(a, f), getattr(b, f))
    jst = jpdas.PDASState(jnp.asarray(warm[0]), jnp.asarray(warm[1]),
                          jnp.asarray(warm[2]), jnp.asarray(warm[3]), lp=jst.lp)
    tst = convert.pdas_state_from_numpy(jst)
    for a, b in zip(jpdas._violation(jst), tpdas._violation(tst)):
        _close(a, b)
    for a, b in zip(jpdas._objectives(jst), tpdas._objectives(tst)):
        _close(a, b)
    sl, su, dx = rng.random(n), rng.random(n), rng.normal(size=n)
    dx[:4] = 0.0
    _close(jpdas._box_step(*map(jnp.asarray, (sl, su, dx))),
           tpdas._box_step(*map(torch.from_numpy, (sl, su, dx))))
    _close(jpdas._pos_step(*map(jnp.asarray, (sl, dx))),
           tpdas._pos_step(*map(torch.from_numpy, (sl, dx))))
    mask = rng.random(n) < 0.8
    args = (warm[0], jst.lp.l, jst.lp.u, mask)
    _close(jpdas.push_interior(*map(jnp.asarray, args), 1e-2),
           tpdas.push_interior(*map(torch.from_numpy, map(np.array, args)), 1e-2))


def test_unported_options_raise():
    lp = convert.device_lp_from_numpy(_lp("afiro"))
    st = tpdas.make_pdas(lp)
    with pytest.raises(NotImplementedError):
        tpdas.pdas(st, tpdas.PDASConfig(mehrotra=True, gondzio_correctors=1))
    with pytest.raises(NotImplementedError):
        tpdas.pdas(st, engine=object())
    with pytest.raises(NotImplementedError):
        tpdas.pdas(st, mesh=object())
    with pytest.raises(NotImplementedError):
        tpdas.pdas(st, tpdas.PDASConfig(factor_method="inverse", max_iters=1))
