"""Gondzio's multiple centrality correctors (``gondzio_correctors``) in the
port's pdas and pdas_dd loops and in their batched loops, held against the
JAX package in f64 on the CPU.

- pdas_dd (the double-word rendering) and pdas (the f32 one, with the
  production bounce exit) with ``gondzio_correctors=2`` on the LPs of
  tests/test_pdas_dd.py::TestGondzio take JAX's status and iteration
  count, every recorded iterate within 1e-6 (ROADMAP's trajectory bar);
- ``batched_pdas`` and ``batched_pdas_dd`` with the correctors: every lane
  takes its single solve's status and count, x within 1e-12 (the accept
  step is a per-lane select with no host read).  A batch of dense states
  on a dense-A engine is held in tests/test_torch_dense_engine_batch.py.

JAX's compile of the dd loop with its correctors is most of the cost, so
each JAX solve runs once."""

import importlib

import jax.numpy as jnp
import numpy as np
import torch

import cholesky_is_magic_tpu as cim
from cholesky_is_magic_tpu.ingest import to_device_lp
from cholesky_is_magic_tpu.ingest.mps import read_mps_string
from cholesky_is_magic_tpu.utils.testing import random_lp, write_mps
from cholesky_is_magic_tpu_torch import convert, parallel
from cholesky_is_magic_tpu_torch.utils import lanes

jpdas = importlib.import_module("cholesky_is_magic_tpu.solvers.pdas")
tpdas = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas")
jdd = importlib.import_module("cholesky_is_magic_tpu.solvers.pdas_dd")
tdd = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas_dd")

torch.set_num_threads(1)

# tests/test_pdas_dd.py::TestGondzio's configurations (record_iterates
# added): the dd test's, and the f32 end-game test's bounce-exit one.
DD_KW = dict(max_iters=300, gap_tol=1e-8, refine_steps=2, mehrotra=True,
             gondzio_correctors=2, record_iterates=True)
F_KW = dict(DD_KW, stall_exit_iters=12, bounce_exit_ratio=25.0)
SEEDS = [2, 3, 5]


def _lp(seed):
    ineq = random_lp(seed, n_ub=24, n_eq=6, n=32, bounded=True)
    sf = cim.to_standard_form(read_mps_string(write_mps(ineq)))
    return to_device_lp(sf, pad_multiple=16, dtype=jnp.float64)


def _assert_trajectories(jr, tr):
    assert tr.status_name == jr.status_name == "optimal"
    k = int(jr.iterations)
    assert int(tr.iterations) == k
    trace_j, trace_t = jr.extra["trace"], tr.extra["trace"]
    xj = np.asarray(trace_j["x"], np.float64)[:k]
    xt = trace_t["x"].numpy().astype(np.float64)[:k]
    if "x_lo" in trace_j:
        xj = xj + np.asarray(trace_j["x_lo"], np.float64)[:k]
        xt = xt + trace_t["x_lo"].numpy().astype(np.float64)[:k]
    scale = np.maximum(1.0, np.abs(xj).max(axis=1, keepdims=True))
    assert np.all(np.abs(xj - xt) / scale < 1e-6)


def test_pdas_dd_correctors_match():
    jst = jdd.make_pdas_dd(_lp(2))
    tst = convert.pdas_dd_state_from_numpy(jst, device="cpu")
    jr = jdd.pdas_dd(jst, jpdas.PDASConfig(**DD_KW))
    tr = tdd.pdas_dd(tst, tpdas.PDASConfig(**DD_KW))
    _assert_trajectories(jr, tr)
    assert float(tr.extra["gap"]) < 1e-7
    # The correctors changed the path: plain Mehrotra takes more.
    plain = tdd.pdas_dd(tst, tpdas.PDASConfig(**dict(DD_KW, gondzio_correctors=0)))
    assert int(plain.iterations) > int(tr.iterations)


def test_pdas_correctors_match():
    jst = jpdas.make_pdas(_lp(3))
    tst = convert.pdas_state_from_numpy(jst, device="cpu")
    jr = jpdas.pdas(jst, jpdas.PDASConfig(**F_KW))
    tr = tpdas.pdas(tst, tpdas.PDASConfig(**F_KW))
    _assert_trajectories(jr, tr)


def _assert_lane_is_its_solve(tr, k, one):
    assert int(one.status) == int(tr.status[k])
    assert int(one.iterations) == int(tr.iterations[k])
    np.testing.assert_allclose(tr.x[k].numpy(), one.x.numpy(), atol=1e-12)


def test_batched_loops_take_the_correctors():
    tl = [convert.device_lp_from_numpy(_lp(s), device="cpu") for s in SEEDS]
    cfg = tpdas.PDASConfig(**dict(F_KW, record_iterates=False))
    states = [tpdas.make_pdas(lp) for lp in tl]
    tr = parallel.batched_pdas(parallel.stack_states(states), cfg)
    for k, st in enumerate(states):
        _assert_lane_is_its_solve(tr, k, tpdas.pdas(st, cfg))
    dd_cfg = tpdas.PDASConfig(**dict(DD_KW, record_iterates=False))
    dd_states = [tdd.make_pdas_dd(lp, warm=lanes.lane(tr, k)) for k, lp in enumerate(tl)]
    trd = parallel.batched_pdas_dd(parallel.stack_states(dd_states), dd_cfg)
    assert (trd.status.numpy() == 1).all()
    for k, st in enumerate(dd_states):
        _assert_lane_is_its_solve(trd, k, tdd.pdas_dd(st, dd_cfg))
