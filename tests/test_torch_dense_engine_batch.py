"""A batch of dense states on a dense-A engine, held against the JAX package.

``parallel.batched_pdas`` / ``batched_pdas_dd`` with ``engine=`` a
``sparse.engine_for(A, block=16)`` tile engine or a ``BlockSparseCholesky``
of the lanes' shared pattern, on stacked dense states (3 lanes of one
``random_lp``'s A with drifted b and c, the fleet of
``tests/test_parallel.py::TestBatchedSparseEngine.family``), in f64 on the
CPU.  The JAX package passes the engine through ``jax.vmap``
(``parallel/batched.py:88-106``); each JAX batch runs once per module and
engine.  Bars: every lane's status and iteration count equal to the JAX
package's lane, x within 1e-6 of it; every lane's count equal to the
port's single engine solve of that lane, x within 1e-9 of it.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cholesky_is_magic_tpu as cim
from cholesky_is_magic_tpu.ingest import to_device_lp as j_to_device_lp
from cholesky_is_magic_tpu.ingest.mps import read_mps_string as j_read
from cholesky_is_magic_tpu.sparse.factor import BlockSparseCholesky as JBlockSparse
from cholesky_is_magic_tpu.sparse.symbolic import analyze as j_analyze
from cholesky_is_magic_tpu.sparse.tiled import engine_for as j_engine_for
from cholesky_is_magic_tpu.utils.testing import random_lp, write_mps
from cholesky_is_magic_tpu_torch import convert, parallel
from cholesky_is_magic_tpu_torch.sparse import engine_for
from cholesky_is_magic_tpu_torch.sparse.factor import BlockSparseCholesky
from cholesky_is_magic_tpu_torch.sparse.symbolic import analyze
from cholesky_is_magic_tpu_torch.utils import lanes

jpar = importlib.import_module("cholesky_is_magic_tpu.parallel")
jpdas = importlib.import_module("cholesky_is_magic_tpu.solvers.pdas")
jdd = importlib.import_module("cholesky_is_magic_tpu.solvers.pdas_dd")
tpdas = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas")
tdd = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas_dd")

torch.set_num_threads(1)

CFG = dict(max_iters=200)
DD_CFG = dict(max_iters=300, gap_tol=1e-8, refine_steps=2)
ENGINES = ("tiled", "block_sparse")


def _fleet(k=3, seed=11):
    """k LPs that share A and differ in (b, c), as JAX DeviceLPs."""
    base = random_lp(seed, n_ub=24, n_eq=6, n=32, bounded=True)
    out = []
    for i in range(k):
        rng = np.random.default_rng(1000 + i)
        x0 = base.l + (base.u - base.l) * (0.2 + 0.6 * rng.random(32))
        lane = dataclasses.replace(
            base, b_ub=base.A_ub @ x0 + 0.05 + rng.random(base.A_ub.shape[0]),
            b_eq=base.A_eq @ x0, c=rng.normal(size=32))
        sf = cim.to_standard_form(j_read(write_mps(lane)))
        out.append(j_to_device_lp(sf, pad_multiple=16, dtype=jnp.float64))
    return out


def _engines(A: np.ndarray, device):
    """Both packages' dense-A engines of A's pattern."""
    csc = sp.csc_matrix(A)
    return {"tiled": (j_engine_for(A, block=16), engine_for(A, block=16, device=device)),
            "block_sparse": (JBlockSparse(j_analyze(csc, block=16)),
                             BlockSparseCholesky(analyze(csc, block=16), device=device))}


def _stack_j(objs):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *objs)


@pytest.fixture(scope="module")
def runs():
    """Per engine: the JAX package's and the port's batched pdas, then
    batched pdas_dd warm from those lanes, and the port's lanes."""
    jlps = _fleet()
    jst = [jpdas.make_pdas(lp) for lp in jlps]
    tst = [convert.pdas_state_from_numpy(st, device="cpu") for st in jst]
    out = {}
    for name, (jeng, teng) in _engines(np.asarray(jst[0].lp.A), "cpu").items():
        jr = jpar.batched_pdas(_stack_j(jst), jpdas.PDASConfig(**CFG), engine=jeng)
        tr = parallel.batched_pdas(parallel.stack_states(tst),
                                   tpdas.PDASConfig(**CFG), engine=teng)
        jdst = [jdd.make_pdas_dd(lp, warm=jax.tree.map(lambda a, k=k: a[k], jr))
                for k, lp in enumerate(jlps)]
        tdst = [convert.pdas_dd_state_from_numpy(st, device="cpu") for st in jdst]
        jrd = jpar.batched_pdas_dd(_stack_j(jdst), jpdas.PDASConfig(**DD_CFG),
                                   engine=jeng)
        trd = parallel.batched_pdas_dd(parallel.stack_states(tdst),
                                       tpdas.PDASConfig(**DD_CFG), engine=teng)
        out[name] = dict(engine=teng, pdas=(jr, tr, tst), pdas_dd=(jrd, trd, tdst))
    return out


def _assert_lanes_match(jr, tr):
    np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
    np.testing.assert_array_equal(tr.iterations.numpy(), np.asarray(jr.iterations))
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("phase", ["pdas", "pdas_dd"])
@pytest.mark.parametrize("name", ENGINES)
def test_lanes_match_jax_vmap(runs, name, phase):
    """Each lane of the port's batch on the engine takes the JAX package's
    vmapped lane's status and count, x within 1e-6; all lanes optimal."""
    jr, tr, _ = runs[name][phase]
    _assert_lanes_match(jr, tr)
    assert (tr.status.numpy() == 1).all()
    if phase == "pdas_dd":
        assert (tr.extra["gap"].numpy() < 1e-7).all()


@pytest.mark.parametrize("phase", ["pdas", "pdas_dd"])
@pytest.mark.parametrize("name", ENGINES)
def test_lanes_match_single_engine_solves(runs, name, phase):
    """Each lane equals the port's single solve of that lane on the same
    engine: the same status and count, x within 1e-9 (a lane's matmuls run
    batched, which may round apart from the single ones)."""
    _, tr, states = runs[name][phase]
    eng = runs[name]["engine"]
    solve = tpdas.pdas if phase == "pdas" else tdd.pdas_dd
    cfg = tpdas.PDASConfig(**(CFG if phase == "pdas" else DD_CFG))
    for k, st in enumerate(states):
        one = solve(st, cfg, engine=eng)
        assert int(one.status) == int(tr.status[k])
        assert int(one.iterations) == int(tr.iterations[k])
        np.testing.assert_allclose(tr.x[k].numpy(), one.x.numpy(), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("mode", ["range", "scan"])
def test_assembly_is_one_gather_under_vmap(mode):
    """The tile engine's dense-A assembly, both modes, is the same under
    ``torch.func.vmap`` over lanes as lane by lane (each lane's own A and
    d), bit for bit, and equal to the JAX package's assembly."""
    jlps = _fleet()
    A = np.stack([np.asarray(jpdas.make_pdas(lp).lp.A) for lp in jlps])
    d = np.random.default_rng(5).random((len(jlps), A.shape[2])) + 0.5
    jeng, teng = _engines(A[0], "cpu")["tiled"]
    At, dt = torch.as_tensor(A), torch.as_tensor(d)
    batched = lanes.vmap(lambda a, v: teng.assemble(a, v, mode=mode), At, dt)
    for k in range(len(jlps)):
        one = teng.assemble(At[k], dt[k], mode=mode)
        np.testing.assert_array_equal(batched[k].numpy(), one.numpy())
        ref = np.asarray(jeng.assemble(jnp.asarray(A[k]), jnp.asarray(d[k]), mode=mode))
        np.testing.assert_allclose(one.numpy(), ref, rtol=1e-12, atol=1e-12)
