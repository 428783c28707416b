"""The port's slabbed batch loop, held against the JAX package on the CPU.

``parallel.batched_pdas_slabbed`` on the four LPs of
``tests/test_parallel.py::batch_of_lps([0, 2, 4, 6])`` (f64, pad 16): the
JAX ``TestSlabbedBatching`` cases (the plain budget, and one that no lane
can meet with the stall exit off), each lane's status and summed
iteration count equal to the JAX package's ``batched_pdas_slabbed``, the
objective within 1e-8 relative; ``solve_batch(slab_iters=16)`` against the
JAX package's on the same problem list; and the refusals.  Each JAX run
happens once per module.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cholesky_is_magic_tpu as cim
import cholesky_is_magic_tpu_torch as cimt
from cholesky_is_magic_tpu.ingest import to_device_lp as j_to_device_lp
from cholesky_is_magic_tpu.ingest.mps import read_mps_string as j_read
from cholesky_is_magic_tpu.parallel import batched_pdas_slabbed as j_slabbed
from cholesky_is_magic_tpu.solvers import PDASConfig as JConfig
from cholesky_is_magic_tpu.solvers import make_pdas as j_make_pdas
from cholesky_is_magic_tpu.utils import testing as j_testing
from cholesky_is_magic_tpu_torch import parallel
from cholesky_is_magic_tpu_torch.ingest.device import to_device_lp
from cholesky_is_magic_tpu_torch.ingest.mps import read_mps_string

tpdas = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas")

torch.set_num_threads(1)

SEEDS = [0, 2, 4, 6]  # tests/test_parallel.py::batch_of_lps
CASES = {
    "monolithic": dict(max_iters=200),
    "unreachable": dict(max_iters=120, gap_tol=1e-18, stall_exit_iters=10 ** 6),
    "budget_120": dict(max_iters=120),
}


@pytest.fixture(scope="module")
def slabbed():
    texts = [j_testing.write_mps(j_testing.random_lp(s, bounded=True))
             for s in SEEDS]
    funs = [j_testing.scipy_reference_solution(j_testing.random_lp(s, bounded=True))[1]
            for s in SEEDS]
    jl = [j_to_device_lp(cim.to_standard_form(j_read(t)), pad_multiple=16,
                         dtype=jnp.float64) for t in texts]
    tl = [to_device_lp(cimt.to_standard_form(read_mps_string(t)), pad_multiple=16,
                       dtype=torch.float64, device="cpu") for t in texts]
    js = jax.tree.map(lambda *a: jnp.stack(a), *[j_make_pdas(lp) for lp in jl])
    ts = parallel.stack_states([tpdas.make_pdas(lp) for lp in tl])
    out = {"funs": funs, "ts": ts}
    for tag, kw in CASES.items():
        out[tag] = (j_slabbed(js, JConfig(**kw), slab_iters=16),
                    parallel.batched_pdas_slabbed(ts, tpdas.PDASConfig(**kw),
                                                  slab_iters=16))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_slabbed_lanes_match_jax(slabbed, case):
    """Per-lane statuses and summed iteration counts equal to the JAX
    package's slabbed loop, objectives within 1e-8 relative; the JAX
    test's bars: every lane optimal at the plain budgets (objective within
    1e-3 of HiGHS, at most 48 iterations at the budget of 120: a slab
    granule of the lanes' own counts), and at the unreachable tolerance
    every lane runs its whole budget and no more."""
    jr, tr = slabbed[case]
    assert tr.iterations.dtype == torch.int32 and tr.iterations.shape == (4,)
    np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
    np.testing.assert_array_equal(tr.iterations.numpy(), np.asarray(jr.iterations))
    np.testing.assert_allclose(tr.objective.numpy(), np.asarray(jr.objective),
                               rtol=1e-8)
    assert not tr.x.is_cuda
    if case == "unreachable":
        assert int(tr.iterations.max()) <= 120
        return
    assert (tr.status.numpy() == 1).all()
    for i, fun in enumerate(slabbed["funs"]):
        assert float(tr.objective[i]) == pytest.approx(fun, rel=1e-3, abs=1e-3)
    if case == "budget_120":
        assert int(tr.iterations.max()) <= 48


def test_slabbed_single_slab_equals_the_plain_batch(slabbed):
    """With a slab as long as the budget and the stall window inside it,
    the slabbed loop runs one slab: the plain batched pdas, lane for lane
    (x bit for bit)."""
    cfg = tpdas.PDASConfig(max_iters=60, stall_exit_iters=40)
    plain = parallel.batched_pdas(slabbed["ts"], cfg)
    one = parallel.batched_pdas_slabbed(slabbed["ts"], cfg, slab_iters=60)
    assert torch.equal(one.iterations, plain.iterations)
    assert torch.equal(one.status, plain.status)
    assert torch.equal(one.x, plain.x)


def _texts_hetero():
    """tests/test_api.py's heterogeneous mix (see test_torch_batched.py)."""
    return [j_testing.write_mps(j_testing.random_lp(
        40 + s, n_ub=n_ub, n_eq=n_eq, n=n, density=0.5))
        for s, (n_ub, n_eq, n) in enumerate(
            [(10, 4, 20), (14, 2, 26), (4, 2, 6), (12, 4, 24)])]


def test_solve_batch_slab_iters_matches_jax():
    """solve_batch(slab_iters=16) through both packages on one problem
    list (f64, pad 16): each report's status and count equal, objective
    within 1e-8 relative; each optimal report equal to the plain
    solve_batch's within the bar of tests/test_api.py (2e-4)."""
    texts = _texts_hetero()
    kw = dict(pad_multiple=16, max_iters=200, slab_iters=16)
    jreps = cim.solve_batch([cim.to_standard_form(j_read(t)) for t in texts],
                            dtype=jnp.float64, **kw)
    tsfs = [cimt.to_standard_form(read_mps_string(t)) for t in texts]
    treps = cimt.solve_batch(tsfs, dtype=torch.float64, device="cpu", **kw)
    plain = cimt.solve_batch(tsfs, dtype=torch.float64, device="cpu",
                             pad_multiple=16, max_iters=200)
    for rj, rt, rp in zip(jreps, treps, plain):
        assert rt.status == rj.status == "optimal"
        assert rt.summary["iterations"] == rj.summary["iterations"]
        assert rt.objective == pytest.approx(rj.objective, rel=1e-8)
        assert abs(rt.objective - rp.objective) <= 2e-4 * max(1.0, abs(rp.objective))


def test_slabbed_refusals(slabbed):
    cfg = tpdas.PDASConfig(max_iters=20, record_trace=True)
    with pytest.raises(ValueError, match="trace"):
        parallel.batched_pdas_slabbed(slabbed["ts"], cfg)
    with pytest.raises(NotImplementedError, match="multi-device"):
        parallel.batched_pdas_slabbed(slabbed["ts"], mesh=object())
    with pytest.raises(NotImplementedError, match="multi-device"):
        cimt.solve_batch([], slab_iters=16, mesh=object(), device="cpu")
