"""The port's batched affine scaling, held against the JAX package on the CPU.

``parallel.batched_affine`` on the four LPs of
``tests/test_parallel.py::batch_of_lps([0, 2, 4, 6])`` (f64, pad 16): each
lane's status and count equal to the port's own single ``affine_scaling``
on that lane (the per-lane selects give the host branches' results), its
objective within 1e-6 relative of the JAX package's ``batched_affine``
lane; and where the two packages' single solves agree on a lane's count,
the batched counts agree too.  f64 affine counts can follow rounding in
the end game (ROADMAP.md §3), so a count where the single solves of the
two packages part is not asserted against JAX.
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
from cholesky_is_magic_tpu.parallel import batched_affine as j_batched_affine
from cholesky_is_magic_tpu.solvers import AffineConfig as JConfig
from cholesky_is_magic_tpu.solvers import affine_scaling as j_affine
from cholesky_is_magic_tpu.solvers.affine import make_affine_state as j_make
from cholesky_is_magic_tpu.utils import testing as j_testing
from cholesky_is_magic_tpu_torch import parallel
from cholesky_is_magic_tpu_torch.ingest.device import to_device_lp
from cholesky_is_magic_tpu_torch.ingest.mps import read_mps_string
from cholesky_is_magic_tpu_torch.utils import lanes

taff = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.affine")

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings("error:There is a performance drop")

SEEDS = [0, 2, 4, 6]  # tests/test_parallel.py::batch_of_lps


@pytest.fixture(scope="module")
def affine():
    texts = [j_testing.write_mps(j_testing.random_lp(s, bounded=True))
             for s in SEEDS]
    jl = [j_to_device_lp(cim.to_standard_form(j_read(t)), pad_multiple=16,
                         dtype=jnp.float64) for t in texts]
    tl = [to_device_lp(cimt.to_standard_form(read_mps_string(t)), pad_multiple=16,
                       dtype=torch.float64, device="cpu") for t in texts]
    jstates = [j_make(lp) for lp in jl]
    jcfg = JConfig(max_iters=200)
    jr = j_batched_affine(jax.tree.map(lambda *a: jnp.stack(a), *jstates), jcfg)
    jsingle = [int(j_affine(st, jcfg).iterations) for st in jstates]
    tcfg = taff.AffineConfig(max_iters=200)
    ts = parallel.stack_states([taff.make_affine_state(lp) for lp in tl])
    tr = parallel.batched_affine(ts, tcfg)
    tsingle = [taff.affine_scaling(lanes.lane(ts, k), tcfg) for k in range(len(SEEDS))]
    return dict(jr=jr, jsingle=jsingle, tr=tr, tsingle=tsingle, ts=ts, tcfg=tcfg)


def test_batched_affine_lanes_equal_their_single_solves(affine):
    """Each lane: status and count of the port's single affine_scaling, x
    within 1e-6 and the objective within 1e-8 relative.  The batched
    products round apart from the single ones by ~1e-15 after the first
    iteration, and the end game grows that about tenfold an iteration
    (~1e-8 in x at the last), so x is not compared bit for bit."""
    tr = affine["tr"]
    for k, one in enumerate(affine["tsingle"]):
        assert int(tr.status[k]) == int(one.status)
        assert int(tr.iterations[k]) == int(one.iterations)
        np.testing.assert_allclose(tr.x[k].numpy(), one.x.numpy(), atol=1e-6)
        assert float(tr.objective[k]) == pytest.approx(float(one.objective),
                                                       rel=1e-8)
        assert float(tr.residual_norm[k]) <= 1e-6 * 16


def test_batched_affine_matches_jax(affine):
    """Objectives within 1e-6 relative of the JAX package's batched lanes,
    the same statuses, and the JAX batched count wherever the two packages'
    single solves agree on it."""
    jr, tr = affine["jr"], affine["tr"]
    np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
    assert (tr.status.numpy() == 1).all()
    np.testing.assert_allclose(tr.objective.numpy(), np.asarray(jr.objective),
                               rtol=1e-6)
    agree = [k for k, one in enumerate(affine["tsingle"])
             if int(one.iterations) == affine["jsingle"][k]]
    assert agree, "no lane where the single solves agree on the count"
    for k in agree:
        assert int(tr.iterations[k]) == int(jr.iterations[k])


def test_batched_affine_trace_rows_stop_with_their_lane(affine):
    """record_trace: each lane writes its own rows, NaN after its count, as
    the single solve's trace (within 1e-8 relative and 1e-7: the rounding
    above, in a step norm that goes to zero)."""
    cfg = taff.AffineConfig(max_iters=40, record_trace=True)
    tr = parallel.batched_affine(affine["ts"], cfg)
    for k in range(len(SEEDS)):
        one = taff.affine_scaling(lanes.lane(affine["ts"], k), cfg)
        for key in ("objective", "residual", "step"):
            np.testing.assert_allclose(tr.extra["trace"][key][k].numpy(),
                                       one.extra["trace"][key].numpy(),
                                       rtol=1e-8, atol=1e-7)
        n = int(tr.iterations[k])
        assert np.isnan(tr.extra["trace"]["objective"][k, n:].numpy()).all()
