"""The port's front door, held against the JAX package.

``solve(afiro, "pdas_dd")`` in f64 agrees with the JAX package's within
1e-8 relative and reaches the published optimum; ``solve(afiro, "pdas")``
takes the same iterations; the unported options raise
NotImplementedError."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cholesky_is_magic_tpu as cim
import cholesky_is_magic_tpu_torch as cimt
from cholesky_is_magic_tpu_torch.ops import dd_cuda

torch.set_num_threads(1)

AFIRO = os.path.join(os.path.dirname(__file__), "fixtures", "afiro.mps")
OPTIMUM = -464.75314285714285


def test_solve_pdas_dd_matches_jax_and_the_published_optimum():
    kw = dict(pad_multiple=16)
    rj = cim.solve(AFIRO, "pdas_dd", dtype=jnp.float64, **kw)
    before = dict(dd_cuda.LAUNCHES)
    rt = cimt.solve(AFIRO, "pdas_dd", dtype=torch.float64, device="cpu", **kw)
    assert dd_cuda.LAUNCHES == before  # CPU tensors take the plain path
    assert rt.status == rj.status == "optimal"
    for key in ("objective", "dual_objective"):
        assert rt.summary[key] == pytest.approx(rj.summary[key], rel=1e-8)
    for key in ("iterations", "phase1_iterations"):
        assert rt.summary[key] == rj.summary[key]
    assert rt.summary["gap"] < 1e-9
    assert rt.objective == pytest.approx(OPTIMUM, rel=1e-8)
    assert rt.summary["gap_bound"] == pytest.approx(rj.summary["gap_bound"],
                                                    rel=1e-3)
    np.testing.assert_allclose(rt.solution["x"], rj.solution["x"], atol=1e-6)
    np.testing.assert_allclose(rt.solution["y"], rj.solution["y"], atol=1e-6)
    # Warm restart: phase 1 is skipped.
    rw = cimt.solve(AFIRO, "pdas_dd", dtype=torch.float64, warm=rt, **kw)
    assert rw.summary["phase1_iterations"] == 0
    assert rw.objective == pytest.approx(OPTIMUM, rel=1e-8)


def test_solve_pdas_matches_jax():
    kw = dict(pad_multiple=16)
    rj = cim.solve(AFIRO, "pdas", dtype=jnp.float64, **kw)
    rt = cimt.solve(AFIRO, "pdas", dtype=torch.float64, **kw)
    assert rt.status == rj.status == "optimal"
    assert rt.summary["iterations"] == rj.summary["iterations"]
    assert rt.objective == pytest.approx(rj.objective, rel=1e-8)
    assert rt.summary["gap_bound"] >= abs(rt.objective - OPTIMUM) / (1 + abs(OPTIMUM))


@pytest.mark.parametrize("kw", [dict(solver="affine"), dict(solver="alm"),
                                dict(sparse=True), dict(presolve=True),
                                dict(crossover=True)])
def test_unported_front_door_options_raise(kw):
    solver = kw.pop("solver", "pdas_dd")
    with pytest.raises(NotImplementedError):
        cimt.solve(AFIRO, solver, **kw)
