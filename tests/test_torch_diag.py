"""The port's diagnostics (utils/diag.py) against the JAX package's, on the CPU.

The same numpy-seeded inputs go through both packages' functions: the
factorization report's text, the condition number and its tracker, the
checked KKT solve (its deltas, and the raise on a singular or NaN system),
the memory reports, NaN debugging and the profiler's trace.
"""

import glob
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cholesky_is_magic_tpu_torch as cimt
from cholesky_is_magic_tpu.kkt import dense_kkt_operator as j_dense_kkt_operator
from cholesky_is_magic_tpu.sparse import analyze as j_analyze
from cholesky_is_magic_tpu.utils import diag as jdiag
from cholesky_is_magic_tpu_torch.kkt import dense_kkt_operator
from cholesky_is_magic_tpu_torch.sparse import analyze
from cholesky_is_magic_tpu_torch.utils import diag
from cholesky_is_magic_tpu_torch.utils.testing import constructed_optimum_lp

SIMPLE = os.path.join(os.path.dirname(__file__), "fixtures", "simple.mps")


def _random_pattern():
    """tests/test_diag.py:13-17's matrix, at its block 8."""
    rng = np.random.default_rng(0)
    A = (rng.random((16, 24)) < 0.2) * 1.0
    A[np.arange(16), np.arange(16)] = 1.0
    return sp.csc_matrix(A), 8


def _staircase_pattern():
    """The constructed-optimum staircase at m = 96, block 16: 12 of 21 tiles."""
    sf, _ = constructed_optimum_lp(m=96, seed=0)
    return sp.csc_matrix((sf.a_vals, (sf.a_rows, sf.a_cols)),
                         shape=(sf.ncons, sf.nvars)), 16


PATTERNS = {"random 16x24": _random_pattern, "staircase 96x288": _staircase_pattern}


@pytest.mark.parametrize("use_native", [False, True], ids=["python", "native"])
@pytest.mark.parametrize("name", list(PATTERNS))
def test_factor_report_text_equals_the_jax_package(name, use_native):
    A, block = PATTERNS[name]()
    got = diag.factor_report(analyze(A, block=block, use_native=use_native))
    want = jdiag.factor_report(j_analyze(A, block=block, use_native=use_native))
    assert got == want
    assert "AA':" in got and "Factor:" in got and "Tiles:" in got


def _spd(seed, n):
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(n, n + 3))
    return B @ B.T + 10.0 ** rng.uniform(-6, 0) * np.eye(n)


def test_condition_number_and_tracker_match_the_jax_package():
    Ns = [_spd(s, n) for s, n in ((0, 8), (1, 20), (2, 5), (3, 12))]
    for N in Ns:
        got = float(diag.condition_number(torch.as_tensor(N)))
        want = float(jdiag.condition_number(jnp.asarray(N)))
        assert got == pytest.approx(want, rel=1e-10)
    tracker, jtracker = diag.WorstConditionTracker(), jdiag.WorstConditionTracker()
    seq = [tracker.update(torch.as_tensor(N)) for N in Ns]
    jseq = [jtracker.update(jnp.asarray(N)) for N in Ns]
    np.testing.assert_allclose(seq, jseq, rtol=1e-10)
    assert tracker.worst == pytest.approx(jtracker.worst, rel=1e-10)
    assert tracker.worst == pytest.approx(max(jseq), rel=1e-10)


def _kkt_system(seed, m, n):
    """tests/test_diag.py:22-32's system (seed 1, 6 x 10) as numpy arrays."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    pos = lambda k: 0.1 + rng.random(k)  # noqa: E731
    sl, su, w, z, e, f = (pos(n) for _ in range(6))
    g = rng.random(m)
    h = pos(n)
    return A, (sl, su, w, z), (e, f, g, h)


def _checked(pkg, A, duals, rhs):
    if pkg == "jax":
        arr = lambda v: jnp.asarray(v, jnp.float64)  # noqa: E731
        op = j_dense_kkt_operator(arr(A))
        return jdiag.checked_solve_kkt_newton(
            *map(arr, duals), op, *map(arr, rhs))
    arr = lambda v: torch.as_tensor(v, dtype=torch.float64)  # noqa: E731
    return diag.checked_solve_kkt_newton(
        *map(arr, duals), dense_kkt_operator(arr(A)), *map(arr, rhs))


def test_checked_kkt_deltas_match_the_jax_package():
    A, duals, rhs = _kkt_system(1, 6, 10)
    got, want = _checked("torch", A, duals, rhs), _checked("jax", A, duals, rhs)
    assert bool(got.ok) and bool(want.ok)
    for k in ("dw", "dx", "dy", "dz"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=0, atol=1e-12)


def test_checked_kkt_raises_on_a_singular_system_in_both_packages():
    # tests/test_diag.py:35-45: a zero A, every other block ones.
    m, n = 4, 6
    one_n, one_m = np.ones(n), np.ones(m)
    args = (np.zeros((m, n)), (one_n,) * 4, (one_n, one_n, one_m, one_n))
    with pytest.raises(ValueError, match="KKT residuals"):
        _checked("jax", *args)
    with pytest.raises(diag.KKTCheckError, match="KKT residuals") as err:
        _checked("torch", *args)
    assert not bool(torch.all(err.value.residuals < 1e-4))


def test_checked_kkt_raises_on_a_nan_residual():
    A, duals, (e, f, g, h) = _kkt_system(1, 6, 10)
    g = g.copy()
    g[2] = np.nan
    with pytest.raises(diag.KKTCheckError) as err:
        _checked("torch", A, duals, (e, f, g, h))
    assert torch.isnan(err.value.residuals).any()


def test_device_memory_report_is_empty_on_the_cpu():
    assert diag.device_memory_report() == {} == jdiag.device_memory_report()
    assert diag.device_memory_report("cpu") == {}


def test_live_buffer_report_counts_a_new_tensor_and_a_view_once():
    before = diag.live_buffer_report()
    x = torch.ones((128, 128), dtype=torch.float32)
    after = diag.live_buffer_report()
    assert after["bytes"] - before["bytes"] >= 128 * 128 * 4
    assert after["count"] >= before["count"] + 1
    views = [x[1:], x.T, x.view(-1)]
    assert diag.live_buffer_report() == after
    del x, views


def test_memory_map_count():
    n = diag.memory_map_count()
    if sys.platform.startswith("linux"):
        assert n > 0
    else:
        assert n == -1


def _nan():
    return torch.zeros(1, dtype=torch.float64) / torch.zeros(1, dtype=torch.float64)


def test_nan_debug_raises_and_restores_its_state():
    with pytest.raises(FloatingPointError):
        with jdiag.nan_debug(True):
            jnp.zeros(1) / jnp.zeros(1)
    with pytest.raises(FloatingPointError, match="nan"):
        with diag.nan_debug(True):
            _nan()
    assert torch.isnan(_nan()).all()  # restored after the exception
    with diag.nan_debug(True):
        with diag.nan_debug(False):
            assert torch.isnan(_nan()).all()  # nested off
        with pytest.raises(FloatingPointError):
            _nan()  # on again after the nested block
    with diag.nan_debug(False):
        assert torch.isnan(_nan()).all()
    assert torch.isnan(_nan()).all()


def test_pdas_on_simple_runs_clean_under_nan_debug_in_both_packages():
    """Both packages solve simple.mps with pdas without a NaN from any
    operator (the JAX package checks its jitted programs' outputs, the port
    every eager operator)."""
    import cholesky_is_magic_tpu as cim

    with jdiag.nan_debug(True):
        want = cim.solve(SIMPLE, "pdas", dtype=jnp.float64, pad_multiple=16)
    with diag.nan_debug(True):
        got = cimt.solve(SIMPLE, "pdas", device="cpu", dtype=torch.float64,
                         pad_multiple=16)
    assert got.status == want.status == "optimal"
    assert got.summary["iterations"] == want.summary["iterations"]


def test_profile_trace_writes_a_trace_with_the_annotation(tmp_path):
    from cholesky_is_magic_tpu_torch.ops import dense as dense_ops

    logdir = str(tmp_path / "trace")
    A = torch.ones((8, 16), dtype=torch.float64)
    d, g = torch.ones(16, dtype=torch.float64), torch.ones(8, dtype=torch.float64)
    with diag.profile_trace(logdir) as prof:
        with diag.annotate("solve_normal"):
            y, ok = dense_ops.solve_normal(A, d, g)
            float(y[0])
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as fh:
        names = {ev.get("name") for ev in json.load(fh)["traceEvents"]}
    assert "solve_normal" in names
    assert any(e.key == "solve_normal" for e in prof.key_averages())
