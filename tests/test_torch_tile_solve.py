"""The tile engine's triangular solves in the solve kernel's own order
(``tiled_cuda.tile_solve_plain``), on the CPU.

The card test (``tests/test_torch_cuda_tile_solve.py``) holds the kernel
(``csrc/tile_solve.cu``) against ``tile_solve_plain`` bit for bit, so here
that function is held against a scalar walk through the kernel's sums in
exact rational arithmetic rounded to float32 once per fused multiply-add,
and against ``TiledCholesky.solve``'s plain loop: within 1e-12 relative in
float64 and within 2e-6 relative in float32 (two summation orders of a
float32 triangular solve of a well-conditioned factor read about 1e-7), on
a near-diagonal pattern (the staircase LP, as pds-10's) and a filled one
(the QAP relaxation, as qap15's) at b = 16, 33, 64 and 128.  Then the
operator ``cim::tile_solve`` under ``torch.func.vmap`` against a loop over
lanes, ``TiledCholesky.solve``'s dispatch (the plain loop on the CPU, in
float64 and at other widths; the operator where the route says so), NaN
where the factor is not finite, the ``normal.solve_tiles`` counter, and
``lpbench``'s ``tile_solve_roofline``: its bound, its launch records and
its pairing with the kernel's events.
"""

import types
from fractions import Fraction

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cholesky_is_magic_tpu_torch.sparse import tiled, tiled_cuda
from cholesky_is_magic_tpu_torch.utils import spans
from lpbench import hooks, roofline, trace
from lpbench.drive import HERE, load
from test_torch_schur import _fma_exact, _round_f32

METRIC = load(HERE, "metrics", "tile_solve_roofline")


def _pattern(kind: str):
    """A (rows x columns) sparse A of each kind: the staircase LP (a
    near-diagonal factor) or the QAP relaxation at n = 5 (a filled one)."""
    if kind == "near-diagonal":
        from lpbench.gen import constructed_optimum as co

        base = co.base_instance(320, 640, 0, width=4)
        rows, cols, vals, m, n = (base[k] for k in ("rows", "cols", "vals", "m", "n"))
    else:
        from lpbench.gen import qap_relaxation as qap

        rows, cols, vals, m, n = qap.structure(5)
    return sp.csc_matrix((vals, (rows, cols)), shape=(m, n))


def _factored(kind: str, block: int, dtype, seed: int = 0):
    """(engine, L tiles, inverse tiles, right-hand side): a real factor of
    the pattern's normal matrix for a random column scaling."""
    A = _pattern(kind)
    eng = tiled.engine_for_sparse(A, block=block, dtype=dtype, device="cpu")
    rng = np.random.default_rng(seed)
    d = torch.as_tensor(np.exp(rng.uniform(-1, 1, A.shape[1])), dtype=dtype)
    L, inv, ok = eng.factorize(eng.assemble_pairs(d))
    assert bool(ok)
    rhs = torch.as_tensor(rng.normal(size=eng.B * eng.b), dtype=dtype)
    return eng, L, inv, rhs


def _passes(eng):
    off = eng.NT - eng.B
    return (tiled_cuda.SolvePass(eng.fwd_ids, eng.fwd_j, eng.fwd_n, off),
            tiled_cuda.SolvePass(eng.rows_ids, eng.rows_i, eng.rows_n, off))


@pytest.mark.parametrize("kind", ["near-diagonal", "filled"])
@pytest.mark.parametrize("block", [16, 33, 64, 128])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 2e-6)])
def test_plain_form_solves_as_the_loop(kind, block, dtype, tol):
    eng, L, inv, rhs = _factored(kind, block, dtype)
    assert eng.B > 2 and eng.NT > eng.B
    want = eng.solve(L, inv, rhs)
    got = tiled_cuda.tile_solve_plain(L, inv, rhs, *_passes(eng))
    assert got.dtype == dtype
    assert float((got - want).norm() / want.norm()) <= tol


def _scalar_order(L, inv, rhs, eng):
    """The kernel's sums walked entry by entry in float32, each fused
    multiply-add rounded once from its exact value (see the module
    docstring of ``csrc/tile_solve.cu``)."""
    b, B = eng.b, eng.B
    L, inv = L.numpy(), inv.numpy()
    r = rhs.numpy().reshape(B, b)
    U, U4 = -(-b // 32), -(-b // 128)

    def fwd_q(u, lane):
        """Forward, chain l's columns of step u: q = 128 u + 4 l + j."""
        return [128 * u + 4 * lane + j for j in range(4)]

    def tree(parts):
        parts = list(parts)
        while len(parts) > 1:
            h = len(parts) // 2
            parts = [_round_f32(Fraction(float(parts[i])) + Fraction(float(parts[i + h])))
                     for i in range(h)]
        return parts[0]

    def dot(entries):
        """entries(l) -> the (a, c) of chain l in order: the 32 chains,
        then the tree."""
        parts = []
        for lane in range(32):
            acc = np.float32(0.0)
            for a, c in entries(lane):
                acc = _fma_exact(a, c, acc)
            parts.append(acc)
        return tree(parts)

    y = np.zeros((B, b), np.float32)
    for k in range(B):
        ts = [(int(eng.fwd_ids[k, t]), int(eng.fwd_j[k, t])) for t in range(eng._n_fwd[k])]
        acc = r[k].copy()
        if ts:
            for i in range(b):
                s = dot(lambda lane: [(L[t, i, q], y[j, q]) for t, j in ts for u in range(U4)
                                      for q in fwd_q(u, lane) if q < b])
                acc[i] = _round_f32(Fraction(float(r[k, i])) - Fraction(float(s)))
        for i in range(b):
            y[k, i] = dot(lambda lane: [(inv[k, i, q], acc[q]) for u in range(U4)
                                        for q in fwd_q(u, lane) if q <= i and q < b])
    z = np.zeros((B, b), np.float32)
    for k in range(B - 1, -1, -1):
        ts = [(int(eng.rows_ids[k, t]), int(eng.rows_i[k, t])) for t in range(eng._n_rows[k])]
        acc = y[k].copy()
        if ts:
            for p in range(b):
                s = dot(lambda lane: [(L[t, q, p], z[i, q]) for t, i in ts for u in range(U)
                                      for q in [32 * u + lane] if q < b])
                acc[p] = _round_f32(Fraction(float(y[k, p])) - Fraction(float(s)))
        for p in range(b):
            z[k, p] = dot(lambda lane: [(inv[k, q, p], acc[q]) for u in range(U)
                                        for q in [32 * u + lane] if p <= q < b])
    return z.reshape(-1)


@pytest.mark.parametrize("n,block", [(3, 32), (3, 40), (5, 136)])
def test_plain_form_is_the_kernels_order(n, block):
    """QAP3's relaxation (42 rows) at block 32 and 40 (the last quads and
    rows ragged) and QAP5's (210 rows) at block 136 (two forward steps a
    lane): bit for bit the scalar walk."""
    from lpbench.gen import qap_relaxation as qap

    rows, cols, vals, m, nn = qap.structure(n)
    A = sp.csc_matrix((vals, (rows, cols)), shape=(m, nn))
    eng = tiled.engine_for_sparse(A, block=block, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(block)
    f32 = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32)  # noqa: E731
    L = f32(eng.NT + 1, block, block) / block**0.5
    inv = torch.tril(f32(eng.B, block, block), -1) / block**0.5 + torch.eye(block)
    rhs = f32(eng.B * block)
    assert eng.NT > eng.B
    got = tiled_cuda.tile_solve_plain(L, inv, rhs, *_passes(eng)).numpy()
    np.testing.assert_array_equal(got, _scalar_order(L, inv, rhs, eng))


@pytest.mark.parametrize("in_dims", [(0, 0, 0), (None, None, 0), (1, 0, None)])
def test_the_operator_under_vmap_is_a_loop_over_lanes(in_dims):
    eng, L, inv, rhs = _factored("filled", 16, torch.float32)
    lanes = 3
    Ls = torch.stack([L * (1 + 0.1 * k) for k in range(lanes)])
    invs = torch.stack([inv] * lanes)
    rhss = torch.stack([rhs * (k + 1) for k in range(lanes)])
    args = [Ls, invs, rhss]
    lane_of = []
    for a, d in zip(args, in_dims):
        lane_of.append((lambda k, a=a: a[k]) if d is not None else (lambda k, a=a: a[0]))
    batched = [a.movedim(0, d) if d is not None else a[0] for a, d in zip(args, in_dims)]
    got = torch.func.vmap(lambda *x: tiled_cuda.tile_solve(eng, *x), in_dims=in_dims)(*batched)
    for k in range(lanes):
        want = tiled_cuda.tile_solve(eng, *(f(k) for f in lane_of))
        assert torch.equal(got[k], want)


def test_the_cpu_float64_and_odd_widths_keep_the_loop(monkeypatch):
    calls = []
    monkeypatch.setattr(tiled_cuda, "tile_solve", lambda *a: calls.append(a))
    for dtype in (torch.float32, torch.float64):
        for block in (16, 33):
            eng, L, inv, rhs = _factored("near-diagonal", block, dtype)
            y = eng.solve(L, inv, rhs)
            assert y.shape == rhs.shape and torch.isfinite(y).all()
            assert not tiled_cuda.takes_tile_solve(L, inv, rhs)
    assert calls == []


def test_the_route_takes_the_operator_where_it_says_so(monkeypatch):
    """With ``takes_tile_solve`` made to say yes on the CPU (where the
    operator runs the kernel's sums), ``raw_solve`` goes through the
    operator alone and under vmap, and solves as the loop does."""
    eng, L, inv, rhs = _factored("filled", 32, torch.float32)
    m = eng.plan.n
    g = rhs[:m]
    want = eng.raw_solve(L, inv, g, m)
    monkeypatch.setattr(tiled_cuda, "takes_tile_solve", lambda *a: True)
    calls = []
    route = tiled_cuda.tile_solve

    def counted(*a):
        calls.append(a[0])
        return route(*a)

    monkeypatch.setattr(tiled_cuda, "tile_solve", counted)
    got = eng.raw_solve(L, inv, g, m)
    assert calls == [eng]
    assert float((got - want).norm() / want.norm()) <= 2e-6
    lanes = torch.func.vmap(lambda x: eng.raw_solve(L, inv, x, m))(torch.stack([g, 2 * g]))
    assert len(calls) == 2 and torch.equal(lanes[0], got)


@pytest.mark.parametrize("route", ["loop", "kernel's sums"])
def test_a_factor_that_is_not_finite_gives_nan(route, monkeypatch):
    eng, L, inv, rhs = _factored("filled", 16, torch.float32)
    bad = next(int(eng.rows_ids[k, 0]) for k in range(eng.B) if eng._n_rows[k])
    L = L.clone()
    L[bad, 0, 0] = float("nan")
    if route != "loop":
        monkeypatch.setattr(tiled_cuda, "takes_tile_solve", lambda *a: True)
    y = eng.solve(L, inv, rhs)
    assert torch.isnan(y).any()


def test_raw_solve_counts_the_tiles_it_reads():
    eng, L, inv, rhs = _factored("near-diagonal", 16, torch.float64)
    m = eng.plan.n
    with spans.recording() as rec:
        eng.raw_solve(L, inv, rhs[:m], m)
        eng.raw_solve(L, inv, rhs[:m], m)
    off = sum(eng._n_fwd)
    assert off == sum(eng._n_rows) == eng.NT - eng.B
    assert rec.counts["normal.solves"] == 2
    assert rec.counts["normal.solve_tiles"] == 2 * (2 * off + eng.B)


# -- lpbench's tile_solve_roofline ------------------------------------------

# pds-10's engine at block 128: 137 panels, 159 off-diagonal tiles.
PDS_B, PDS_OFF = 137, 159


def test_the_bound_is_the_bytes_of_one_pass():
    b = METRIC.bound(64, 128, PDS_B, PDS_OFF)
    tile, half = 128 * 128 * 4, 128 * 129 // 2 * 4
    assert b["bytes"] == 64 * (PDS_OFF * tile + PDS_B * half) + 2 * 4 * 64 * PDS_B * 128
    assert b["flops"] == 64 * (2 * PDS_OFF * 128 * 128 + PDS_B * 128 * 129)
    assert b["by"] == "bytes"
    # Two passes a solve: 0.57 ms at 64 lanes (1.91 GB).
    assert 2 * b["ms"] == pytest.approx(0.57, abs=0.01)
    shared = METRIC.bound(64, 128, PDS_B, PDS_OFF, shared_l=True, shared_inv=True)
    assert b["bytes"] - shared["bytes"] == 63 * (PDS_OFF * tile + PDS_B * half)


def test_the_launch_records_read_the_wrappers_arguments():
    off = 7
    tables = tiled_cuda.SolvePass(torch.zeros(3, 1, dtype=torch.int64),
                                  torch.zeros(3, 1, dtype=torch.int64),
                                  torch.zeros(3, dtype=torch.int64), off)
    L, inv = torch.zeros(5, 11, 64, 64), torch.zeros(5, 3, 64, 64)
    rhs = torch.zeros(5, 3 * 64)
    assert METRIC._describe((L, inv, rhs, tables, True), {}) == METRIC.bound(5, 64, 3, off)
    shared = METRIC._describe((L[:1].expand(5, -1, -1, -1), inv, rhs, tables, False), {})
    assert shared == METRIC.bound(5, 64, 3, off, shared_l=True)
    assert METRIC._describe((L[:1], inv[:1], rhs[:1], tables, True), {}) == \
        METRIC.bound(1, 64, 3, off)


def test_the_target_is_the_programs_wrapper():
    assert set(METRIC.LAUNCHES) == {f"{METRIC.MODULE}:tile_solve_pass"}
    for target in METRIC.LAUNCHES:
        owner, name = hooks._resolve(target)
        assert getattr(owner, name) is tiled_cuda.tile_solve_pass


def test_each_launch_pairs_with_one_event_of_either_pass():
    b = METRIC.bound(64, 128, PDS_B, PDS_OFF)
    fwd = "(anonymous namespace)::tile_solve_fwd_kernel((anonymous namespace)::Pass)"
    bwd = "(anonymous namespace)::tile_solve_bwd_kernel((anonymous namespace)::Pass)"
    others = [("(anonymous namespace)::tile_schur_kernel(float*)", 1e-3),
              ("void at::native::elementwise_kernel<128, 2>()", 1e-3)]

    def run(kernels, bounds):
        tr = trace.Trace(window_s=1.0, busy_s=0.5, kernels=kernels, idle_by_host={},
                         device_by_name={})
        return types.SimpleNamespace(
            trace=tr, launches={f"{METRIC.MODULE}:tile_solve_pass": bounds},
            say=lambda line: None)

    got = METRIC.read(run([(fwd, 1e-3), *others, (bwd, 1e-3)], [b, b]))
    assert got == pytest.approx(100.0 * 2 * b["ms"] / 2.0)
    assert METRIC.read(run([(fwd, 1e-3), *others], [b, b])) is None
    assert METRIC.read(run(others, [])) is None
    assert roofline.share_pct(b["ms"], 0.0) is None
