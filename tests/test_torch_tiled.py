"""The port's tile engine (sparse/tiled.py) and its host analysis, held
against the JAX package in f64 on the patterns of tests/test_tiled.py.

- the symbolic plans and every engine schedule array are equal, with the
  native and with the Python pair schedule;
- ``assemble_pairs`` agrees within 1e-12 relative, ``factorize`` (tiles,
  inverses, ok) within 1e-10 (also at block 256, the card's split tile),
  and ``solve_normal_ell`` within 1e-10 with
  0 / 1 / 2 refinement steps over ELL and block-ELL, and with PCG;
- a singular normal matrix gives ok False and a zero solution in both, and
  the dbound retry recovers it in both.

On the CPU the engine's tile factor and assembly take their plain versions;
their CUDA kernels are held against those on the card
(tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cholesky_is_magic_tpu.ops import bell as jbell
from cholesky_is_magic_tpu.ops import sparse_ops as jso
from cholesky_is_magic_tpu.sparse import symbolic as jsym
from cholesky_is_magic_tpu.sparse import tiled as jtiled
from cholesky_is_magic_tpu_torch.ops import bell as tbell
from cholesky_is_magic_tpu_torch.ops import sparse_ops as tso
from cholesky_is_magic_tpu_torch.sparse import symbolic as tsym
from cholesky_is_magic_tpu_torch.sparse import tiled as ttiled
from cholesky_is_magic_tpu_torch.sparse import tiled_cuda

torch.set_num_threads(1)


def _pattern(kind, seed=9):
    """The test_tiled.py patterns: random with a dominant diagonal at two
    densities, and three independent blocks (block-diagonal N)."""
    rng = np.random.default_rng(seed)
    if kind == "blocks":
        A = np.zeros((96, 192))
        for k in range(3):
            blk = (rng.random((32, 64)) < 0.2) * rng.normal(size=(32, 64))
            blk[np.arange(32), np.arange(32)] += 2.0
            A[32 * k: 32 * (k + 1), 64 * k: 64 * (k + 1)] = blk
        return A, rng
    if kind == "wide":  # 300 rows: two panels at block 256
        A = (rng.random((300, 420)) < 0.01) * rng.normal(size=(300, 420))
        A[np.arange(300), np.arange(300)] += 2.0
        return A, rng
    density = {"sparse": 0.10, "denser": 0.20}[kind]
    A = (rng.random((72, 120)) < density) * rng.normal(size=(72, 120))
    A[np.arange(72), np.arange(72)] += 2.0
    return A, rng


CASES = [("sparse", 8), ("denser", 16), ("blocks", 16)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


def _engines(A, block):
    return (jtiled.engine_for_sparse(A, block=block, dtype=jnp.float64),
            ttiled.engine_for_sparse(A, block=block, dtype=torch.float64,
                                     device="cpu"))


@pytest.mark.parametrize("kind,block", CASES)
def test_analyze_plans_equal(kind, block):
    A, _ = _pattern(kind)
    pj = jsym.analyze(sp.csc_matrix(A), block=block)
    pt = tsym.analyze(sp.csc_matrix(A), block=block)
    for f in ("perm", "iperm", "parent", "post", "counts", "block_mask",
              "slots", "slot_mask"):
        np.testing.assert_array_equal(getattr(pj, f), getattr(pt, f))
    for f in ("n", "block", "nnz_N", "nnz_L", "flops", "snodes"):
        assert getattr(pj, f) == getattr(pt, f)


SCHEDULE = ("diag_ids", "rows_ids", "rows_i", "syrk_a", "syrk_b", "syrk_dst",
            "fwd_ids", "fwd_j", "pperm", "asm_w", "asm_k", "asm_dst_flat")


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("kind,block", CASES)
def test_engine_schedules_equal(kind, block, native, monkeypatch):
    A, _ = _pattern(kind)
    if not native:
        for mod in ("cholesky_is_magic_tpu.sparse.native",
                    "cholesky_is_magic_tpu_torch.sparse.native"):
            monkeypatch.setattr(f"{mod}.pair_schedule", lambda *a, **k: None)
    je, te = _engines(A, block)
    assert (te.B, te.b, te.NT, te.tiles, te.n_pairs, te.dropped_updates) == (
        je.B, je.b, je.NT, je.tiles, je.n_pairs, je.dropped_updates)
    for f in SCHEDULE:
        np.testing.assert_array_equal(np.asarray(getattr(je, f)),
                                      getattr(te, f).numpy())
    # The run offsets the assembly kernel walks: one run per destination.
    dst = te.asm_dst_flat.numpy()
    start = te.asm_run_start.numpy()
    np.testing.assert_array_equal(te.asm_run_dst.numpy(), dst[start[:-1]])
    assert start[-1] == len(dst) and np.all(np.diff(te.asm_run_dst.numpy()) > 0)
    assert np.all(np.diff(start) > 0)


@pytest.mark.parametrize("kind,block", CASES + [("wide", 256)])
def test_assemble_factorize_and_solve_match(kind, block):
    A, rng = _pattern(kind)
    m, n = A.shape
    je, te = _engines(A, block)
    assert te.B >= 2
    d = rng.random(n) + 0.5
    boost = (rng.random(m) < 0.1).astype(np.float64)
    tj = je.assemble_pairs(jnp.asarray(d), jnp.asarray(boost))
    tt = te.assemble_pairs(torch.from_numpy(d), torch.from_numpy(boost))
    assert _rel(tj, tt) <= 1e-12
    Lj, Ij, okj = jax.jit(je.factorize)(tj)
    Lt, It, okt = te.factorize(tt)
    assert bool(okj) and bool(okt)
    assert _rel(Lj, Lt) <= 1e-10 and _rel(Ij, It) <= 1e-10
    r = rng.normal(size=te.B * te.b)
    assert _rel(jax.jit(je.solve)(Lj, Ij, jnp.asarray(r)),
                te.solve(Lt, It, torch.from_numpy(r))) <= 1e-10


def _solve_pair(A, block, d, g, **kw):
    je, te = _engines(A, block)
    bell = kw.pop("bell", False)
    jops = [jso.from_dense(A, dtype=jnp.float64),
            jso.from_dense(A.T, dtype=jnp.float64)]
    tops = [tso.from_dense(A, dtype=torch.float64, device="cpu"),
            tso.from_dense(A.T, dtype=torch.float64, device="cpu")]
    if bell:
        rows, cols = np.nonzero(A)
        shape = A.shape
        mk = lambda mod, dt, r, c, s, **k: mod.from_coo(  # noqa: E731
            r, c, A[rows, cols], s, dtype=dt, max_dense_frac=64.0, **k)
        kw_j = dict(EB=mk(jbell, jnp.float64, rows, cols, shape),
                    ETB=mk(jbell, jnp.float64, cols, rows, shape[::-1]))
        kw_t = dict(EB=mk(tbell, torch.float64, rows, cols, shape,
                           device="cpu"),
                    ETB=mk(tbell, torch.float64, cols, rows, shape[::-1],
                           device="cpu"))
        assert kw_t["EB"] is not None and kw_t["ETB"] is not None
    else:
        kw_j = kw_t = {}
    fj = jax.jit(lambda d_, g_: je.solve_normal_ell(*jops, d_, g_, **kw, **kw_j))
    yj, okj = fj(jnp.asarray(d), jnp.asarray(g))
    yt, okt = te.solve_normal_ell(*tops, torch.from_numpy(d),
                                  torch.from_numpy(g), **kw, **kw_t)
    return np.asarray(yj), bool(okj), yt.numpy(), bool(okt)


@pytest.mark.parametrize("kw", [
    dict(refine_steps=0), dict(refine_steps=1), dict(refine_steps=2),
    dict(refine_steps=1, bell=True), dict(refine_steps=2, bell=True),
    dict(refine_steps=1, krylov_steps=8),
])
def test_solve_normal_ell_matches(kw):
    A, rng = _pattern("sparse", seed=11)
    # IPM-like column scales (cond(N) ~ 1e6): refinement has work to do.
    d = 10.0 ** rng.uniform(-1.5, 1.5, size=A.shape[1])
    g = rng.normal(size=A.shape[0])
    yj, okj, yt, okt = _solve_pair(A, 16, d, g, **kw)
    assert okj and okt
    assert _rel(yj, yt) <= 1e-10


def test_singular_and_dbound_retry_match():
    A, rng = _pattern("sparse", seed=3)
    d = rng.random(A.shape[1]) + 0.5
    d[:40] = 0.0  # rows whose only coupling is through zeroed columns
    A = A.copy()
    A[:, 40:][:5] = 0.0  # ... so these five rows of N are exactly zero
    g = rng.normal(size=A.shape[0])
    yj, okj, yt, okt = _solve_pair(A, 8, d, g)
    assert not okj and not okt
    np.testing.assert_array_equal(yt, 0.0)
    yj, okj, yt, okt = _solve_pair(A, 8, d, g, dbound=1e-6)
    assert okj and okt
    assert _rel(yj, yt) <= 1e-10


def test_unported_paths_raise_and_cpu_launches_nothing():
    """The dense-A entry points are ported (tests/test_torch_dense_engine.py
    holds them against the JAX package): on the pair-schedule engine they
    give the pair assembly's tiles and its solve.  On CPU tensors neither
    assembly launches a kernel."""
    A, rng = _pattern("sparse")
    te = ttiled.engine_for_sparse(A, block=8, dtype=torch.float64,
                                  device="cpu")
    before = dict(tiled_cuda.LAUNCHES)
    d = torch.from_numpy(rng.random(A.shape[1]) + 0.5)
    boost = torch.zeros(A.shape[0], dtype=torch.float64)
    tiles = te.assemble_pairs(d, boost)
    dense = te.assemble(torch.from_numpy(A), d, boost)
    assert tiled_cuda.LAUNCHES == before
    assert _rel(tiles.numpy(), dense.numpy()) <= 1e-12
    g = torch.from_numpy(rng.normal(size=A.shape[0]))
    y_dense, ok = te.solve_normal(torch.from_numpy(A), d, g)
    y_pairs, ok_pairs = te.solve_normal_ell(
        tso.from_dense(A, dtype=torch.float64, device="cpu"),
        tso.from_dense(A.T, dtype=torch.float64, device="cpu"), d, g)
    assert bool(ok) and bool(ok_pairs)
    assert _rel(y_pairs.numpy(), y_dense.numpy()) <= 1e-10
    with pytest.raises(ValueError, match="CUDA"):
        tiled_cuda.assemble_pairs(te, torch.ones(120), torch.zeros(0))
