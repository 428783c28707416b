"""The port's BlockSparseCholesky (sparse/factor.py), held against the JAX
package in f64 on the CPU, on tests/test_sparse.py's patterns.

- the panel schedule (sub-diagonal row tiles, Schur-update pairs) and the
  permutation are equal;
- ``assemble_normal`` in both branches (tile-sparse and dense) within
  1e-12 of JAX's, the default gate taking the same branch;
- ``factorize`` within 1e-12 of JAX's, every tile the plan marks zero
  exactly zero (tests/test_sparse.py:190), L·Lᵀ = N;
- ``solve_normal`` within 1e-10 of JAX's with 0 and 2 refinement steps and
  with PCG, and on a singular N (ok False and a zero solution in both; the
  dbound retry, ok True in both).

On the CPU each diagonal tile takes ``blocked_cholesky`` and each TRSM
``_rsolve_lower_T``, operation for operation as in the JAX package; on the
card the potrf kernel and ``torch.linalg.solve_triangular``
(``chip_smoke.py`` phase 17)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cholesky_is_magic_tpu import sparse as jsparse
from cholesky_is_magic_tpu_torch import sparse as tsparse

torch.set_num_threads(1)


def _matrix(seed, m, n, density=0.08):
    """TestBlockSparseCholesky's random LP matrix (nonsingular Gram)."""
    rng = np.random.default_rng(seed)
    A = (rng.random((m, n)) < density) * rng.normal(size=(m, n))
    A[np.arange(m), np.arange(m)] += 2.0
    return A


def _engines(A, block):
    plan = lambda mod: mod.analyze(sp.csc_matrix(A), block=block, use_native=False)  # noqa: E731
    return (jsparse.BlockSparseCholesky(plan(jsparse)),
            tsparse.BlockSparseCholesky(plan(tsparse), device="cpu"))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


CASES = [(0, 40, 72, 0.08, 8), (0, 40, 72, 0.08, 16), (2, 48, 80, 0.05, 8)]


@pytest.mark.parametrize("seed,m,n,density,block", CASES)
def test_schedule_assembly_and_factor_match(seed, m, n, density, block):
    A = _matrix(seed, m, n, density)
    je, te = _engines(A, block)
    assert (te.panel_rows, te.updates) == (je.panel_rows, je.updates)
    np.testing.assert_array_equal(np.asarray(je.pperm), te.pperm.numpy())
    d = np.random.default_rng(seed + 1).random(n) + 0.5
    jA, jd, tA, td = jnp.asarray(A), jnp.asarray(d), torch.from_numpy(A), torch.from_numpy(d)
    for tile_sparse in (None, True, False):
        Nj = np.asarray(je.assemble_normal(jA, jd, tile_sparse=tile_sparse))
        Nt = te.assemble_normal(tA, td, tile_sparse=tile_sparse).numpy()
        assert _rel(Nj, Nt) <= 1e-12
    Lj = np.asarray(je.factorize(jnp.asarray(Nj)))
    Lt = te.factorize(torch.from_numpy(Nj.copy())).numpy()
    assert _rel(Lj, Lt) <= 1e-12
    B = te.n_tiles
    mask = te.plan.block_mask | np.eye(B, dtype=bool)
    for i in range(B):
        for j in range(B):
            if i < j or not mask[i, j]:
                tile = Lt[i * block:(i + 1) * block, j * block:(j + 1) * block]
                assert np.all(tile == 0.0), (i, j)
    np.testing.assert_allclose(Lt @ Lt.T, Nj, rtol=1e-9, atol=1e-9)


def test_block_diagonal_problem_skips_tiles():
    """Two independent sub-LPs (tests/test_sparse.py:216): tiles bridging
    the halves are never touched, and the solve still agrees."""
    m, n, block = 32, 48, 8
    A = np.zeros((m, n))
    A[: m // 2, : n // 2] = _matrix(4, m // 2, n // 2)
    A[m // 2:, n // 2:] = _matrix(5, m // 2, n // 2)
    je, te = _engines(A, block)
    B = te.n_tiles
    dense_pairs = sum(len([(i, j) for i in range(k + 1, B) for j in range(k + 1, i + 1)])
                      for k in range(B))
    assert sum(len(p) for p in te.updates) < dense_pairs
    rng = np.random.default_rng(6)
    d, g = rng.random(n) + 0.5, rng.normal(size=m)
    yj, okj = je.solve_normal(jnp.asarray(A), jnp.asarray(d), jnp.asarray(g))
    yt, okt = te.solve_normal(torch.from_numpy(A), torch.from_numpy(d), torch.from_numpy(g))
    assert bool(okj) and bool(okt)
    assert _rel(yj, yt) <= 1e-10


@pytest.mark.parametrize("kw", [dict(refine_steps=0), dict(refine_steps=2),
                                dict(refine_steps=1, krylov_steps=8)])
def test_solve_normal_matches(kw):
    A = _matrix(0, 40, 72)
    je, te = _engines(A, 8)
    rng = np.random.default_rng(1)
    # IPM-like column scales (cond(N) ~ 1e6): refinement has work to do.
    d = 10.0 ** rng.uniform(-1.5, 1.5, size=72)
    g = rng.normal(size=40)
    fj = jax.jit(lambda d_, g_: je.solve_normal(jnp.asarray(A), d_, g_, **kw))
    yj, okj = fj(jnp.asarray(d), jnp.asarray(g))
    yt, okt = te.solve_normal(torch.from_numpy(A), torch.from_numpy(d),
                              torch.from_numpy(g), **kw)
    assert bool(okj) and bool(okt)
    assert _rel(yj, yt) <= 1e-10
    Ad = A * d[None, :]
    assert _rel(np.linalg.solve(Ad @ Ad.T, g), yt) <= 1e-8


def test_singular_and_dbound_retry_match():
    """Padded zero rows without a boost make N singular: ok False and a
    zero solution in both; the dbound retry recovers both, the padded rows
    of the solution zero."""
    A = np.vstack([_matrix(3, 24, 40, 0.2), np.zeros((4, 40))])
    je, te = _engines(A, 8)
    rng = np.random.default_rng(3)
    d = rng.random(40) + 0.5
    g = np.concatenate([rng.normal(size=24), np.zeros(4)])
    args_j = (jnp.asarray(A), jnp.asarray(d), jnp.asarray(g))
    args_t = (torch.from_numpy(A), torch.from_numpy(d), torch.from_numpy(g))
    yj, okj = je.solve_normal(*args_j)
    yt, okt = te.solve_normal(*args_t)
    assert not bool(okj) and not bool(okt)
    np.testing.assert_array_equal(yt.numpy(), 0.0)
    yj, okj = je.solve_normal(*args_j, dbound=1e-6)
    yt, okt = te.solve_normal(*args_t, dbound=1e-6)
    assert bool(okj) and bool(okt)
    assert _rel(yj, yt) <= 1e-10
    np.testing.assert_array_equal(yt.numpy()[24:], 0.0)
