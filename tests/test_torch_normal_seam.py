"""The factor-once / solve-many seam (ops/normal.py) on every single-device
backend of the port's normal equations, on the CPU: dense ``"direct"`` and
``"inverse"``, BlockSparseCholesky, the tile engine on a dense A and the
tile engine's ELL path.

The normal matrix is rank-deficient, so with the dbound retry armed every
backend factors twice.  The counters the benchmark reads per iteration
(``normal.factorizations``, ``normal.solves``, ``loop.host_reads``) and the
``normal.refine`` spans are pinned for one prepare and one solve, with
Richardson refinement and with PCG.  A one-lane ``torch.func.vmap`` of the
same call (``per_lane``: both factorizations and a select, no host read)
gives the host path's ``ok`` and its ``y``, up to how the vmapped
factorization's batched products round."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cholesky_is_magic_tpu_torch.ops import dense
from cholesky_is_magic_tpu_torch.ops import sparse_ops as so
from cholesky_is_magic_tpu_torch.sparse import BlockSparseCholesky, analyze, tiled
from cholesky_is_magic_tpu_torch.utils import diag, lanes

torch.set_num_threads(1)

M, N_COLS, PADDED = 12, 20, 2
DBOUND, REFINE = 1e-6, 1


def _inputs():
    """A with two zero (padded, boosted) rows; d zero on all but three
    columns, so N has rank 3 + 2 of 12 and the plain factorization fails."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(M, N_COLS))
    A[M - PADDED:] = 0.0
    d = rng.random(N_COLS) + 0.5
    d[3:] = 0.0
    g = rng.normal(size=M)
    boost = np.zeros(M)
    boost[M - PADDED:] = 1.0
    return A, d, g, boost


def _backend(name):
    """prep(d, per_lane, krylov_steps, dbound) -> (solve_fn, ok), and the
    (d, g) it solves for."""
    A, d, g, boost = _inputs()
    At, dt, gt, bt = (torch.from_numpy(v) for v in (A, d, g, boost))
    if name in ("dense_direct", "dense_inverse"):
        method = name.split("_")[1]

        def prep(s, per_lane, k, dbound=DBOUND):
            return dense.prepare_normal(At, s, row_boost=bt, refine_steps=REFINE,
                                        dbound=dbound, krylov_steps=k, method=method,
                                        per_lane=per_lane)
        return prep, dt, gt
    if name in ("block_sparse", "tiled_dense"):
        eng = (BlockSparseCholesky(analyze(sp.csc_matrix(A), block=4), device="cpu")
               if name == "block_sparse" else tiled.engine_for(At, block=4, device="cpu"))

        def prep(s, per_lane, k, dbound=DBOUND):
            return eng.prepare_normal(At, s, row_boost=bt, refine_steps=REFINE,
                                      dbound=dbound, krylov_steps=k, per_lane=per_lane)
        return prep, dt, gt
    # the fully sparse path: no padded rows, A as ELL pairs
    m = M - PADDED
    rows, cols = np.nonzero(A[:m])
    vals = A[rows, cols]
    kw = dict(dtype=torch.float64, device="cpu")
    E = so.from_coo(rows, cols, vals, (m, N_COLS), **kw)
    ET = so.from_coo(cols, rows, vals, (N_COLS, m), **kw)
    eng = tiled.engine_for_sparse(sp.csc_matrix(A[:m]), block=4, **kw)

    def prep(s, per_lane, k, dbound=DBOUND):
        return eng.prepare_normal_ell(E, ET, s, m, refine_steps=REFINE, dbound=dbound,
                                      krylov_steps=k, per_lane=per_lane)
    return prep, dt, gt[:m]


BACKENDS = ["dense_direct", "dense_inverse", "block_sparse", "tiled_dense", "tiled_ell"]


@pytest.mark.parametrize("krylov_steps", [0, 8])
@pytest.mark.parametrize("name", BACKENDS)
def test_retry_counts_and_per_lane_select(name, krylov_steps):
    prep, d, g = _backend(name)
    with diag.recording() as rec:
        solve_fn, ok = prep(d, False, krylov_steps)
        y = solve_fn(g)
    assert bool(ok)
    # PCG: M⁻¹b and M⁻¹r₀, then one preconditioner solve and two refine
    # spans (N-apply, residual) a step, plus r₀'s.
    solves = 1 + REFINE if krylov_steps == 0 else 2 + krylov_steps
    refines = REFINE if krylov_steps == 0 else 1 + 2 * krylov_steps
    assert rec.counts["normal.factorizations"] == 2
    assert rec.counts["normal.solves"] == solves
    assert rec.counts["loop.host_reads"] == 1
    assert rec.totals()["normal.refine"][0] == refines

    def one(s, r):
        fn, ok = prep(s, True, krylov_steps)
        return fn(r), ok

    with diag.recording() as rec:
        y_lane, ok_lane = lanes.vmap(one, d[None], g[None])
    assert rec.counts["normal.factorizations"] == 2
    assert rec.counts["normal.solves"] == solves
    assert "loop.host_reads" not in rec.counts
    assert torch.equal(ok_lane[0], ok)
    assert torch.isfinite(y).all() and y.abs().max() > 0
    assert (y_lane[0] - y).abs().max() <= 1e-9 * y.abs().max()


@pytest.mark.parametrize("name", BACKENDS)
def test_unarmed_retry_reads_nothing_and_zeroes(name):
    """dbound 0: one factorization, no host read, and the failed factor's
    solve is zero."""
    prep, d, g = _backend(name)
    with diag.recording() as rec:
        solve_fn, ok = prep(d, False, 0, dbound=0.0)
        y = solve_fn(g)
    assert not bool(ok)
    assert torch.equal(y, torch.zeros_like(y))
    assert rec.counts["normal.factorizations"] == 1
    assert "loop.host_reads" not in rec.counts
