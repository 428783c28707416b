"""Operand/backend dispatch shared by the solver loops.

Counterpart of ``cholesky_is_magic_tpu/solvers/backend.py``: a solver asks
for (A@v, Aᵀ@v) products (:func:`mv_rmv`), their double-word forms
(:func:`dd_linops`) and a scaled normal-equations solve
(:func:`prepare_normal_backend`), and the operand set decides the
implementation —

- dense ``DeviceLP``: matmuls + ops.dense, or with ``engine=`` a sparse
  engine built from A's pattern (sparse.tiled.engine_for or a
  sparse.factor.BlockSparseCholesky), whose ``prepare_normal`` assembles
  and factors the tiles of N from the dense A;
- fully sparse ``SparseKKTLP``: ELL / block-ELL products + the tile
  engine's pair-schedule assembly (``engine=`` from
  sparse.tiled.engine_for_sparse); with ``mesh=`` too, the engine shards
  its assembly's pair slabs and its panels' Schur updates over 'tp';
- column-sharded ``parallel.sharded.ShardedLP`` (or ``mesh=`` on a dense
  LP): the products and the normal solve of parallel.sharded, one
  all-reduce per factorization over the mesh's 'tp' axis.

Every backend also runs inside a lane of a batched solve (``per_lane``).
"""

from __future__ import annotations

from cholesky_is_magic_tpu_torch.ingest.device import DeviceLP, SparseKKTLP
from cholesky_is_magic_tpu_torch.ops import dd as ddm
from cholesky_is_magic_tpu_torch.ops import dense as dense_ops


def check_backend(lp, engine, mesh) -> None:
    """Raise on arguments no backend takes: a ``mesh`` that is not a
    ('dp', 'tp') DeviceMesh (``TypeError``), a sparse operand set without
    its engine (``ValueError``)."""
    if mesh is not None:
        from cholesky_is_magic_tpu_torch.parallel.sharded import check_mesh

        check_mesh(mesh)
    if isinstance(lp, SparseKKTLP) and engine is None:
        raise ValueError("the sparse operand set needs engine= "
                         "(sparse.tiled.engine_for_sparse)")


def shard_for(lp, mesh):
    """The operand set a solver runs on under ``mesh``: a dense DeviceLP
    held by columns over 'tp' (parallel.sharded.shard_lp_columns), any
    other operand set as it is (the fully sparse one shards inside its
    engine)."""
    if mesh is None or not isinstance(lp, DeviceLP):
        return lp
    from cholesky_is_magic_tpu_torch.parallel.sharded import shard_lp_columns

    return shard_lp_columns(lp, mesh)


def _sharded(lp):
    from cholesky_is_magic_tpu_torch.parallel.sharded import ShardedLP

    return isinstance(lp, ShardedLP)


def mv_rmv(lp):
    """(A@v, Aᵀ@v) for the operand set; sparse products ride the block-ELL
    renderings when the operand set carries them, else the ELL pair."""
    if isinstance(lp, SparseKKTLP):
        from cholesky_is_magic_tpu_torch.ops import bell
        from cholesky_is_magic_tpu_torch.ops import sparse_ops as so

        mv = ((lambda v: bell.matvec(lp.EB, v)) if lp.EB is not None
              else (lambda v: so.matvec(lp.E, v)))
        rmv = ((lambda v: bell.matvec(lp.ETB, v)) if lp.ETB is not None
               else (lambda v: so.matvec(lp.ET, v)))
        return mv, rmv
    if _sharded(lp):
        return lp.shard.mv, lp.shard.rmv
    return (lambda v: lp.A @ v, lambda v: lp.A.T @ v)


def dd_linops(lp):
    """The double-word products (A·x for a dd x, Aᵀ·y for a dd y, Aᵀ·v for
    a working-precision v) for the operand set: dense (the CUDA double-word
    kernels on the card), column-sharded (the same products on each rank's
    block, made whole by all-reduces of the hi and lo words or
    all-gathers) or fully sparse (block-ELL when carried, else the ELL
    pair)."""
    if isinstance(lp, SparseKKTLP):
        from cholesky_is_magic_tpu_torch.ops import bell
        from cholesky_is_magic_tpu_torch.ops import sparse_ops as so

        mv_dd = ((lambda x_dd: bell.dd_matvec_dd(lp.EB, x_dd))
                 if lp.EB is not None
                 else (lambda x_dd: so.dd_matvec_dd(lp.E, x_dd)))
        if lp.ETB is not None:
            return (mv_dd, lambda y_dd: bell.dd_matvec_dd(lp.ETB, y_dd),
                    lambda v: bell.dd_matvec(lp.ETB, v))
        return (mv_dd, lambda y_dd: so.dd_matvec_dd(lp.ET, y_dd),
                lambda v: so.dd_matvec(lp.ET, v))
    if _sharded(lp):
        return lp.shard.mv_dd, lp.shard.rmv_dd, lp.shard.rmv_w
    return (
        lambda x_dd: ddm.dd_matvec_dd(lp.A, x_dd),
        lambda y_dd: ddm.dd_rmatvec_dd(lp.A, y_dd),
        lambda v: ddm.dd_rmatvec(lp.A, v),
    )


def row_boost(lp):
    """Unit diagonal boost on padded rows (keeps padding inert in N)."""
    dt = lp.c.dtype if isinstance(lp, SparseKKTLP) else lp.A.dtype
    return (~lp.row_mask).to(dt)


def prepare_normal_backend(lp, engine, d, row_boost, refine_steps,
                           mesh=None, dbound=0.0, krylov_steps=0,
                           krylov_gate=None, method="direct", per_lane=False,
                           true_residual=False):
    """Factor (A·diag(d))(A·diag(d))ᵀ ONCE on the backend the operand set
    selects; returns (solve_fn, ok).  ``per_lane`` (a lane of a batched
    solve: the host branches become per-lane selects) is read by the
    fully sparse backend, the engines and the plain dense backend,
    ``method`` and ``true_residual`` by the plain dense one only (the
    engines have their own kernels and always refine against the
    unassembled operator, as the column-sharded backend does).  ``mesh``
    shards the fully sparse engine's factorization, or runs a dense LP's
    normal solve column-sharded (as a ShardedLP's always runs)."""
    check_backend(lp, engine, mesh)
    if isinstance(lp, SparseKKTLP):
        return engine.prepare_normal_ell(
            lp.E, lp.ET, d, lp.m, row_boost=row_boost,
            refine_steps=refine_steps, dbound=dbound,
            krylov_steps=krylov_steps, krylov_gate=krylov_gate,
            EB=lp.EB, ETB=lp.ETB, mesh=mesh, per_lane=per_lane,
        )
    if mesh is not None or _sharded(lp):
        from cholesky_is_magic_tpu_torch.parallel.sharded import sharded_prepare_normal

        A = lp.shard if _sharded(lp) else lp.A
        return sharded_prepare_normal(
            mesh if mesh is not None else lp.mesh, A, d, row_boost=row_boost,
            refine_steps=refine_steps, dbound=dbound,
            krylov_steps=krylov_steps, krylov_gate=krylov_gate,
        )
    if engine is not None:
        return engine.prepare_normal(
            lp.A, d, row_boost=row_boost, refine_steps=refine_steps,
            dbound=dbound, krylov_steps=krylov_steps, krylov_gate=krylov_gate,
            per_lane=per_lane,
        )
    return dense_ops.prepare_normal(
        lp.A, d, row_boost=row_boost, refine_steps=refine_steps,
        true_residual=true_residual, dbound=dbound, krylov_steps=krylov_steps,
        krylov_gate=krylov_gate, method=method, per_lane=per_lane,
    )


def solve_normal_backend(lp, engine, d, g, row_boost, refine_steps,
                         per_lane=False, mesh=None):
    """(A·diag(d))(A·diag(d))ᵀ y = g on the backend the operand set
    selects: one :func:`prepare_normal_backend` and one solve.  Returns
    (y, ok)."""
    solve_fn, ok = prepare_normal_backend(lp, engine, d, row_boost,
                                          refine_steps, mesh=mesh,
                                          per_lane=per_lane)
    return solve_fn(g), ok
