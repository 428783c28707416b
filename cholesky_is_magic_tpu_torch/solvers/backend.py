"""Operand/backend dispatch shared by the solver loops.

Counterpart of ``cholesky_is_magic_tpu/solvers/backend.py``: a solver asks
for (A@v, Aᵀ@v) products and a scaled normal-equations solve, and the
operand set decides the implementation —

- dense ``DeviceLP``: matmuls + ops.dense, or with ``engine=`` a sparse
  engine built from A's pattern (sparse.tiled.engine_for or a
  sparse.factor.BlockSparseCholesky), whose ``prepare_normal`` assembles
  and factors the tiles of N from the dense A;
- fully sparse ``SparseKKTLP``: ELL / block-ELL products + the tile
  engine's pair-schedule assembly (``engine=`` from
  sparse.tiled.engine_for_sparse).

Not ported: the mesh-sharded pipeline (``mesh=`` raises), and a batch of
dense states on a dense-A engine (the batched loops raise, ROADMAP.md §1).
"""

from __future__ import annotations

from cholesky_is_magic_tpu_torch.ingest.device import SparseKKTLP
from cholesky_is_magic_tpu_torch.ops import dense as dense_ops


def check_backend(lp, engine, mesh, per_lane: bool = False) -> None:
    """Raise on the backends the port does not have.  ``per_lane``: the
    operands are a batch's stacked lanes."""
    if mesh is not None:
        raise NotImplementedError("mesh-sharded normal equations are not ported")
    if isinstance(lp, SparseKKTLP):
        if engine is None:
            raise ValueError("the sparse operand set needs engine= "
                             "(sparse.tiled.engine_for_sparse)")
    elif engine is not None and per_lane:
        raise NotImplementedError(
            "a batch of dense states on a dense-A engine (engine_for, "
            "BlockSparseCholesky) is not ported (ROADMAP.md §1)")


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
    return (lambda v: lp.A @ v, lambda v: lp.A.T @ v)


def row_boost(lp):
    """Unit diagonal boost on padded rows (keeps padding inert in N)."""
    dt = lp.c.dtype if isinstance(lp, SparseKKTLP) else lp.A.dtype
    return (~lp.row_mask).to(dt)


def prepare_normal_backend(lp, engine, d, row_boost, refine_steps,
                           mesh=None, dbound=0.0, krylov_steps=0,
                           krylov_gate=None, method="direct", per_lane=False):
    """Factor (A·diag(d))(A·diag(d))ᵀ ONCE on the backend the operand set
    selects; returns (solve_fn, ok).  ``per_lane`` (a lane of a batched
    solve: the host branches become per-lane selects) is read by the
    fully sparse and the plain dense backends, ``method`` by the plain
    dense one only (the engines have their own kernels)."""
    check_backend(lp, engine, mesh, per_lane)
    if isinstance(lp, SparseKKTLP):
        return engine.prepare_normal_ell(
            lp.E, lp.ET, d, lp.m, row_boost=row_boost,
            refine_steps=refine_steps, dbound=dbound,
            krylov_steps=krylov_steps, krylov_gate=krylov_gate,
            EB=lp.EB, ETB=lp.ETB, per_lane=per_lane,
        )
    if engine is not None:
        return engine.prepare_normal(
            lp.A, d, row_boost=row_boost, refine_steps=refine_steps,
            dbound=dbound, krylov_steps=krylov_steps, krylov_gate=krylov_gate,
        )
    return dense_ops.prepare_normal(
        lp.A, d, row_boost=row_boost, refine_steps=refine_steps,
        dbound=dbound, krylov_steps=krylov_steps,
        krylov_gate=krylov_gate, method=method, per_lane=per_lane,
    )


def solve_normal_backend(lp, engine, d, g, row_boost, refine_steps,
                         per_lane=False):
    """(A·diag(d))(A·diag(d))ᵀ y = g on the backend the operand set
    selects: one :func:`prepare_normal_backend` and one solve.  Returns
    (y, ok)."""
    solve_fn, ok = prepare_normal_backend(lp, engine, d, row_boost,
                                          refine_steps, per_lane=per_lane)
    return solve_fn(g), ok
