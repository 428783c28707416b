"""Operand/backend dispatch shared by the solver loops.

Counterpart of ``cholesky_is_magic_tpu/solvers/backend.py``: a solver asks
for (A@v, Aᵀ@v) products and a scaled normal-equations solve, and the
operand set decides the implementation —

- dense ``DeviceLP``: matmuls + ops.dense;
- fully sparse ``SparseKKTLP``: ELL / block-ELL products + the tile
  engine's pair-schedule assembly (``engine=`` from
  sparse.tiled.engine_for_sparse).

Not ported: the mesh-sharded pipeline (``mesh=``) and the dense-A tile
engine (``engine=`` with a dense ``DeviceLP``); both raise.
"""

from __future__ import annotations

from cholesky_is_magic_tpu_torch.ingest.device import SparseKKTLP
from cholesky_is_magic_tpu_torch.ops import dense as dense_ops


def check_backend(lp, engine, mesh) -> None:
    """Raise on the backends the port does not have."""
    if mesh is not None:
        raise NotImplementedError("mesh-sharded normal equations are not ported")
    if isinstance(lp, SparseKKTLP):
        if engine is None:
            raise ValueError("the sparse operand set needs engine= "
                             "(sparse.tiled.engine_for_sparse)")
    elif engine is not None:
        raise NotImplementedError("the dense-A tile engine is not ported")


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
    selects; returns (solve_fn, ok).  ``method`` and ``per_lane`` (a lane
    of a batched solve: the host branches become per-lane selects) are read
    by the dense backend only; the sparse one refuses ``per_lane``."""
    check_backend(lp, engine, mesh)
    if isinstance(lp, SparseKKTLP):
        if per_lane:
            raise NotImplementedError(
                "batched solves on the sparse engine are not ported")
        return engine.prepare_normal_ell(
            lp.E, lp.ET, d, lp.m, row_boost=row_boost,
            refine_steps=refine_steps, dbound=dbound,
            krylov_steps=krylov_steps, krylov_gate=krylov_gate,
            EB=lp.EB, ETB=lp.ETB,
        )
    return dense_ops.prepare_normal(
        lp.A, d, row_boost=row_boost, refine_steps=refine_steps,
        dbound=dbound, krylov_steps=krylov_steps,
        krylov_gate=krylov_gate, method=method, per_lane=per_lane,
    )


def solve_normal_backend(lp, engine, d, g, row_boost, refine_steps):
    """(A·diag(d))(A·diag(d))ᵀ y = g on the backend the operand set
    selects: one :func:`prepare_normal_backend` and one solve.  Returns
    (y, ok)."""
    solve_fn, ok = prepare_normal_backend(lp, engine, d, row_boost,
                                          refine_steps)
    return solve_fn(g), ok
