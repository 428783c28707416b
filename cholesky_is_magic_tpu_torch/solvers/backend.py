"""Operand/backend dispatch shared by the solver loops (dense branches).

Counterpart of ``cholesky_is_magic_tpu/solvers/backend.py``: a solver asks
for (A@v, Aᵀ@v) products and a scaled normal-equations solve.  Only the
dense ``DeviceLP`` on ops.dense is ported; the sparse engines
(``engine=``) and the mesh-sharded pipeline (``mesh=``) raise.
"""

from __future__ import annotations

from cholesky_is_magic_tpu_torch.ops import dense as dense_ops


def _dense_only(engine, mesh) -> None:
    if engine is not None:
        raise NotImplementedError("sparse normal-equations engines are not ported")
    if mesh is not None:
        raise NotImplementedError("mesh-sharded normal equations are not ported")


def mv_rmv(lp):
    """(A@v, Aᵀ@v) for the dense operand set."""
    return (lambda v: lp.A @ v, lambda v: lp.A.T @ v)


def row_boost(lp):
    """Unit diagonal boost on padded rows (keeps padding inert in N)."""
    return (~lp.row_mask).to(lp.A.dtype)


def prepare_normal_backend(lp, engine, d, row_boost, refine_steps,
                           mesh=None, dbound=0.0, krylov_steps=0,
                           krylov_gate=None, method="direct"):
    """Factor (A·diag(d))(A·diag(d))ᵀ ONCE; returns (solve_fn, ok)."""
    _dense_only(engine, mesh)
    return dense_ops.prepare_normal(
        lp.A, d, row_boost=row_boost, refine_steps=refine_steps,
        dbound=dbound, krylov_steps=krylov_steps,
        krylov_gate=krylov_gate, method=method,
    )
