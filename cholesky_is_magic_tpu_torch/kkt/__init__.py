"""Block-eliminated KKT Newton step (dense operator)."""

from cholesky_is_magic_tpu_torch.kkt.newton import (
    FILTER_THRESHOLD,
    KKTDeltas,
    KKTOperator,
    KKTReduction,
    dense_kkt_operator,
    kkt_backsub,
    kkt_reduce,
    kkt_residuals,
    solve_kkt_newton,
)

__all__ = [
    "FILTER_THRESHOLD",
    "KKTDeltas",
    "KKTOperator",
    "KKTReduction",
    "dense_kkt_operator",
    "kkt_backsub",
    "kkt_reduce",
    "kkt_residuals",
    "solve_kkt_newton",
]
