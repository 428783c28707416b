"""Block-eliminated KKT Newton step (dense, dense-A sparse-engine and fully
sparse operators)."""

from cholesky_is_magic_tpu_torch.kkt.newton import (
    FILTER_THRESHOLD,
    KKTDeltas,
    KKTOperator,
    KKTReduction,
    dense_kkt_operator,
    ell_kkt_operator,
    kkt_backsub,
    kkt_reduce,
    kkt_residuals,
    solve_kkt_newton,
    solve_kkt_newton_checked,
    sparse_kkt_operator,
)

__all__ = [
    "FILTER_THRESHOLD",
    "KKTDeltas",
    "KKTOperator",
    "KKTReduction",
    "dense_kkt_operator",
    "ell_kkt_operator",
    "kkt_backsub",
    "kkt_reduce",
    "kkt_residuals",
    "solve_kkt_newton",
    "solve_kkt_newton_checked",
    "sparse_kkt_operator",
]
