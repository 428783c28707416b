"""Interior-point solver loops of the slice: dense pdas and pdas_dd."""

from cholesky_is_magic_tpu_torch.solvers.pdas import (
    PDASConfig,
    PDASState,
    make_pdas,
    pdas,
)
from cholesky_is_magic_tpu_torch.solvers.pdas_dd import (
    PDASDDState,
    make_pdas_dd,
    pdas_dd,
)
from cholesky_is_magic_tpu_torch.solvers.result import SolveResult, Status

__all__ = [
    "PDASConfig",
    "PDASState",
    "PDASDDState",
    "SolveResult",
    "Status",
    "make_pdas",
    "make_pdas_dd",
    "pdas",
    "pdas_dd",
]
