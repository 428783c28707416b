"""Solver loops: primal affine scaling, pdas and pdas_dd, on dense or fully
sparse operands, the crossover polish of a pdas or pdas_dd result to a
certified vertex, and the matrix-free family (APPROX coordinate descent,
its self-dual form, and the ALM / AALM / ADCD outer loops over it)."""

from cholesky_is_magic_tpu_torch.solvers.affine import (
    AffineConfig,
    AffineState,
    affine_scaling,
    make_affine_state,
    make_affine_state_sparse,
)
from cholesky_is_magic_tpu_torch.solvers.alm import (
    ALMConfig,
    ALMState,
    aalm,
    adcd,
    alm,
    alm_iteration,
    make_alm,
)
from cholesky_is_magic_tpu_torch.solvers.approx import (
    ApproxProblem,
    approx,
    make_alm_subproblem,
    make_approx_selfdual,
)
from cholesky_is_magic_tpu_torch.solvers.crossover import (
    CrossoverConfig,
    classify_basis,
    crossover,
)
from cholesky_is_magic_tpu_torch.solvers.pdas import (
    PDASConfig,
    PDASState,
    make_pdas,
    make_pdas_sparse,
    pdas,
)
from cholesky_is_magic_tpu_torch.solvers.pdas_dd import (
    PDASDDState,
    make_pdas_dd,
    make_pdas_dd_sparse,
    pdas_dd,
)
from cholesky_is_magic_tpu_torch.solvers.result import SolveResult, Status

__all__ = [
    "ALMConfig",
    "ALMState",
    "ApproxProblem",
    "aalm",
    "adcd",
    "alm",
    "alm_iteration",
    "approx",
    "make_alm",
    "make_alm_subproblem",
    "make_approx_selfdual",
    "AffineConfig",
    "AffineState",
    "affine_scaling",
    "classify_basis",
    "crossover",
    "CrossoverConfig",
    "make_affine_state",
    "make_affine_state_sparse",
    "PDASConfig",
    "PDASState",
    "PDASDDState",
    "SolveResult",
    "Status",
    "make_pdas",
    "make_pdas_dd",
    "make_pdas_dd_sparse",
    "make_pdas_sparse",
    "pdas",
    "pdas_dd",
]
