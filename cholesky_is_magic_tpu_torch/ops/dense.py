"""Dense normal-equations Cholesky: factor, solve, refine, detect failure.

Counterpart of ``cholesky_is_magic_tpu/ops/dense.py`` (the dense rendering of
the reference's CHOLMOD pipeline, sparse-cholesky.lisp:409-431, 524-560):

- :func:`normal_matrix` assembles N = (A·diag(d))·(A·diag(d))ᵀ;
- :func:`factorize` computes L·Lᵀ = N and reports failure as ``ok=False``
  (``torch.linalg`` by default; the blocked potrf or the plain blocked
  factorization of ops.chol on request);
- :func:`prepare_normal` factors once and returns a refined solve, with the
  dbound singular-retry and double-word refinement of :mod:`.normal`.

The factorization and triangular solves are ``torch.linalg`` (the JAX
package leaves them to XLA's library Cholesky too); the refinement
residuals run through the double-word kernels of :mod:`.dd`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from cholesky_is_magic_tpu_torch.ops import dd as ddm
from cholesky_is_magic_tpu_torch.ops import krylov, normal
from cholesky_is_magic_tpu_torch.utils.spans import count, span


class CholFactors(NamedTuple):
    L: torch.Tensor  # lower-triangular factor (identity if ok=False)
    ok: torch.Tensor  # 0-dim bool: factorization succeeded


def _scaled_normal(A, d, row_boost):
    with span("normal.assemble"):
        AD = A * d[None, :]
        N = AD @ AD.T
        # Symmetrize: the f32 product is not exactly symmetric.
        N = 0.5 * (N + N.T)
        if row_boost is not None:
            N = N + torch.diag(row_boost.to(N.dtype))
        return AD, N


def normal_matrix(
    A: torch.Tensor,
    d: torch.Tensor,
    row_boost: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """N = A·diag(d)²·Aᵀ (+ diag(row_boost)), the IPM normal matrix.
    ``row_boost`` is 1.0 on padded rows, keeping them nonsingular."""
    return _scaled_normal(A, d, row_boost)[1]


def factorize(N: torch.Tensor, use_pallas: bool = False,
              blocked: bool = False) -> CholFactors:
    """L·Lᵀ = N with failure detection.

    ``torch.linalg.cholesky_ex`` reports a non-PD input through ``info``
    and returns a partial factor that can look finite, so ``ok`` needs
    ``info == 0`` as well as the JAX package's finiteness and positive
    diagonal checks; a failed factor is replaced by the identity, as there.

    ``use_pallas`` (the JAX name) runs ops.chol.cholesky: on a CUDA tensor
    the hand-written blocked potrf, which works from global memory at any
    n (the JAX package's VMEM gate at n > 1536 does not carry over); on a
    CPU tensor ``blocked_cholesky``, as the JAX ``cholesky()`` does off the
    TPU.  Either gives NaN on a non-PD input, which the same finiteness
    check reports.  No solver sets it yet.

    ``blocked`` runs ``ops.chol.blocked_cholesky``, the statically recursive
    matmul-rich factorization, on any device, as in the JAX package
    (``use_pallas`` wins when both are set, as there).
    """
    count("normal.factorizations")
    with span("normal.factorize"):
        if use_pallas or blocked:
            from cholesky_is_magic_tpu_torch.ops import chol

            L = chol.cholesky(N) if use_pallas else chol.blocked_cholesky(N)
            info = torch.zeros((), dtype=torch.int32, device=N.device)
        else:
            L, info = torch.linalg.cholesky_ex(N)
        diag = torch.diagonal(L)
        ok = (info == 0) & torch.all(torch.isfinite(L)) & torch.all(diag > 0)
        eye = torch.eye(N.shape[0], dtype=N.dtype, device=N.device)
        return CholFactors(L=torch.where(ok, L, eye), ok=ok)


def rcond_estimate(L: torch.Tensor) -> torch.Tensor:
    """(min diag L / max diag L)², the cholmod_rcond diagonal-ratio estimate."""
    d = torch.abs(torch.diagonal(L))
    return (torch.min(d) / torch.max(d)) ** 2


def chol_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L·Lᵀ) x = b by two triangular solves."""
    count("normal.solves")
    with span("normal.solve"):
        y = torch.linalg.solve_triangular(L, b.unsqueeze(-1), upper=False)
        return torch.linalg.solve_triangular(L.T, y, upper=True).squeeze(-1)


def solve_spd(
    N: torch.Tensor,
    b: torch.Tensor,
    refine_steps: int = 1,
    factors: Optional[CholFactors] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve N x = b, N SPD, with double-word iterative refinement.
    Returns (x, ok)."""
    f = factorize(N) if factors is None else factors
    solve_fn = normal.refined_solve(functools.partial(chol_solve, f.L),
                                    functools.partial(_assembled_residual, N), f.ok,
                                    refine_steps)
    return solve_fn(b), f.ok


def _assembled_residual(N, y, g):
    # g - N·y in double-word against the assembled N.
    return ddm.dd_residual(g, N, y)


def operator_residual(
    AD: torch.Tensor,
    y: torch.Tensor,
    g: torch.Tensor,
    row_boost: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """g - AD·(ADᵀ·y) (- row_boost∘y) with the matvecs in double-word: the
    refinement residual against the UNASSEMBLED normal operator, which sees
    the f32 rounding of assembling N as well as the solve error."""
    t = ddm.dd_rmatvec(AD, y)
    u = ddm.dd_add(ddm.dd_matvec(AD, t.hi), ddm.dd_matvec(AD, t.lo))
    if row_boost is not None:
        u = ddm.dd_add_w(u, row_boost.to(y.dtype) * y)
    return ddm.dd_add_w(ddm.dd_neg(u), g).to_working()


def unassembled_operator(AD: torch.Tensor, row_boost: Optional[torch.Tensor] = None):
    """(residual, pcg) of ops.normal.refined_solve against the UNASSEMBLED
    operator (AD)(AD)ᵀ (+ diag(row_boost)): :func:`operator_residual` for
    Richardson, ops.krylov's dense N-apply and dd residual for PCG."""
    return (functools.partial(operator_residual, AD, row_boost=row_boost),
            (krylov.dense_normal_apply(AD, row_boost),
             functools.partial(krylov.dense_residual_dd, AD, row_boost=row_boost)))


def factorize_with_retry(N: torch.Tensor, dbound: float = 0.0, blocked: bool = False,
                         per_lane: bool = False) -> CholFactors:
    """:func:`factorize` with the dbound singular retry on
    N + dbound·max(diag N)·I (ops.normal.factor_with_retry)."""

    def factor(shift):
        f = factorize(N if shift is None else normal.shifted(N, shift), blocked=blocked)
        return (f.L,), f.ok

    (L,), ok = normal.factor_with_retry(factor, dbound, per_lane)
    return CholFactors(L=L, ok=ok)


def prepare_normal(
    A: torch.Tensor,
    d: torch.Tensor,
    row_boost: Optional[torch.Tensor] = None,
    refine_steps: int = 1,
    true_residual: bool = False,
    dbound: float = 0.0,
    krylov_steps: int = 0,
    krylov_gate=None,
    method: str = "direct",
    per_lane: bool = False,
):
    """Assemble and factor N = (A·diag(d))(A·diag(d))ᵀ ONCE; return
    (solve_fn, ok) where solve_fn(g) runs the refined triangular solves.

    ``dbound`` > 0 arms the singular-retry: when the plain Cholesky fails,
    refactor N + dbound·max(diag N)·I once; refinement still targets the
    unregularized operator.  ``true_residual`` refines against the
    unassembled operator (:func:`operator_residual`).  ``krylov_steps`` > 0
    replaces Richardson refinement by flexible PCG (ops.krylov), per call
    when ``krylov_gate`` (a 0-dim bool tensor) is given.

    ``method``: ``"direct"`` factors with ``cholesky_ex`` and solves by two
    triangular solves per right-hand side; ``"inverse"`` (the batched
    solves' kernel, as in the JAX package) factors with
    ``ops.chol.blocked_cholesky`` (its retry too), forms W = L⁻¹ once by a
    triangular solve against I, and solves by two products, Wᵀ(W·g).

    ``per_lane`` (for a lane under ``torch.func.vmap``): the retry is
    computed always and selected where the first factorization failed, and
    the Krylov gate selects between both paths, with no host read.  The
    results are the host branches' results.
    """
    if method not in ("direct", "inverse"):
        raise ValueError(f"prepare_normal: unknown method {method!r}")
    AD, N = _scaled_normal(A, d, row_boost)
    blocked = method == "inverse"
    L, ok = factorize_with_retry(N, dbound, blocked, per_lane)

    if blocked:
        with span("normal.factorize"):
            eye = torch.eye(N.shape[0], dtype=N.dtype, device=N.device)
            W = torch.linalg.solve_triangular(L, eye, upper=False)

        def solve1(g):
            count("normal.solves")
            with span("normal.solve"):
                return W.T @ (W @ g)
    else:
        solve1 = functools.partial(chol_solve, L)

    residual, pcg = unassembled_operator(AD, row_boost)
    if not true_residual:
        residual = functools.partial(_assembled_residual, N)

    return normal.refined_solve(solve1, residual, ok, refine_steps, krylov_steps,
                                krylov_gate, pcg, per_lane), ok


def solve_normal(
    A: torch.Tensor,
    d: torch.Tensor,
    g: torch.Tensor,
    row_boost: Optional[torch.Tensor] = None,
    refine_steps: int = 1,
    true_residual: bool = False,
    dbound: float = 0.0,
    krylov_steps: int = 0,
    krylov_gate=None,
    method: str = "direct",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve (A·diag(d))·(A·diag(d))ᵀ y = g with double-word refinement.
    Returns (y, ok); ok=False on singular N."""
    solve_fn, ok = prepare_normal(
        A, d, row_boost=row_boost, refine_steps=refine_steps,
        true_residual=true_residual, dbound=dbound,
        krylov_steps=krylov_steps, krylov_gate=krylov_gate, method=method,
    )
    return solve_fn(g), ok
