"""Dense normal-equations Cholesky: factor, solve, refine, detect failure.

Counterpart of ``cholesky_is_magic_tpu/ops/dense.py`` (the dense rendering of
the reference's CHOLMOD pipeline, sparse-cholesky.lisp:409-431, 524-560):

- :func:`normal_matrix` assembles N = (A·diag(d))·(A·diag(d))ᵀ;
- :func:`factorize` computes L·Lᵀ = N and reports failure as ``ok=False``
  (``torch.linalg`` by default; the blocked potrf or the plain blocked
  factorization of ops.chol on request);
- :func:`prepare_normal` factors once and returns a refined solve, with the
  dbound singular-retry and double-word refinement.

The factorization and triangular solves are ``torch.linalg`` (the JAX
package leaves them to XLA's library Cholesky too); the refinement
residuals run through the double-word kernels of :mod:`.dd`.  Where the JAX
package branches with ``lax.cond`` (the dbound retry), the port branches in
Python on a 0-dim tensor, which costs one host sync per factorization; with
``per_lane=True`` (a lane of a batched solve under ``torch.func.vmap``) it
computes both branches and selects per lane, as ``lax.cond`` does under
``jax.vmap``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from cholesky_is_magic_tpu_torch.ops import dd as ddm


class CholFactors(NamedTuple):
    L: torch.Tensor  # lower-triangular factor (identity if ok=False)
    ok: torch.Tensor  # 0-dim bool: factorization succeeded


def _scaled_normal(A, d, row_boost):
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
    x = chol_solve(f.L, b)
    for _ in range(refine_steps):
        r = ddm.dd_residual(b, N, x)
        x = x + chol_solve(f.L, r)
    return torch.where(f.ok, x, torch.zeros_like(x)), f.ok


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


def unassembled_refinement(raw_solve, AD, row_boost, ok, refine_steps: int,
                           krylov_steps: int = 0, krylov_gate=None,
                           per_lane: bool = False):
    """The solve_fn of a factor-once sparse engine on a dense A: ``raw_solve``
    (its triangular solves) refined by ``refine_steps`` Richardson steps
    against the UNASSEMBLED operator (:func:`operator_residual`), or with
    ``krylov_steps`` > 0 by flexible PCG with ``raw_solve`` as the
    preconditioner, per call when ``krylov_gate`` is given (both paths and
    a select in a lane, ``per_lane``); zero where the factorization failed
    (``ok`` False)."""

    def richardson_fn(g):
        y = raw_solve(g)
        for _ in range(refine_steps):
            y = y + raw_solve(operator_residual(AD, y, g, row_boost))
        return torch.where(ok, y, torch.zeros_like(y))

    if krylov_steps == 0:
        return richardson_fn
    from cholesky_is_magic_tpu_torch.ops import krylov

    def pcg_fn(g):
        x = krylov.pcg_refine(
            precond=raw_solve,
            apply_n=krylov.dense_normal_apply(AD, row_boost),
            residual_dd=krylov.dense_residual_dd(AD, g, row_boost),
            b=g,
            iters=krylov_steps,
        )
        return torch.where(ok, x.to_working(), torch.zeros_like(g))

    return krylov.gated(pcg_fn, richardson_fn, krylov_gate, per_lane=per_lane)


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
    f = factorize(N, blocked=blocked)
    if dbound > 0.0 and (per_lane or not bool(f.ok)):
        jitter = dbound * torch.max(torch.diagonal(N))
        eye = torch.eye(N.shape[0], dtype=N.dtype, device=N.device)
        retry = factorize(N + jitter * eye, blocked=blocked)
        f = retry if not per_lane else CholFactors(
            L=torch.where(f.ok, f.L, retry.L),
            ok=torch.where(f.ok, f.ok, retry.ok))

    if blocked:
        eye = torch.eye(N.shape[0], dtype=N.dtype, device=N.device)
        W = torch.linalg.solve_triangular(f.L, eye, upper=False)

        def solve1(g):
            return W.T @ (W @ g)
    else:
        def solve1(g):
            return chol_solve(f.L, g)

    def richardson_fn(g):
        y = solve1(g)
        for _ in range(refine_steps):
            if true_residual:
                r = operator_residual(AD, y, g, row_boost)
            else:
                r = ddm.dd_residual(g, N, y)
            y = y + solve1(r)
        return torch.where(f.ok, y, torch.zeros_like(y))

    if krylov_steps > 0:
        from cholesky_is_magic_tpu_torch.ops import krylov

        def pcg_fn(g):
            x = krylov.pcg_refine(
                precond=solve1,
                apply_n=krylov.dense_normal_apply(AD, row_boost),
                residual_dd=krylov.dense_residual_dd(AD, g, row_boost),
                b=g,
                iters=krylov_steps,
            )
            y = x.to_working()
            return torch.where(f.ok, y, torch.zeros_like(y))

        return (krylov.gated(pcg_fn, richardson_fn, krylov_gate,
                             per_lane=per_lane), f.ok)

    return richardson_fn, f.ok


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
