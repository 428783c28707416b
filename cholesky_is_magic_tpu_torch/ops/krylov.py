"""Krylov-accelerated iterative refinement for ill-conditioned normal solves.

Counterpart of ``cholesky_is_magic_tpu/ops/krylov.py``.
Flexible preconditioned CG on N x = b with the f32 Cholesky factor as the
preconditioner, the residual b - N·x recomputed explicitly in double-word
every iteration against the unassembled operator, and the iterate kept in
double-word.  It converges where plain Richardson refinement stops
(kappa(N) beyond ~1/eps_f32).  Guards as in the reference: a non-positive
curvature freezes the step, and the best-residual iterate is returned.

The JAX ``lax.fori_loop`` is a Python loop here and ``lax.cond`` in
:func:`gated` a Python branch on a 0-dim tensor (one host sync per solve),
or, for a lane of a batched solve, both paths selected per lane.
"""

from __future__ import annotations

from typing import Callable

import torch

from cholesky_is_magic_tpu_torch.ops import dd as ddm
from cholesky_is_magic_tpu_torch.ops.dd import DD
from cholesky_is_magic_tpu_torch.utils.spans import host_bool, span


def gated(pcg_fn, cheap_fn, gate, per_lane: bool = False):
    """Per-call choice between the PCG path and the cheap Richardson path
    on a 0-dim bool tensor ``gate`` (True -> PCG), sharing one
    factorization.  ``gate=None`` returns the PCG path unconditionally.
    ``per_lane`` (a lane under ``torch.func.vmap``) runs both paths and
    selects, as ``lax.cond`` does under ``jax.vmap``."""
    if gate is None:
        return pcg_fn

    def solve_fn(g):
        if per_lane:
            return torch.where(gate, pcg_fn(g), cheap_fn(g))
        return pcg_fn(g) if host_bool(gate) else cheap_fn(g)

    return solve_fn


def pcg_refine(
    precond: Callable[[torch.Tensor], torch.Tensor],
    apply_n: Callable[[torch.Tensor], torch.Tensor],
    residual_dd: Callable[[DD], torch.Tensor],
    b: torch.Tensor,
    iters: int,
    x0: torch.Tensor | None = None,
) -> DD:
    """Flexible PCG with explicit double-word residuals; returns x as DD.

    precond      r -> z: apply M⁻¹ (the recycled f32 Cholesky).
    apply_n      p -> q: apply N in working precision.
    residual_dd  DD x -> r: b - N·x evaluated in double-word.
    b            right-hand side; x0 = M⁻¹ b when ``x0`` is None.
    iters        fixed CG iteration count.
    """
    x_hi = precond(b) if x0 is None else x0
    x = ddm.dd_from(x_hi)
    with span("normal.refine"):
        r = residual_dd(x)
    z = precond(r)
    p = z
    rz = torch.dot(r, z)
    best_x, best_rnorm = x, torch.dot(r, r)
    for _ in range(iters):
        with span("normal.refine"):
            q = apply_n(p)
        pq = torch.dot(p, q)
        # Non-positive curvature: freeze this step (alpha = 0).
        alpha = torch.where(pq > 0.0, rz / torch.where(pq > 0.0, pq, 1.0), 0.0)
        x = ddm.dd_add(x, ddm.two_prod(p, alpha))
        with span("normal.refine"):
            r = residual_dd(x)
        z = precond(r)
        rz_new = torch.dot(r, z)
        beta = torch.where(rz > 0.0, rz_new / torch.where(rz > 0.0, rz, 1.0), 0.0)
        p = z + beta * p
        rz = rz_new
        rnorm = torch.dot(r, r)
        better = rnorm < best_rnorm
        best_x = ddm.dd_where(better, x, best_x)
        best_rnorm = torch.where(better, rnorm, best_rnorm)
    return best_x


def dense_normal_apply(AD: torch.Tensor, row_boost=None):
    """p -> (AD)(AD)ᵀ p + row_boost∘p in working precision."""

    def apply_n(p):
        q = AD @ (AD.T @ p)
        if row_boost is not None:
            q = q + row_boost * p
        return q

    return apply_n


def dense_residual_dd(AD: torch.Tensor, g: torch.Tensor, row_boost=None):
    """DD x -> g - (AD)(AD)ᵀx (- row_boost∘x) with the matvecs in
    double-word: the dd-iterate extension of ops.dense.operator_residual."""

    def residual(x: DD) -> torch.Tensor:
        t = ddm.dd_rmatvec_dd(AD, x)  # ADᵀ x, dd
        u = ddm.dd_add(ddm.dd_matvec(AD, t.hi), ddm.dd_matvec(AD, t.lo))
        if row_boost is not None:
            u = ddm.dd_add(u, ddm.two_prod(row_boost, x.hi))
            u = ddm.dd_add_w(u, row_boost * x.lo)
        return ddm.dd_add_w(ddm.dd_neg(u), g).to_working()

    return residual


def ell_normal_apply(E, ET, d, row_boost=None):
    """The fully sparse N-apply: p -> E(d²∘(ETp)) + boost∘p via two ELL
    products (ops.sparse_ops)."""
    from cholesky_is_magic_tpu_torch.ops import sparse_ops

    d2 = d * d

    def apply_n(p):
        t = sparse_ops.matvec(ET, p)
        q = sparse_ops.matvec(E, d2 * t)
        if row_boost is not None:
            q = q + row_boost * p
        return q

    return apply_n


def ell_residual_dd(E, ET, d, g, row_boost=None):
    """DD x -> g - A·diag(d²)·Aᵀx (- boost∘x) from sparse operands with
    the products in double-word (the prepare_normal_ell refinement
    residual, extended to a dd iterate)."""
    from cholesky_is_magic_tpu_torch.ops import sparse_ops

    d2 = ddm.two_prod(d, d)

    def residual(x: DD) -> torch.Tensor:
        t = sparse_ops.dd_matvec_dd(ET, x)  # Aᵀ x, dd
        u = ddm.dd_mul(d2, t)
        v = sparse_ops.dd_matvec_dd(E, u)
        if row_boost is not None:
            v = ddm.dd_add(v, ddm.two_prod(row_boost, x.hi))
            v = ddm.dd_add_w(v, row_boost * x.lo)
        return ddm.dd_add_w(ddm.dd_neg(v), g).to_working()

    return residual
