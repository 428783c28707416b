r"""Primal-dual KKT Newton direction by block Gaussian elimination.

Counterpart of ``cholesky_is_magic_tpu/kkt/newton.py``: the dense
operator over ops.dense and the fully sparse one over the tile engine
(:func:`ell_kkt_operator`).  Eliminating Δw, Δx, Δz from the KKT block system
(sparse-newton-solve.lisp:1-26) leaves one SPD normal-equations solve

    (A·diag(s))·(A·diag(s))ᵀ Δy = g - A·alpha,     s = sqrt(beta),

and back-substitution recovers Δx, Δw, Δz — with the reference's filters
for near-unbounded variables (a slack above 1e7 means that bound is absent,
sparse-newton-solve.lisp:30-45).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from cholesky_is_magic_tpu_torch.ops import dense as dense_ops

# Slack threshold above which a bound is treated as absent
# (sparse-newton-solve.lisp:34,43).
FILTER_THRESHOLD = 1e7


class KKTOperator(NamedTuple):
    """The products the elimination needs.

    mv:  v -> A v;  rmv: v -> Aᵀ v
    solve_scaled_normal: (s, g) -> (y, ok) solving (A diag s)(A diag s)ᵀ y = g
    prepare_scaled_normal: s -> (solve_fn, ok) — factor once, solve many.
    """

    mv: Callable[[torch.Tensor], torch.Tensor]
    rmv: Callable[[torch.Tensor], torch.Tensor]
    solve_scaled_normal: Callable
    prepare_scaled_normal: Optional[Callable] = None


def dense_kkt_operator(
    A: torch.Tensor,
    row_boost: Optional[torch.Tensor] = None,
    refine_steps: int = 1,
    true_residual: bool = False,
    dbound: float = 0.0,
    krylov_steps: int = 0,
    krylov_gate=None,
    per_lane: bool = False,
) -> KKTOperator:
    """Dense operator over ops.dense (dbound retry, refinement, optional
    gated PCG; ``per_lane``: both branches selected per lane, for a lane
    under ``torch.func.vmap``)."""

    def prepare_scaled_normal(s):
        return dense_ops.prepare_normal(
            A, s, row_boost=row_boost, refine_steps=refine_steps,
            true_residual=true_residual, dbound=dbound,
            krylov_steps=krylov_steps, krylov_gate=krylov_gate,
            per_lane=per_lane,
        )

    def solve_scaled_normal(s, g):
        solve_fn, ok = prepare_scaled_normal(s)
        return solve_fn(g), ok

    return KKTOperator(
        mv=lambda v: A @ v,
        rmv=lambda v: A.T @ v,
        solve_scaled_normal=solve_scaled_normal,
        prepare_scaled_normal=prepare_scaled_normal,
    )


def ell_kkt_operator(
    lp,
    engine,
    row_boost: Optional[torch.Tensor] = None,
    refine_steps: int = 1,
    dbound: float = 0.0,
    krylov_steps: int = 0,
    krylov_gate=None,
    per_lane: bool = False,
) -> KKTOperator:
    """Fully sparse operator: ELL / block-ELL products and the tile
    engine's pair-schedule assembly and factorization
    (sparse.tiled.engine_for_sparse).  No dense A operand anywhere — ``lp``
    is an ingest.device.SparseKKTLP.  ``per_lane``: a lane under
    ``torch.func.vmap`` (the dbound retry and the Krylov gate selected per
    lane)."""
    from cholesky_is_magic_tpu_torch.ops import bell, sparse_ops

    def prepare_scaled_normal(s):
        return engine.prepare_normal_ell(
            lp.E, lp.ET, s, lp.m, row_boost=row_boost,
            refine_steps=refine_steps, dbound=dbound,
            krylov_steps=krylov_steps, krylov_gate=krylov_gate,
            EB=lp.EB, ETB=lp.ETB, per_lane=per_lane,
        )

    def solve_scaled_normal(s, g):
        solve_fn, ok = prepare_scaled_normal(s)
        return solve_fn(g), ok

    mv = ((lambda v: bell.matvec(lp.EB, v)) if lp.EB is not None
          else (lambda v: sparse_ops.matvec(lp.E, v)))
    rmv = ((lambda v: bell.matvec(lp.ETB, v)) if lp.ETB is not None
           else (lambda v: sparse_ops.matvec(lp.ET, v)))
    return KKTOperator(
        mv=mv,
        rmv=rmv,
        solve_scaled_normal=solve_scaled_normal,
        prepare_scaled_normal=prepare_scaled_normal,
    )


class KKTDeltas(NamedTuple):
    dw: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    ok: torch.Tensor  # False if the normal-equations factorization failed


class KKTReduction(NamedTuple):
    """Intermediates of the block elimination: what turns the normal
    solution dy back into (dw, dx, dz).  Split out so that pdas can share
    ONE factorization across its repair/recenter/newton branches."""

    s: torch.Tensor  # sqrt(beta): the normal-equations column scaling
    alpha: torch.Tensor
    beta: torch.Tensor
    use_u: torch.Tensor
    use_l: torch.Tensor


def kkt_reduce(sl, su, w, z, e, f, h) -> KKTReduction:
    """Elimination of (dw, dx, dz), per variable in closed form:

      dx = (t - h - e/su + f/sl) · beta,  beta = su·sl/(w·sl + z·su)
      (A·diag(beta)·Aᵀ) dy = g - A·alpha,  alpha = (-h - e/su + f/sl)·beta
      dw = (e + w·dx)/su,  dz = (f - z·dx)/sl,

    with the filtered rows degenerating to dw = w (resp. dz = z).
    """
    pu = su <= FILTER_THRESHOLD  # upper bound present
    pl = sl <= FILTER_THRESHOLD  # lower bound present
    both_absent = ~pu & ~pl
    use_u = pu | both_absent
    use_l = pl | both_absent

    a = torch.where(use_u, w / su, 0.0)
    term_w = torch.where(use_u, e / su, w)
    b = torch.where(use_l, z / sl, 0.0)
    term_z = torch.where(use_l, f / sl, z)

    beta = 1.0 / torch.clamp_min(a + b, 1e-30)  # a+b > 0 whenever w, z > 0
    alpha = (-h - term_w + term_z) * beta
    return KKTReduction(
        s=torch.sqrt(beta), alpha=alpha, beta=beta, use_u=use_u, use_l=use_l
    )


def kkt_backsub(red: KKTReduction, sl, su, w, z, e, f, dy, t, ok) -> KKTDeltas:
    """Back-substitution: recover (dw, dx, dz) from dy and t = Aᵀ dy."""
    dx = red.alpha + red.beta * t
    dw = torch.where(red.use_u, (e + w * dx) / su, w)
    dz = torch.where(red.use_l, (f - z * dx) / sl, z)
    return KKTDeltas(dw=dw, dx=dx, dy=dy, dz=dz, ok=ok)


def solve_kkt_newton(sl, su, w, z, op: KKTOperator, e, f, g, h) -> KKTDeltas:
    """kkt_reduce -> one scaled normal solve -> kkt_backsub.  Padded
    entries must be sanitized by the caller (sl = su = w = z = 1,
    e = f = h = 0 on padded columns, g = 0 on padded rows)."""
    red = kkt_reduce(sl, su, w, z, e, f, h)
    rhs = g - op.mv(red.alpha)
    dy, ok = op.solve_scaled_normal(red.s, rhs)
    t = op.rmv(dy)
    return kkt_backsub(red, sl, su, w, z, e, f, dy, t, ok)


def kkt_residuals(sl, su, w, z, op: KKTOperator, e, f, g, h,
                  deltas: KKTDeltas) -> torch.Tensor:
    """Inf-norms of the four KKT block residuals (test-kkt-solve,
    sparse-newton-solve.lisp:180-198)."""
    dw, dx, dy, dz = deltas.dw, deltas.dx, deltas.dy, deltas.dz
    r1 = su * dw - w * dx - e
    r2 = z * dx + sl * dz - f
    r3 = op.mv(dx) - g
    r4 = (op.rmv(dy) + dz) - dw - h
    inf = lambda v: torch.max(torch.abs(v))
    return torch.stack([inf(r1), inf(r2), inf(r3), inf(r4)])
