"""Primal affine scaling (Dikin interior point), dense and fully sparse.

Counterpart of ``cholesky_is_magic_tpu/solvers/affine.py`` (reference:
affine-scaling.lisp), with every safeguard of the reference:

- the interior initialization, widening degenerate intervals by
  (-5e-7, +5e7) (make-affine-state, :52-90);
- the Dikin projection min ||x + D c|| s.t. A D x = 0 through one scaled
  normal-equations solve per step (project, :98-116), on whichever backend
  the operand set selects (solvers.backend);
- gamma = 0.9 step damping and the masked ratio test (max-step, :120-133);
- slack clamped at *max-slack* = 1e8 (:118, 137-148), and one retry at
  sqrt(max-slack) when the factorization fails;
- the centering retry when a step stalls, and a centering step every 16
  iterations (:192-204, :283);
- feasibility-repair least-squares steps while ||Ax - b|| > 1e-6·m
  (:226-263);
- the "singular" and "Unbounded problem" exits (:178-181, :187-188) as
  status codes.

The JAX package runs the solve as one jitted ``lax.while_loop`` whose
branches are ``lax.cond``s; here it is an eager host loop over device
tensors, and every ``lax.cond`` is a host branch, so each iteration runs
only the factorizations of the branch it takes.  The loop reads its
condition and the repair test in one transfer per iteration; an optimize
step adds the factorization's ok (the slack-cap retry) and, off the
centering schedule, the stop and stall tests in one more transfer.

A batch (``parallel.batched_affine``, the JAX ``jax.vmap`` of this loop)
runs :func:`_affine_lanes`: each iteration vmaps the one-lane iteration with
``per_lane``, in which every ``lax.cond`` computes both branches and selects
per lane, as under ``jax.vmap``: the repair and the optimize step, the
slack-cap retry and the stall retry (five normal solves an iteration), with
one host read an iteration.

``mesh=`` runs the loop on every rank of a ('dp', 'tp') DeviceMesh with
every projection and repair solve over its 'tp' axis: a dense LP held by
columns (parallel.sharded), or the fully sparse engine's factorizations
sharded.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from cholesky_is_magic_tpu_torch.ingest.device import DeviceLP, SparseKKTLP
from cholesky_is_magic_tpu_torch.solvers.backend import (
    check_backend,
    mv_rmv as _mv_rmv,
    row_boost as _row_boost,
    shard_for,
    solve_normal_backend as _solve_normal_backend,
)
from cholesky_is_magic_tpu_torch.solvers.result import SolveResult, Status
from cholesky_is_magic_tpu_torch.utils.precision import highest_precision

BIG_BOUND = 1e10  # "effectively infinite" bound threshold (affine-scaling.lisp:67-75)


@dataclasses.dataclass(frozen=True)
class AffineConfig:
    """The JAX package's AffineConfig, field for field."""

    gamma: float = 0.9  # *gamma* (affine-scaling.lisp:135)
    max_slack: float = 1e8  # *max-slack* (:118)
    residual_tol: float = 1e-6  # repair/convergence threshold per row (:249,287)
    direction_tol: float = 1e-6  # stop when ||dg|| below this (:193)
    step_tol: float = 1e-6  # recenter when step*||g|| below this (:200)
    unbounded_step: float = 1e10  # error threshold (:187)
    recenter_every: int = 16  # driver recentering cadence (:283)
    max_iters: int = 500
    refine_steps: int = 1  # dd iterative-refinement steps per solve
    # Record per-iteration (objective, residual norm, ||x_next - x||) into
    # result.extra["trace"] (the reference's per-iteration stdout lines,
    # affine-scaling.lisp:189-191, 254-263).
    record_trace: bool = False


@dataclasses.dataclass(frozen=True)
class AffineState:
    x: torch.Tensor
    # The operand set with the widened bounds of make_affine_state.
    lp: DeviceLP | SparseKKTLP


def make_affine_state(lp, x0: Optional[torch.Tensor] = None) -> AffineState:
    """Interior initialization (make-affine-state, affine-scaling.lisp:52-90).

    Degenerate intervals (u - l < 1e-6) are widened to (l - 5e-7, u + 5e7),
    the reference's asymmetric widening at :61-62; x starts at the center
    of finite boxes, or pulled inside one-sided boxes.  ``x0`` warm-starts
    from a prior iterate, nudged strictly interior.  Padded columns keep
    their inert (-1, 1, x = 0) setup.
    """
    l, u, mask = lp.l, lp.u, lp.col_mask
    degenerate = mask & ((u - l) < 1e-6)
    l = torch.where(degenerate, l - 5e-7, l)
    u = torch.where(degenerate, u + 5e7, u)
    delta = u - l
    both_free = (l < -BIG_BOUND) & (u > BIG_BOUND)
    low_free = l < -BIG_BOUND
    high_free = u > BIG_BOUND
    x = torch.where(
        both_free,
        0.0,
        torch.where(
            low_free,
            u - torch.minimum(delta / 2, 1.0 + 0.1 * torch.abs(u)),
            torch.where(
                high_free,
                l + torch.minimum(delta / 2, 1.0 + 1.0 * torch.abs(l)),  # :75 uses 1.0*|l|
                (l + u) / 2,
            ),
        ),
    )
    x = torch.where(mask, x, 0.0)
    lp = dataclasses.replace(lp, l=torch.where(mask, l, lp.l),
                             u=torch.where(mask, u, lp.u))
    if x0 is not None:
        x = _into_interior(torch.where(mask, x0, 0.0), lp.l, lp.u, mask)
    return AffineState(x=x, lp=lp)


def make_affine_state_sparse(
    sf,
    block: int = 128,
    dtype=None,
    snode_align: bool = True,
    x0: Optional[torch.Tensor] = None,
    device="cuda",
):
    """StandardForm -> (AffineState over a fully sparse SparseKKTLP, engine).

    ELL (and, where the byte gates admit them, block-ELL) operands for A
    and Aᵀ, a pair-schedule tile engine (sparse.tiled.engine_for_sparse)
    and the make-affine-state initialization; no dense (m, n) operand is
    built.  Pass the engine to affine_scaling(..., engine=...).  Unlike
    make_pdas_sparse the rows are NOT equilibrated (the reference's affine
    driver runs on the raw standard form; scale-constraints is pdas-only,
    primal-dual-affine-scaling.lisp:50-73), so the engine is built on the
    raw A and an engine of make_pdas_sparse, whose schedule bakes the
    scaled weights, cannot serve here.
    """
    import scipy.sparse as sp

    from cholesky_is_magic_tpu_torch.ops import bell, sparse_ops
    from cholesky_is_magic_tpu_torch.sparse.tiled import engine_for_sparse

    if dtype is None:
        dtype = torch.float32
    m, n = sf.ncons, sf.nvars
    A = sp.csc_matrix((sf.a_vals, (sf.a_rows, sf.a_cols)), shape=(m, n))
    engine = engine_for_sparse(A, block=block, snode_align=snode_align,
                               dtype=dtype, device=device)
    kw = dict(dtype=dtype, device=device)
    E = sparse_ops.from_coo(sf.a_rows, sf.a_cols, sf.a_vals, (m, n), **kw)
    ET = sparse_ops.from_coo(sf.a_cols, sf.a_rows, sf.a_vals, (n, m), **kw)
    EB = bell.from_coo(sf.a_rows, sf.a_cols, sf.a_vals, (m, n), **kw)
    ETB = bell.from_coo(sf.a_cols, sf.a_rows, sf.a_vals, (n, m), **kw)
    big = 1e30
    put = lambda v: torch.as_tensor(np.asarray(v, np.float64)).to(**kw)  # noqa: E731
    ones = lambda k: torch.ones(k, dtype=torch.bool, device=device)  # noqa: E731
    lp = SparseKKTLP(
        E=E, ET=ET, c=put(sf.c), b=put(sf.b),
        l=put(np.clip(sf.l, -big, big)), u=put(np.clip(sf.u, -big, big)),
        row_mask=ones(m), col_mask=ones(n), m=m, n=n, EB=EB, ETB=ETB,
    )
    return make_affine_state(lp, x0), engine


def _into_interior(x, l, u, mask):
    """Pull x strictly inside [l, u] by a relative epsilon (the reference
    asserts strict interiority; in floating point an iterate can land on a
    bound, after which every ratio test returns 0)."""
    eps = 1e-12 if x.dtype == torch.float64 else 1e-6
    margin = eps * torch.clamp_max(u - l, 1.0)
    xi = torch.clamp(x, l + margin, u - margin)
    xi = torch.where(u - l < 2 * margin, 0.5 * (l + u), xi)
    return torch.where(mask, xi, x)


def _slack(l, x, u, cap, mask):
    """min(cap, x - l, u - x), 1 on masked entries (slack, :137-148)."""
    s = torch.clamp_max(torch.minimum(x - l, u - x), cap)
    return torch.where(mask, torch.clamp_min(s, 1e-30), 1.0)


def _centering_direction(l, x, u, mask):
    """Pull toward the nearer bound's opposite (:150-163)."""
    both_inf = (l <= -BIG_BOUND) & (u >= BIG_BOUND)
    toward_upper = (x - l) < (u - x)
    d = torch.where(
        both_inf,
        0.0,
        torch.where(
            toward_upper,
            torch.clamp_max(u - x, 1.0),
            torch.clamp_min(l - x, -1.0),
        ),
    )
    return torch.where(mask, d, 0.0)


def _max_step(l, x, u, g, mask):
    """Masked ratio test (max-step, :120-133): largest t with
    l <= x + t·g <= u, each ratio clamped at >= 0."""
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    step = torch.where(
        g == 0,
        inf,
        torch.clamp_min(torch.where(g < 0, (l - x) / g, (u - x) / g), 0.0),
    )
    step = torch.where(mask, step, inf)
    return torch.min(step)


def _project(lp, scale, c_dir, refine_steps, engine=None, per_lane=False,
             mesh=None):
    """min ||x + [scale]c||  s.t. A[scale]x = 0  (project, :98-116).

    Returns (dg, ok): dg = sc - (AD)ᵀ N⁻¹ (AD) sc with sc = -scale·c and
    N = (AD)(AD)ᵀ, solved on the backend the operand set selects
    (AD·v = A(scale∘v), (AD)ᵀy = scale∘(Aᵀy))."""
    mv, rmv = _mv_rmv(lp)
    sc = -(scale * c_dir)
    v = mv(scale * sc)
    boost = _row_boost(lp)
    y, ok = _solve_normal_backend(lp, engine, scale, v, boost, refine_steps,
                                  per_lane, mesh)
    dg = sc - scale * rmv(y)
    return torch.where(lp.col_mask, dg, 0.0), ok


def _residual(lp, x):
    mv, _ = _mv_rmv(lp)
    return lp.b - mv(x)


def _scaling_step(state: AffineState, centering, cfg: AffineConfig,
                  engine=None, per_lane: bool = False, mesh=None):
    """one-affine-scaling-iteration (:165-207) minus the recursion; returns
    (new_x, ok, unbounded, step, norm_g, norm_dg, descent).  ``centering``
    is a host bool; a failed factorization is retried once (a host branch)
    at the repair-sized slack cap sqrt(max_slack), since the 1e8 cap on
    free variables scales their share of N by 1e16 and can make the
    Cholesky numerically rank-deficient, where the reference prints
    " singular " and stops.  ``per_lane`` (a lane under ``torch.func.vmap``):
    ``centering`` may be a 0-dim bool tensor, and the retry is computed
    always and selected where the first factorization failed."""
    lp, x = state.lp, state.x
    if isinstance(centering, torch.Tensor):
        c_dir = torch.where(centering,
                            _centering_direction(lp.l, x, lp.u, lp.col_mask),
                            lp.c)
    else:
        c_dir = (_centering_direction(lp.l, x, lp.u, lp.col_mask) if centering
                 else lp.c)
    slack = _slack(lp.l, x, lp.u, cfg.max_slack, lp.col_mask)
    dg, ok = _project(lp, slack, c_dir, cfg.refine_steps, engine, per_lane,
                      mesh)
    if per_lane or not bool(ok):
        slack2 = _slack(lp.l, x, lp.u, math.sqrt(cfg.max_slack), lp.col_mask)
        dg2, ok2 = _project(lp, slack2, c_dir, cfg.refine_steps, engine,
                            per_lane, mesh)
        if per_lane:
            slack, dg = torch.where(ok, slack, slack2), torch.where(ok, dg, dg2)
            ok = ok | ok2
        else:
            slack, dg, ok = slack2, dg2, ok2
    g = dg * slack
    step = cfg.gamma * _max_step(lp.l, x, lp.u, g, lp.col_mask)
    norm_g = torch.linalg.norm(g)
    norm_dg = torch.linalg.norm(dg)
    descent = torch.dot(g, lp.c)
    unbounded = step > cfg.unbounded_step
    new_x = x + torch.clamp_max(step, cfg.unbounded_step) * g
    new_x = _into_interior(new_x, lp.l, lp.u, lp.col_mask)
    return new_x, ok, unbounded, step, norm_g, norm_dg, descent


def _optimize_iteration(state: AffineState, centering, cfg: AffineConfig,
                        engine=None, per_lane: bool = False, mesh=None):
    """The optimize/recenter path with the stall retry: a non-centering
    step that stalls (step·||g|| < tol) is redone once as a centering step
    (:200-204).  Returns (x, cont, status) as 0-dim tensors.  ``per_lane``
    (a lane under ``torch.func.vmap``, ``centering`` a 0-dim bool tensor):
    the stop and stall tests select between the step, the stop and the
    centering retry, all computed."""
    lp, x0 = state.lp, state.x
    new_x, ok, unbounded, step, norm_g, norm_dg, descent = _scaling_step(
        state, centering, cfg, engine, per_lane, mesh)
    # The true variable count, not the padded length
    # (affine-scaling.lisp:193-194 uses (length x)).
    n_rows = torch.tensor(lp.n, dtype=x0.dtype, device=x0.device)
    converged_dir = norm_dg < torch.clamp_max(1e-8 * n_rows, cfg.direction_tol)
    # Early exits apply to optimize steps only (:192-199).
    stop = converged_dir | (descent > 0)
    stalled = (step * norm_g) < cfg.step_tol
    if per_lane:
        cx, cok, cunb, *_ = _scaling_step(state, True, cfg, engine, per_lane)
        plain = centering | (~stop & ~stalled)
        retry = ~centering & ~stop & stalled
        rx = torch.where(plain, new_x, torch.where(retry, cx, x0))
        rok = torch.where(retry, cok, ok)
        runb = torch.where(retry, cunb, unbounded)
        cont = centering | ~stop
    else:
        rx, rok, runb, cont = new_x, ok, unbounded, True
        if not centering:
            stop, stalled = torch.stack([stop, stalled]).tolist()
            if stop:
                rx, cont = x0, False
            elif stalled:
                rx, rok, runb, *_ = _scaling_step(state, True, cfg, engine,
                                                  mesh=mesh)
    # A singular projection aborts (:178-181).
    cont = cont & rok
    status = torch.where(
        ~rok, Status.SINGULAR,
        torch.where(runb, Status.UNBOUNDED, Status.RUNNING),
    ).to(torch.int32)
    return torch.where(rok & ~runb, rx, x0), cont, status


def _repair_iteration(state: AffineState, residual, cfg: AffineConfig,
                      engine=None, per_lane: bool = False, mesh=None):
    """Least-squares step back toward Ax = b (one-repair-iteration,
    :226-243): dg = (AD)ᵀ N⁻¹ r, step = gamma·min(max-step, 1/gamma).
    Returns (x, cont, status)."""
    lp, x = state.lp, state.x
    slack = _slack(lp.l, x, lp.u, math.sqrt(cfg.max_slack), lp.col_mask)
    _, rmv = _mv_rmv(lp)
    boost = _row_boost(lp)
    y, ok = _solve_normal_backend(lp, engine, slack, residual, boost,
                                  cfg.refine_steps, per_lane, mesh)
    dg = torch.where(lp.col_mask, slack * rmv(y), 0.0)
    g = dg * slack
    step = cfg.gamma * torch.clamp_max(
        _max_step(lp.l, x, lp.u, g, lp.col_mask), 1.0 / cfg.gamma)
    new_x = torch.where(
        ok, _into_interior(x + step * g, lp.l, lp.u, lp.col_mask), x)
    status = torch.where(ok, Status.RUNNING, Status.SINGULAR).to(torch.int32)
    return new_x, ok, status


def affine_scaling(
    state: AffineState,
    config: Optional[AffineConfig] = None,
    engine=None,
    mesh=None,
) -> SolveResult:
    """The driver loop (affine-scaling, :265-297).

    ``engine`` is the tile engine of a state built by
    :func:`make_affine_state_sparse` (required there: every normal solve
    runs on it and every product on the ELL / block-ELL operands), or on a
    dense state a sparse engine of its A (``sparse.engine_for``,
    ``BlockSparseCholesky``), which then runs every normal solve.
    ``mesh`` (every rank of the mesh makes the call) runs every normal
    solve over its 'tp' axis: a dense state's LP held by columns
    (parallel.sharded), a fully sparse state's engine sharded.  Every rank
    returns the whole result."""
    cfg = config or AffineConfig()
    check_backend(state.lp, engine, mesh)
    state = dataclasses.replace(state, lp=shard_for(state.lp, mesh))
    return _affine_loop(state, cfg, engine, mesh)


@highest_precision
def _affine_loop(state: AffineState, cfg: AffineConfig, engine,
                 mesh=None) -> SolveResult:
    lp = state.lp
    dt, dev = state.x.dtype, state.x.device
    tol = (torch.tensor(cfg.residual_tol, dtype=dt, device=dev)
           * torch.tensor(lp.m, dtype=dt, device=dev))
    rows = cfg.max_iters if cfg.record_trace else 0
    trace = [torch.full((rows,), float("nan"), dtype=dt, device=dev)
             for _ in range(3)]
    x = state.x
    i = 0
    cont = True
    status = torch.tensor(Status.RUNNING, dtype=torch.int32, device=dev)
    while i < cfg.max_iters:
        # The JAX loop's condition and its next body compute the same
        # residual; here it is computed once.
        residual = _residual(lp, x)
        norm = torch.linalg.norm(residual)
        needs = norm > tol
        # Driver stop (:284-291): stop when the last iteration said stop AND
        # the iterate is feasible, or on a fatal status.
        go, needs_repair = torch.stack([
            (cont | needs) & (status == Status.RUNNING), needs,
        ]).tolist()
        if not go:
            break
        st = AffineState(x=x, lp=lp)
        if needs_repair:
            new_x, cont, status = _repair_iteration(st, residual, cfg, engine,
                                                    mesh=mesh)
        else:
            centering = (i + 1) % cfg.recenter_every == 0  # driver :283
            new_x, cont, status = _optimize_iteration(st, centering, cfg,
                                                      engine, mesh=mesh)
        if cfg.record_trace:
            vals = (torch.dot(x, lp.c), norm, torch.linalg.norm(new_x - x))
            for buf, v in zip(trace, vals):
                buf[i] = v
        x, i = new_x, i + 1

    resid = torch.linalg.norm(_residual(lp, x))
    feasible = resid <= tol
    final_status = torch.where(
        status != Status.RUNNING,
        status,
        torch.where(
            feasible & ~torch.as_tensor(cont, device=dev),
            Status.OPTIMAL,
            Status.MAX_ITERS if i >= cfg.max_iters else Status.OPTIMAL,
        ),
    ).to(torch.int32)
    return SolveResult(
        x=x,
        objective=torch.dot(x, lp.c),
        status=final_status,
        iterations=torch.tensor(i, dtype=torch.int32),
        residual_norm=resid,
        extra={
            "trace": {
                "objective": trace[0], "residual": trace[1], "step": trace[2],
            },
        },
    )


class _LaneCarry(NamedTuple):
    """A lane's carry in :func:`_affine_lanes`: (B,) tensors in a batch."""

    cont: torch.Tensor  # the last iteration said go on
    status: torch.Tensor
    count: torch.Tensor  # iterations taken (the centering schedule)
    residual: torch.Tensor  # b - A x of the current iterate
    norm: torch.Tensor  # its 2-norm


@highest_precision
def _affine_lanes(states: AffineState, cfg: AffineConfig,
                  engine=None) -> SolveResult:
    """:func:`_affine_loop` over stacked states (every tensor with a
    leading lane axis) by ``solvers.pdas._lane_loop``: each iteration vmaps
    the one-lane iteration with ``per_lane``: the repair and the optimize
    step both computed and selected by the lane's own residual test, its
    centering schedule from its own count; a lane that has stopped keeps its
    iterate.  One host read per iteration.  Returns one SolveResult whose
    tensors have the lane axis first."""
    from cholesky_is_magic_tpu_torch.solvers.pdas import _lane_loop
    from cholesky_is_magic_tpu_torch.utils import lanes

    check_backend(states.lp, engine, None)
    dt, dev = states.x.dtype, states.x.device
    m = states.lp.m
    tol = (torch.tensor(cfg.residual_tol, dtype=dt, device=dev)
           * torch.tensor(m, dtype=dt, device=dev))
    B = states.x.shape[0]
    rows = cfg.max_iters if cfg.record_trace else 0
    trace = [torch.full((B, rows), float("nan"), dtype=dt, device=dev)
             for _ in range(3)]

    def start(st):
        residual = _residual(st.lp, st.x)
        return _LaneCarry(
            cont=torch.ones((), dtype=torch.bool, device=dev),
            status=torch.tensor(Status.RUNNING, dtype=torch.int32, device=dev),
            count=torch.zeros((), dtype=torch.int32, device=dev),
            residual=residual, norm=torch.linalg.norm(residual))

    def keep_going(c):
        # The loop's stop (:284-291), as in _affine_loop.
        return (c.cont | (c.norm > tol)) & (c.status == Status.RUNNING)

    def step(st, c):
        centering = (c.count + 1) % cfg.recenter_every == 0  # :283
        repair = _repair_iteration(st, c.residual, cfg, engine, per_lane=True)
        optimize = _optimize_iteration(st, centering, cfg, engine,
                                       per_lane=True)
        needs = c.norm > tol
        new_x, cont, status = (torch.where(needs, r, o)
                               for r, o in zip(repair, optimize))
        residual = _residual(st.lp, new_x)
        vals = (torch.dot(st.x, st.lp.c), c.norm,
                torch.linalg.norm(new_x - st.x))
        return (dict(x=new_x),
                _LaneCarry(cont=cont, status=status, count=c.count + 1,
                           residual=residual,
                           norm=torch.linalg.norm(residual)),
                vals)

    def finish(st, c):
        feasible = c.norm <= tol
        final = torch.where(
            c.status != Status.RUNNING,
            c.status,
            torch.where(
                feasible & ~c.cont,
                Status.OPTIMAL,
                torch.where(c.count >= cfg.max_iters, Status.MAX_ITERS,
                            Status.OPTIMAL),
            ),
        ).to(torch.int32)
        return dict(x=st.x, objective=torch.dot(st.x, st.lp.c), status=final,
                    residual_norm=c.norm)

    out, i, trace = _lane_loop(cfg, states, lanes.vmap(start, states), step,
                               finish, trace, keep_going=keep_going)
    return SolveResult(
        x=out["x"], objective=out["objective"], status=out["status"],
        iterations=i, residual_norm=out["residual_norm"],
        extra={"trace": {"objective": trace[0], "residual": trace[1],
                         "step": trace[2]}},
    )
