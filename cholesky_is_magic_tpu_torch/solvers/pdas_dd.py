"""Double-word-state PDAS: 1e-8 duality gaps on f32 hardware.

Counterpart of ``cholesky_is_magic_tpu/solvers/pdas_dd.py`` on dense
operands and on the fully sparse ones (:func:`make_pdas_dd_sparse`,
``engine=``).  The iterates x, y, w, z live in double-word form; the Newton
right-hand sides (slacks, complementarities, primal and dual residuals)
are evaluated in double-word, the A-products through the CUDA double-word
kernels on the card; only the Cholesky factorization runs in f32, and the
direction gets an outer double-word refinement on the recycled factor.
Updates accumulate error-free: state <- dd(state) - t * dx.

As in :mod:`.pdas`, the jitted ``lax.while_loop`` is an eager host loop
with the same carry and status codes, and ``lax.cond`` (the entry repair)
a Python branch.  ``engine=`` on a dense state (a sparse engine of its A)
runs every factorization through that engine (solvers.backend),
the entry repair's too, in the single loop and in every lane of the batched
one; Gondzio's correctors run in double-word as in the JAX package.
``mesh=`` runs the loop on every rank of a ('dp', 'tp') DeviceMesh: a dense
LP held by columns over 'tp' (the double-word products as per-rank dd
partials with hi and lo all-reduced apart, every factorization through
``parallel.sharded_prepare_normal``), or the fully sparse engine's
factorizations sharded over 'tp'.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from cholesky_is_magic_tpu_torch.ingest.device import DeviceLP, SparseKKTLP
from cholesky_is_magic_tpu_torch.kkt.newton import FILTER_THRESHOLD, factor_once_operator
from cholesky_is_magic_tpu_torch.ops import dd as ddm
from cholesky_is_magic_tpu_torch.ops.dd import DD
from cholesky_is_magic_tpu_torch.solvers.affine import _slack
from cholesky_is_magic_tpu_torch.solvers.backend import (
    check_backend,
    dd_linops,
    mv_rmv,
    prepare_normal_backend,
    shard_for,
)
from cholesky_is_magic_tpu_torch.solvers.pdas import (
    PDASConfig,
    PDASState,
    _bounced,
    _keep_going,
    _lane_loop,
    _lane_trace,
    _new_trace,
    make_pdas,
    make_pdas_sparse,
)
from cholesky_is_magic_tpu_torch.solvers.result import SolveResult, Status
from cholesky_is_magic_tpu_torch.utils import lanes
from cholesky_is_magic_tpu_torch.utils.precision import highest_precision
from cholesky_is_magic_tpu_torch.utils.spans import count, host_bool, span


@dataclasses.dataclass(frozen=True)
class PDASDDState:
    """PDAS state with double-word iterates."""

    x: DD
    y: DD
    w: DD
    z: DD
    lp: DeviceLP | SparseKKTLP


def make_pdas_dd(
    lp: DeviceLP,
    config: Optional[PDASConfig] = None,
    warm=None,
    recenter_duals: bool = True,
    warm_push: float = 0.0,
    warm_blend: float = 0.0,
) -> PDASDDState:
    """Promote the standard initialization to double-word.

    ``warm`` restarts from prior iterates — a PDASState, or a pdas()
    SolveResult (its x plus the y/w/z in extra): the pdas -> pdas_dd
    finisher flow.  ``recenter_duals`` (warm starts only, skipped when
    ``warm_blend`` > 0) resets the bound duals to the complementarity-
    balanced point w = mu/su, z = mu/sl.
    """
    if isinstance(warm, SolveResult):
        warm = PDASState(
            x=warm.x, y=warm.extra["y"], w=warm.extra["w"], z=warm.extra["z"],
            lp=None,
        )
    st = make_pdas(lp, config, warm=warm, warm_push=warm_push,
                   warm_blend=warm_blend)
    w, z = st.w, st.z
    if warm is not None and recenter_duals and warm_blend == 0.0:
        w, z = mu_recentered_duals(st.x, st.lp.l, st.lp.u, w, z, st.lp.col_mask)
    return PDASDDState(
        x=ddm.dd_from(st.x),
        y=ddm.dd_from(st.y),
        w=ddm.dd_from(w),
        z=ddm.dd_from(z),
        lp=st.lp,
    )


def mu_recentered_duals(x, l, u, w, z, mask):
    """Complementarity-balanced dual reset (see make_pdas_dd): w = mu/su,
    z = mu/sl with mu the average complementarity over present bounds."""
    floor = 1e-7 if x.dtype == torch.float32 else 1e-14
    sl = torch.where(mask, torch.clamp_min(x - l, floor), 1.0)
    su = torch.where(mask, torch.clamp_min(u - x, floor), 1.0)
    pu = mask & (su <= FILTER_THRESHOLD)
    pl = mask & (sl <= FILTER_THRESHOLD)
    terms = torch.sum(torch.where(pu, w * su, 0.0)) + torch.sum(
        torch.where(pl, z * sl, 0.0)
    )
    count = torch.clamp_min(torch.sum(pu) + torch.sum(pl), 1)
    mu = torch.clamp_min(terms / count, 1e-12)
    w = torch.where(mask, torch.clamp(mu / su, 1e-8, 1e8), 1.0)
    z = torch.where(mask, torch.clamp(mu / sl, 1e-8, 1e8), 1.0)
    return w, z


def make_pdas_dd_sparse(
    sf,
    block: int = 128,
    config: Optional[PDASConfig] = None,
    dtype=None,
    snode_align: bool = True,
    device="cuda",
):
    """StandardForm -> (dd state over a fully sparse SparseKKTLP, engine):
    the double-word promotion of solvers.pdas.make_pdas_sparse.  Pass the
    engine to pdas_dd(..., engine=...)."""
    st, engine = make_pdas_sparse(sf, block=block, config=config, dtype=dtype,
                                  snode_align=snode_align, device=device)
    return (
        PDASDDState(x=ddm.dd_from(st.x), y=ddm.dd_from(st.y),
                    w=ddm.dd_from(st.w), z=ddm.dd_from(st.z), lp=st.lp),
        engine,
    )


def _boost(lp):
    # f32 even in an f64 run, as in the JAX package (promotes on use).
    return (~lp.row_mask).to(torch.float32)


def _make_op(lp, cfg: PDASConfig, engine, gate, per_lane: bool = False,
             mesh=None):
    """KKT operator on the operand set (solvers.backend): the fully sparse
    tile engine (its factorizations sharded over ``mesh``'s 'tp' when
    given); a column-sharded LP's tp pipeline; the dense one with
    true-residual refinement (refined against the UNASSEMBLED operator in
    double-word, which corrects the f32 rounding of assembling N;
    otherwise a ~1e-7 direction floor); or, with an engine on a dense
    state, that engine refined against the unassembled operator too.
    ``per_lane``: a lane under ``torch.func.vmap``."""
    return factor_once_operator(*mv_rmv(lp), functools.partial(
        prepare_normal_backend, lp, engine, row_boost=_boost(lp),
        refine_steps=cfg.refine_steps, mesh=mesh, dbound=cfg.dbound,
        krylov_steps=cfg.krylov_steps, krylov_gate=gate, per_lane=per_lane,
        true_residual=True))


def _entry_repair(state: PDASDDState, cfg: PDASConfig, engine=None,
                  per_lane: bool = False, mesh=None):
    """Min-norm LS correction of the entry iterate toward Ax = b in the
    Dikin metric (PDASConfig.entry_repair_tol), all in double-word with
    cfg.entry_repair_refines refinement passes; kept only where it reduced
    the relative inf-norm infeasibility on a non-singular factor.
    ``per_lane`` (a lane under ``torch.func.vmap``): the repair is computed
    always and kept only where the entry violation exceeds the tolerance,
    as the JAX ``lax.cond`` pre-step under ``jax.vmap``.

    Returns (state, pviol_before, pviol_after)."""
    lp = state.lp
    mask = lp.col_mask
    mv_dd, rmv_dd, _ = dd_linops(lp)
    sl_dd, su_dd, *_rest, primal_dd, _dual = _dd_violation(state)
    r0 = ddm.dd_neg(primal_dd)  # b - Ax
    bscale = 1.0 + torch.max(torch.abs(lp.b))
    pv0 = torch.max(torch.abs(r0.to_working())) / bscale
    go = pv0 > cfg.entry_repair_tol
    if not per_lane and not host_bool(go):
        return state, pv0, pv0

    x = state.x
    op = _make_op(lp, cfg, engine, None, per_lane, mesh)
    boost = _boost(lp)
    s = _slack(lp.l, x.hi, lp.u, cfg.repair_slack_cap, mask)
    s = torch.where(mask, s, 0.0)  # padding inert in N and in dx
    solve_fn, ok = op.prepare_scaled_normal(s)
    w2 = DD(s * s, torch.zeros_like(s))

    def apply_dd(v: DD) -> DD:
        t = ddm.dd_mul(w2, rmv_dd(v))
        return ddm.dd_add_w(mv_dd(t), boost * v.to_working())

    dy = ddm.dd_from(solve_fn(r0.to_working()))
    for _ in range(cfg.entry_repair_refines):
        rr = ddm.dd_sub(r0, apply_dd(dy))
        dy = ddm.dd_add(dy, ddm.dd_from(solve_fn(rr.to_working())))
    dx = ddm.dd_mul(w2, rmv_dd(dy))
    x1 = ddm.dd_add(x, dx)
    # Per-coordinate interior clip: keep >= 10% of each pre-repair slack.
    lo = x.hi - 0.9 * sl_dd.to_working()
    hi = x.hi + 0.9 * su_dd.to_working()
    below = mask & (x1.hi < lo)
    above = mask & (x1.hi > hi)
    x1 = DD(
        torch.where(below, lo, torch.where(above, hi, x1.hi)),
        torch.where(below | above, 0.0, x1.lo),
    )
    r1 = ddm.dd_sub(ddm.dd_from(lp.b), mv_dd(x1))
    pv1 = torch.max(torch.abs(r1.to_working())) / bscale
    use = ok & (pv1 < pv0)
    x_out = DD(torch.where(use, x1.hi, x.hi), torch.where(use, x1.lo, x.lo))
    pv_out = torch.where(use, pv1, pv0)
    if per_lane:
        x_out = ddm.dd_where(go, x_out, x)
        pv_out = torch.where(go, pv_out, pv0)
    return dataclasses.replace(state, x=x_out), pv0, pv_out


def _dd_violation(st: PDASDDState):
    """The PDAS violation vector (:135-150) evaluated in double-word.
    Returns the dd slacks, their working-precision values, the
    complementarities and the dd primal and dual residuals."""
    lp = st.lp
    mask = lp.col_mask
    # Double-word slacks are good to ~eps^2: floor at 1e-12, not 1e-7.
    floor = 1e-12

    def dd_floor(v: DD, lo: float, m) -> DD:
        bad = (v.hi <= lo) | ~m
        return DD(
            torch.where(bad, torch.where(m, lo, 1.0), v.hi),
            torch.where(bad, 0.0, v.lo),
        )

    sl_dd = dd_floor(ddm.dd_add_w(st.x, -lp.l), floor, mask)
    su_dd = dd_floor(ddm.dd_add_w(ddm.dd_neg(st.x), lp.u), floor, mask)
    sl = torch.where(mask, sl_dd.to_working(), 1.0)
    su = torch.where(mask, su_dd.to_working(), 1.0)
    wu = torch.where(mask, ddm.dd_mul(st.w, su_dd).to_working(), 0.0)
    zl = torch.where(mask, ddm.dd_mul(st.z, sl_dd).to_working(), 0.0)
    mv_dd, rmv_dd, _ = dd_linops(lp)
    primal_dd = ddm.dd_add_w(mv_dd(st.x), -lp.b)
    aty = rmv_dd(st.y)
    dual_dd = ddm.dd_add_w(
        ddm.dd_add(ddm.dd_add(aty, st.z), ddm.dd_neg(st.w)), -lp.c
    )
    dual_dd = DD(
        torch.where(mask, dual_dd.hi, 0.0), torch.where(mask, dual_dd.lo, 0.0)
    )
    return sl_dd, su_dd, sl, su, wu, zl, primal_dd, dual_dd


def _dd_objectives(st: PDASDDState, clamp: float = 1e8):
    lp = st.lp
    mask = lp.col_mask
    pobj = ddm.dd_add(
        ddm.dd_dot(lp.c, st.x.hi),
        DD(torch.dot(lp.c, st.x.lo), torch.zeros((), dtype=lp.c.dtype,
                                                 device=lp.c.device)),
    )
    z_active = mask & (lp.l > -0.999 * clamp)
    w_active = mask & (lp.u < 0.999 * clamp)
    l_act = torch.where(z_active, lp.l, 0.0)
    u_act = torch.where(w_active, lp.u, 0.0)
    lz = ddm.dd_dot(l_act, st.z.hi)
    uw = ddm.dd_dot(u_act, st.w.hi)
    by = ddm.dd_dot(lp.b, st.y.hi)
    dobj = ddm.dd_add(by, ddm.dd_sub(lz, uw))
    extra = (torch.dot(l_act, st.z.lo) + torch.dot(lp.b, st.y.lo)
             - torch.dot(u_act, st.w.lo))
    dobj = ddm.dd_add_w(dobj, extra)
    return pobj, dobj


def _dd_box_step(sl_dd: DD, su_dd: DD, dx_dd: DD) -> DD:
    """Largest t with slacks positive under x -= t*dx, in double-word."""
    inf = DD(torch.full_like(sl_dd.hi, float("inf")), torch.zeros_like(sl_dd.hi))
    zero = DD(torch.zeros_like(sl_dd.hi), torch.zeros_like(sl_dd.hi))
    lim = ddm.dd_where(
        dx_dd.hi > 0,
        ddm.dd_div(sl_dd, dx_dd),
        ddm.dd_where(dx_dd.hi < 0, ddm.dd_div(su_dd, ddm.dd_neg(dx_dd)), inf),
    )
    lim = ddm.dd_where(lim.hi < 0, zero, lim)
    return ddm.dd_min(lim)


def _dd_pos_step(v_dd: DD, dv_dd: DD) -> DD:
    """Largest t with v - t*dv >= 0, in double-word."""
    inf = DD(torch.full_like(v_dd.hi, float("inf")), torch.zeros_like(v_dd.hi))
    zero = DD(torch.zeros_like(v_dd.hi), torch.zeros_like(v_dd.hi))
    lim = ddm.dd_where(dv_dd.hi > 0, ddm.dd_div(v_dd, dv_dd), inf)
    lim = ddm.dd_where(lim.hi < 0, zero, lim)
    return ddm.dd_min(lim)


def _dd_step(sl_dd, su_dd, st, dw_dd, dx_dd, dz_dd) -> DD:
    """min(box step, pos step of w, pos step of z), in double-word."""
    step = _dd_box_step(sl_dd, su_dd, dx_dd)
    for cand in (_dd_pos_step(st.w, dw_dd), _dd_pos_step(st.z, dz_dd)):
        step = ddm.dd_where(ddm.dd_less(cand, step), cand, step)
    return step


def pdas_dd(
    state: PDASDDState,
    config: Optional[PDASConfig] = None,
    engine=None,
    mesh=None,
) -> SolveResult:
    """Tight-gap loop: plain (or Mehrotra) Newton steps with no in-loop
    repair/recenter, best-iterate tracking and the precision-floor exit.
    ``config.entry_repair_tol`` optionally repairs the ENTRY iterate
    toward Ax = b first.  ``engine`` is the tile engine of a state built by
    :func:`make_pdas_dd_sparse`, or a sparse engine of a dense state's A.
    ``mesh`` (every rank of the mesh makes the call) runs every
    factorization over its 'tp' axis, the entry repair's too: a dense
    state's LP is held by columns (parallel.sharded), a fully sparse
    state's engine shards its assembly and Schur updates (pdas's ``mesh``).
    Every rank returns the whole result."""
    cfg = config or PDASConfig(gap_tol=1e-8, max_iters=300)
    check_backend(state.lp, engine, mesh)
    state = dataclasses.replace(state, lp=shard_for(state.lp, mesh))
    return _pdas_dd_loop(state, cfg, engine, mesh)


def _kkt_dd(st, sl_dd, su_dd, sl, su, wu, zl, g_dd, h_dd, op, cfg, gap):
    """IPM-specialized FULL double-word elimination (see the JAX package's
    kkt_dd): with e = w∘su, f = z∘sl the eliminated terms simplify to
    alpha = beta·(-h - w + z), an O(1) quantity whose cancellation against
    g (O(gap)) must happen in double-word.  Every intermediate is dd; only
    the Cholesky runs in f32, and dy gets one outer refinement against the
    exact dd operator A·diag(beta_dd)·Aᵀ + diag(boost) on the recycled
    factor.  With cfg.mehrotra a second solve on the SAME factor gives the
    corrector, and cfg.gondzio_correctors more while ``gap`` is above
    cfg.gondzio_gate_gap."""
    lp = st.lp
    zero = torch.zeros_like(sl)
    dd0 = DD(zero, zero)
    pu = su <= FILTER_THRESHOLD
    pl = sl <= FILTER_THRESHOLD
    both_absent = ~pu & ~pl
    use_u = pu | both_absent
    use_l = pl | both_absent
    a_dd = ddm.dd_where(use_u, ddm.dd_div(st.w, su_dd), dd0)
    b_dd = ddm.dd_where(use_l, ddm.dd_div(st.z, sl_dd), dd0)
    denom = ddm.dd_add(a_dd, b_dd)
    denom = ddm.dd_where(
        denom.hi < 1e-30, DD(torch.full_like(sl, 1e-30), zero), denom
    )
    one = DD(torch.ones_like(sl), zero)
    beta_dd = ddm.dd_div(one, denom)

    mv_dd, rmv_dd, rmv32 = dd_linops(lp)
    boost = _boost(lp)
    s32 = torch.sqrt(beta_dd.to_working())
    solve_fn, ok = op.prepare_scaled_normal(s32)

    def newton_dir(de_dd, df_dd):
        """Direction for complementarity rhs e = w∘su + de, f = z∘sl + df."""
        corr = ddm.dd_sub(
            ddm.dd_where(use_l, ddm.dd_div(df_dd, sl_dd), dd0),
            ddm.dd_where(use_u, ddm.dd_div(de_dd, su_dd), dd0),
        )
        base = ddm.dd_add(ddm.dd_neg(h_dd), ddm.dd_sub(st.z, st.w))
        alpha_dd = ddm.dd_mul(ddm.dd_add(base, corr), beta_dd)
        rhs_dd = ddm.dd_sub(g_dd, mv_dd(alpha_dd))
        dy1 = solve_fn(rhs_dd.to_working())
        # Outer dd refinement against the EXACT dd-beta system.
        with span("normal.refine"):
            ty = rmv32(dy1)
            u = ddm.dd_mul(beta_dd, ty)
            Mu = ddm.dd_add_w(mv_dd(u), boost * dy1)
            r = ddm.dd_sub(rhs_dd, Mu).to_working()
        dy2 = solve_fn(r)
        dy_dd = ddm.dd_add_w(DD(dy1, torch.zeros_like(dy1)), dy2)

        t_dd = rmv_dd(dy_dd)
        dx_dd = ddm.dd_add(alpha_dd, ddm.dd_mul(beta_dd, t_dd))
        # dw = w + (w·dx + de)/su,  dz = z - (z·dx - df)/sl (filtered: w, z).
        dw_dd = ddm.dd_where(
            use_u,
            ddm.dd_add(
                st.w,
                ddm.dd_div(ddm.dd_add(ddm.dd_mul(st.w, dx_dd), de_dd), su_dd),
            ),
            st.w,
        )
        dz_dd = ddm.dd_where(
            use_l,
            ddm.dd_sub(
                st.z,
                ddm.dd_div(ddm.dd_sub(ddm.dd_mul(st.z, dx_dd), df_dd), sl_dd),
            ),
            st.z,
        )
        # Padding inertness: zero the deltas on masked entries.
        dx_dd = ddm.dd_where(lp.col_mask, dx_dd, dd0)
        dw_dd = ddm.dd_where(lp.col_mask, dw_dd, dd0)
        dz_dd = ddm.dd_where(lp.col_mask, dz_dd, dd0)
        return dw_dd, dx_dd, dy_dd, dz_dd

    dw_dd, dx_dd, dy_dd, dz_dd = newton_dir(dd0, dd0)
    if not cfg.mehrotra:
        return dw_dd, dx_dd, dy_dd, dz_dd, ok

    # --- Mehrotra corrector on the shared factor, over PRESENT bounds of
    # REAL columns only (padding would pin sigma at O(1)). ---
    pu = pu & lp.col_mask
    pl = pl & lp.col_mask
    step_aff = _dd_step(sl_dd, su_dd, st, dw_dd, dx_dd, dz_dd)
    t_aff = torch.clamp_max(step_aff.to_working(), 1.0)
    cnt = torch.clamp_min(torch.sum(pu) + torch.sum(pl), 1).to(sl.dtype)
    mu = (
        torch.sum(torch.where(pu, wu, 0.0)) + torch.sum(torch.where(pl, zl, 0.0))
    ) / cnt
    wn = st.w.hi - t_aff * dw_dd.hi
    sun = su + t_aff * dx_dd.hi
    zn = st.z.hi - t_aff * dz_dd.hi
    sln = sl - t_aff * dx_dd.hi
    mu_aff = (
        torch.sum(torch.where(pu, wn * sun, 0.0))
        + torch.sum(torch.where(pl, zn * sln, 0.0))
    ) / cnt
    mu_aff = torch.clamp_min(mu_aff, 0.0)
    sigma = torch.clamp((mu_aff / torch.clamp_min(mu, 1e-30)) ** 3, 0.0, 1.0)
    target = sigma * mu
    # Deviations from exact complementarity, in dd (gap-sized values).
    de_dd = ddm.dd_where(
        pu, ddm.dd_add_w(ddm.dd_neg(ddm.dd_mul(dw_dd, dx_dd)), -target), dd0
    )
    df_dd = ddm.dd_where(
        pl, ddm.dd_add_w(ddm.dd_mul(dz_dd, dx_dd), -target), dd0
    )
    dw_dd, dx_dd, dy_dd, dz_dd = newton_dir(de_dd, df_dd)
    if cfg.gondzio_correctors == 0:
        return dw_dd, dx_dd, dy_dd, dz_dd, ok

    # --- Gondzio's correctors, dd rendering: the trial complementarity
    # products and the centrality-box clip run in working precision (they
    # only steer the next rhs deviation); the deviation itself stays dd.
    # Every candidate is computed and kept by a select (no host read). ---
    def g_step(dw_, dx_, dz_):
        return torch.clamp_max(
            _dd_step(sl_dd, su_dd, st, dw_, dx_, dz_).to_working(), 1.0)

    def mu_pred(dw_, dx_, dz_, t_):
        # The duality measure at the damped step, on the hi parts.
        ts = cfg.mehrotra_gamma * t_
        return (torch.sum(torch.where(pu, (st.w.hi - ts * dw_.hi) * (su + ts * dx_.hi), 0.0))
                + torch.sum(torch.where(pl, (st.z.hi - ts * dz_.hi) * (sl - ts * dx_.hi),
                                       0.0))) / cnt

    t_cur = g_step(dw_dd, dx_dd, dz_dd)
    mu_cur = mu_pred(dw_dd, dx_dd, dz_dd, t_cur)
    de_acc, df_acc = de_dd, df_dd
    active = ok & (gap > cfg.gondzio_gate_gap)
    lo_t = cfg.gondzio_beta_min * target
    hi_t = cfg.gondzio_beta_max * target
    for _ in range(cfg.gondzio_correctors):
        t_t = torch.clamp_max(t_cur + cfg.gondzio_delta, 1.0)
        vu = (st.w.hi - t_t * dw_dd.hi) * (su + t_t * dx_dd.hi)
        vl = (st.z.hi - t_t * dz_dd.hi) * (sl - t_t * dx_dd.hi)
        dtu = torch.where(pu, torch.clamp(vu, lo_t, hi_t) - vu, 0.0)
        dtl = torch.where(pl, torch.clamp(vl, lo_t, hi_t) - vl, 0.0)
        de_t = ddm.dd_add_w(de_acc, -dtu)
        df_t = ddm.dd_add_w(df_acc, -dtl)
        cw, cx, cy, cz = newton_dir(de_t, df_t)
        t_new = g_step(cw, cx, cz)
        mu_new = mu_pred(cw, cx, cz, t_new)
        acc = active & (t_new >= t_cur + cfg.gondzio_gamma * cfg.gondzio_delta) & (
            mu_new <= mu_cur)
        dw_dd, dx_dd, dy_dd, dz_dd, de_acc, df_acc = (
            ddm.dd_where(acc, new, old) for old, new in zip(
                (dw_dd, dx_dd, dy_dd, dz_dd, de_acc, df_acc),
                (cw, cx, cy, cz, de_t, df_t)))
        t_cur = torch.where(acc, t_new, t_cur)
        mu_cur = torch.where(acc, mu_new, mu_cur)
        active = acc
    return dw_dd, dx_dd, dy_dd, dz_dd, ok


def _one_iteration(st: PDASDDState, cfg: PDASConfig, engine,
                   per_lane: bool = False, mesh=None):
    """One double-word iteration.  Returns (new_st, gap, pviol, step, ok);
    ``per_lane``: a lane under ``torch.func.vmap``; ``mesh``: see
    :func:`pdas_dd`."""
    lp = st.lp
    sl_dd, su_dd, sl, su, wu, zl, primal_dd, dual_dd = _dd_violation(st)
    pviol = torch.max(torch.abs(primal_dd.to_working()))
    pobj_dd, dobj_dd = _dd_objectives(st, cfg.clamp)
    gap_dd = ddm.dd_sub(pobj_dd, dobj_dd)
    denom = torch.clamp_min(
        torch.maximum(torch.abs(pobj_dd.to_working()),
                      torch.abs(dobj_dd.to_working())),
        1.0,
    )
    gap = torch.abs(gap_dd.to_working()) / denom

    gate = None
    if cfg.krylov_steps > 0 and cfg.krylov_gate_gap > 0.0:
        gate = gap < cfg.krylov_gate_gap
    op = _make_op(lp, cfg, engine, gate, per_lane, mesh)
    dw_dd, dx_dd, dy_dd, dz_dd, ok = _kkt_dd(
        st, sl_dd, su_dd, sl, su, wu, zl, primal_dd, dual_dd, op, cfg, gap
    )
    # Ratio tests in dd.
    step_dd = _dd_step(sl_dd, su_dd, st, dw_dd, dx_dd, dz_dd)
    gamma = cfg.mehrotra_gamma if cfg.mehrotra else cfg.gamma
    # gamma and 1 as f32 double-words even in an f64 run, as the JAX
    # package builds them from np.float32: the dd products below then mix
    # an f32 split of gamma with the f64 step exactly as JAX promotes.
    f32 = dict(dtype=torch.float32, device=sl.device)
    ghi = np.float32(gamma)
    gamma_dd = DD(torch.tensor(ghi, **f32),
                  torch.tensor(np.float32(gamma - float(ghi)), **f32))
    ts = ddm.dd_mul(gamma_dd, step_dd)
    one = DD(torch.tensor(1.0, **f32), torch.tensor(0.0, **f32))
    t_dd = ddm.dd_where(ddm.dd_less(one, ts), one, ts)
    new = PDASDDState(
        x=ddm.dd_sub(st.x, ddm.dd_mul(t_dd, dx_dd)),
        y=ddm.dd_sub(st.y, ddm.dd_mul(t_dd, dy_dd)),
        w=ddm.dd_sub(st.w, ddm.dd_mul(t_dd, dw_dd)),
        z=ddm.dd_sub(st.z, ddm.dd_mul(t_dd, dz_dd)),
        lp=lp,
    )
    return new, gap, pviol, step_dd.to_working(), ok


class _Carry(NamedTuple):
    """The loop's carry besides the iterate and its count: 0-dim tensors,
    or (B,) in a batch."""

    gap: torch.Tensor
    pviol: torch.Tensor
    best_gap: torch.Tensor
    since_best: torch.Tensor
    status: torch.Tensor
    best_st: tuple  # (x, y, w, z) of the best pre-step iterate, as DD


def _start(st: PDASDDState) -> _Carry:
    dt, dev = st.x.hi.dtype, st.x.hi.device
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    return _Carry(
        gap=inf, pviol=inf, best_gap=inf,
        since_best=torch.zeros((), dtype=torch.int32, device=dev),
        status=torch.tensor(Status.RUNNING, dtype=torch.int32, device=dev),
        best_st=(st.x, st.y, st.w, st.z),
    )


def _advance(c: _Carry, st: PDASDDState, gap, pviol, ok) -> _Carry:
    # Feasibility-gated best tracking of the PRE-step state.
    improved = (gap < c.best_gap) & (pviol < 1e-2)
    return _Carry(
        gap=gap, pviol=pviol,
        best_gap=torch.where(improved, gap, c.best_gap),
        since_best=torch.where(improved, 0, c.since_best + 1).to(torch.int32),
        status=torch.where(ok, Status.RUNNING, Status.SINGULAR).to(torch.int32),
        best_st=tuple(ddm.dd_where(improved, new, b)
                      for b, new in zip(c.best_st, (st.x, st.y, st.w, st.z))),
    )


def _finish(cfg: PDASConfig, st: PDASDDState, c: _Carry) -> dict:
    """The result's tensors from the last iterate and the carry."""
    use_best = c.best_gap <= c.gap
    bx, by, bw, bz = (
        ddm.dd_where(use_best, b, cur)
        for b, cur in zip(c.best_st, (st.x, st.y, st.w, st.z))
    )
    st = dataclasses.replace(st, x=bx, y=by, w=bw, z=bz)
    exit_bounced = _bounced(cfg, c.gap, c.best_gap)  # on the PRE-min exit gap
    gap = torch.minimum(c.best_gap, c.gap)
    pobj_dd, dobj_dd = _dd_objectives(st, cfg.clamp)
    primal = _dd_violation(st)[6].to_working()
    final_status = torch.where(
        c.status != Status.RUNNING,
        c.status,
        torch.where(
            gap < cfg.gap_tol,
            Status.OPTIMAL,
            torch.where(
                (c.since_best >= cfg.stall_exit_iters) | exit_bounced,
                Status.PRECISION_FLOOR,
                Status.MAX_ITERS,
            ),
        ),
    ).to(torch.int32)
    return dict(
        x=st.x.to_working(), objective=pobj_dd.to_working(),
        status=final_status, residual_norm=torch.linalg.norm(primal),
        gap=gap, dual_objective=dobj_dd.to_working(), x_lo=st.x.lo,
        y=st.y.to_working(), w=st.w.to_working(), z=st.z.to_working(),
    )


def _result(out: dict, iterations, trace, cfg: PDASConfig,
            repair_info: dict) -> SolveResult:
    return SolveResult(
        x=out["x"],
        objective=out["objective"],
        status=out["status"],
        iterations=iterations,
        residual_norm=out["residual_norm"],
        extra={
            "gap": out["gap"],
            **repair_info,
            "dual_objective": out["dual_objective"],
            "x_lo": out["x_lo"],
            "y": out["y"],
            "w": out["w"],
            "z": out["z"],
            "trace": {
                "gap": trace[0], "objective": trace[1], "step": trace[2],
                **({"x": trace[3], "x_lo": trace[4]}
                   if cfg.record_iterates else {}),
            },
        },
    )


@highest_precision
def _pdas_dd_loop(state: PDASDDState, cfg: PDASConfig, engine,
                  mesh=None) -> SolveResult:
    lp = state.lp
    repair_info = {}
    if cfg.entry_repair_tol > 0.0:
        state, pv0, pv1 = _entry_repair(state, cfg, engine, mesh=mesh)
        repair_info = {"entry_repair": {"pviol_before": pv0,
                                        "pviol_after": pv1}}
    # The trace is f32 even in an f64 run, as in the JAX package.
    trace = _new_trace(cfg, state.x.hi.shape[0], torch.float32,
                       state.x.hi.device, 2)
    st, c, i = state, _start(state), 0
    while i < cfg.max_iters and host_bool(_keep_going(cfg, c)):
        with span("loop.iteration"):
            count("loop.iterations")
            new_st, gap, pviol, step, ok = _one_iteration(st, cfg, engine, mesh=mesh)
            if cfg.record_trace or cfg.record_iterates:
                vals = [gap, torch.dot(st.x.hi, lp.c) + torch.dot(st.x.lo, lp.c),
                        step]
                if cfg.record_iterates:
                    vals += [st.x.hi, st.x.lo]
                for buf, v in zip(trace, vals):
                    buf[i] = v
            c = _advance(c, st, gap, pviol, ok)
            st, i = new_st, i + 1
    return _result(_finish(cfg, st, c), torch.tensor(i, dtype=torch.int32),
                   trace, cfg, repair_info)


@highest_precision
def _pdas_dd_lanes(states: PDASDDState, cfg: PDASConfig,
                   engine=None) -> SolveResult:
    """:func:`_pdas_dd_loop` over stacked states by
    :func:`.pdas._lane_loop`: the entry repair and every iteration vmapped
    with ``per_lane`` (no host read inside).  Dense states (with or without
    a dense-A ``engine`` of their shared pattern), or sparse ones of one A
    with its ``engine``.  On the card in f32 each iteration's
    kernels run once for the whole batch: the double-word products on the
    stacked dense operands, or the assembly and the tile factor on the
    engine."""
    check_backend(states.lp, engine, None)
    repair_info = {}
    if cfg.entry_repair_tol > 0.0:
        states, pv0, pv1 = lanes.vmap(
            lambda s: _entry_repair(s, cfg, engine, per_lane=True), states)
        repair_info = {"entry_repair": {"pviol_before": pv0,
                                        "pviol_after": pv1}}
    B, n = states.x.hi.shape
    trace = _lane_trace(cfg, B, n, torch.float32, states.x.hi.device, 2)

    def step(st, c):
        new_st, gap, pviol, stp, ok = _one_iteration(st, cfg, engine,
                                                     per_lane=True)
        obj = torch.dot(st.x.hi, st.lp.c) + torch.dot(st.x.lo, st.lp.c)
        return (dict(x=new_st.x, y=new_st.y, w=new_st.w, z=new_st.z),
                _advance(c, st, gap, pviol, ok), (gap, obj, stp))

    out, i, trace = _lane_loop(
        cfg, states, lanes.vmap(_start, states), step,
        lambda s, k: _finish(cfg, s, k), trace,
        (lambda s: [s.x.hi, s.x.lo]) if cfg.record_iterates else None)
    return _result(out, i, trace, cfg, repair_info)
