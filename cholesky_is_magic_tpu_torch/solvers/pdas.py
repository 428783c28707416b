"""Primal-dual affine scaling with the block-eliminated KKT Newton step.

Counterpart of ``cholesky_is_magic_tpu/solvers/pdas.py`` on dense operands
and on the fully sparse ones (:func:`make_pdas_sparse`, ``engine=``)
(reference: primal-dual-affine-scaling.lisp): bound clamping and widening,
the make-pdas initialization, row equilibration, the violation vector,
repair iterations, the stalled-step recenter with dual perturbation,
separate primal/dual ratio tests, Mehrotra's predictor-corrector, best-
iterate tracking and the stall/bounce exits.

The JAX package runs the solve as one jitted ``lax.while_loop``; here it is
an eager host loop over device tensors with the same carry and the same
status codes.  The loop condition is read on the host once per iteration,
and the dbound retry (ops.dense) once per factorization.  One scaled
normal factorization per iteration serves the repair, recenter and Newton
branches alike (pdas.py:546-559 of the reference package).

Gondzio's multiple centrality correctors (``gondzio_correctors > 0`` with
Mehrotra) run on the same factorization, each candidate computed and kept
by a branchless select, as in the JAX package, so a lane of the batched
loop takes them with no host read.  ``engine=`` takes the fully sparse
tile engine of :func:`make_pdas_sparse`, or on a dense state a sparse
engine built from its A (``sparse.engine_for``, ``BlockSparseCholesky``),
in the single loop and in every lane of the batched one.  ``mesh=`` (a
('dp', 'tp') DeviceMesh, ``parallel.lp_mesh``) runs the loop on every rank
of the mesh: a dense LP held by columns over 'tp' (parallel.sharded), or
the fully sparse engine's factorizations sharded over 'tp'.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from cholesky_is_magic_tpu_torch.ingest.device import DeviceLP, SparseKKTLP
from cholesky_is_magic_tpu_torch.kkt.newton import (
    FILTER_THRESHOLD,
    kkt_backsub,
    kkt_reduce,
)
from cholesky_is_magic_tpu_torch.solvers.affine import (
    _centering_direction,
    _into_interior,
    _max_step,
    _slack,
)
from cholesky_is_magic_tpu_torch.solvers.backend import (
    check_backend,
    mv_rmv as _mv_rmv,
    shard_for,
    prepare_normal_backend as _prepare_normal_backend,
    row_boost as _row_boost,
)
from cholesky_is_magic_tpu_torch.solvers.result import SolveResult, Status
from cholesky_is_magic_tpu_torch.utils import lanes
from cholesky_is_magic_tpu_torch.utils.precision import highest_precision


@dataclasses.dataclass(frozen=True)
class PDASConfig:
    """The JAX package's PDASConfig, field for field (its comments carry
    the rationale and measurements of each knob)."""

    clamp: float = 1e8  # *clamp* (:37)
    gamma: float = 0.9  # step damping (:377)
    gap_tol: float = 1e-4  # stopping gap (:394)
    primal_feasible_tol: float = 1e-2  # repair trigger (:333)
    stall_step: float = 1e-6  # repair-flag trigger (:393)
    repair_floor: float = 1e-4  # x floor after repair (:285-287)
    repair_slack_cap: float = 1e4  # slack cap in repair/recenter (:273,354)
    max_iters: int = 300
    refine_steps: int = 1
    # Singular-retry diagonal floor relative to max(diag N); 0 disables.
    dbound: float = 1e-6
    # > 0: flexible-PCG refinement with that many iterations (ops.krylov).
    krylov_steps: int = 0
    # With krylov_steps > 0: PCG only while the relative gap is below this.
    krylov_gate_gap: float = 0.0
    # Mehrotra predictor-corrector on the shared factorization.
    mehrotra: bool = False
    # Gondzio centrality correctors on the shared factor (needs mehrotra):
    # up to this many, each re-solving with the complementarity products at
    # an enlarged trial step clipped into [beta_min, beta_max]·sigma·mu,
    # kept only if the step grows by gamma·delta and the predicted mu does
    # not grow; only while the gap is above gondzio_gate_gap.  0 disables.
    gondzio_correctors: int = 0
    gondzio_delta: float = 0.1
    gondzio_beta_min: float = 0.1
    gondzio_beta_max: float = 10.0
    gondzio_gamma: float = 0.1
    gondzio_gate_gap: float = 1e-4
    # Step damping of the Mehrotra corrector step.
    mehrotra_gamma: float = 0.99
    # Dense factor/solve kernel, "direct" or "inverse" (ops.dense).
    factor_method: str = "direct"
    # Record per-iteration (gap, pobj, step) into result.extra["trace"].
    record_trace: bool = False
    # Additionally record the pre-step primal iterate x each iteration.
    record_iterates: bool = False
    # Stop when the best-seen gap has not improved for this many iterations.
    stall_exit_iters: int = 40
    # Bounce exit: after best_gap < floor, exit once gap > ratio*best_gap.
    bounce_exit_ratio: float = 0.0
    bounce_exit_floor: float = 1e-5
    # Entry min-norm repair (pdas_dd only); 0 disables.
    entry_repair_tol: float = 0.0
    entry_repair_refines: int = 2


@dataclasses.dataclass(frozen=True)
class PDASState:
    x: torch.Tensor  # primal
    y: torch.Tensor  # equality duals
    w: torch.Tensor  # upper-bound duals (> 0)
    z: torch.Tensor  # lower-bound duals (> 0)
    # Clamped/widened bounds, equilibrated (A, b); a SparseKKTLP on the
    # fully sparse path.
    lp: Optional[DeviceLP | SparseKKTLP]


def push_interior(x, l, u, mask, delta):
    """Pull x at least ``delta`` inside [l, u] (absolute, capped at the
    interval width; intervals narrower than 2*delta center) — the warm-start
    push for a warm point from a nearby LP."""
    margin = delta * torch.clamp_max(u - l, 1.0)
    xi = torch.clamp(x, l + margin, u - margin)
    xi = torch.where(u - l < 2 * margin, 0.5 * (l + u), xi)
    return torch.where(mask, xi, x)


def make_pdas(
    lp: DeviceLP,
    config: Optional[PDASConfig] = None,
    warm: Optional[PDASState] = None,
    warm_push: float = 0.0,
    warm_blend: float = 0.0,
) -> PDASState:
    """Construct the primal-dual state (make-pdas, :75-133): row
    equilibration, bound clamp/widening, primal init from the raw bounds,
    dual init from sign(c).  ``warm`` restarts from a prior state's
    iterates; ``warm_blend`` mixes the cold init into them and
    ``warm_push`` re-opens their bound slacks."""
    cfg = config or PDASConfig()
    mask = lp.col_mask

    # Row equilibration (scale-constraints, :50-73): padded rows -> scale 1.
    row_max = torch.max(torch.abs(lp.A), dim=1).values
    scale = torch.where(
        row_max < 1e-6, 1.0, 1.0 / torch.where(row_max == 0, 1.0, row_max)
    )
    A = lp.A * scale[:, None]
    b = lp.b * scale

    raw_l, raw_u = lp.l, lp.u  # +/-1e30-encoded "infinities"
    l = torch.clamp(raw_l, -cfg.clamp, cfg.clamp)
    u = torch.clamp(raw_u, -cfg.clamp, cfg.clamp)
    degenerate = mask & ((u - l) < 1e-6)
    l = torch.where(degenerate, l - 5e-7, l)
    u = torch.where(degenerate, u + 5e7, u)
    l = torch.where(mask, l, lp.l)
    u = torch.where(mask, u, lp.u)

    # Primal init from the raw bounds (:98-107; thresholds 1e10 then 1e6).
    delta = raw_u - raw_l
    x = torch.where(
        (raw_l < -1e10) & (raw_u > 1e10),
        0.0,
        torch.where(
            raw_l < -1e6,
            raw_u - torch.minimum(delta / 2, 1.0 + 0.1 * torch.abs(raw_u)),
            torch.where(
                raw_u > 1e6,
                raw_l + torch.minimum(delta / 2, 1.0 + 0.1 * torch.abs(raw_l)),
                (raw_l + raw_u) / 2,
            ),
        ),
    )
    x = torch.where(mask, x, 0.0)

    # Dual init from sign(c) (:109-118); padded cols have c = 0 -> (1, 1).
    c = lp.c
    z = torch.where(c > 0, 1.0 + c, 1.0)
    w = torch.where(c < 0, 1.0 - c, 1.0)

    new_lp = dataclasses.replace(lp, A=A, b=b, l=l, u=u)
    if warm is not None:
        wx = warm.x
        wy, ww, wz = warm.y, warm.w, warm.z
        if warm_blend > 0.0:
            bl = warm_blend
            wx = (1 - bl) * wx + bl * x
            wy = (1 - bl) * wy + bl * torch.zeros_like(b)
            ww = (1 - bl) * ww + bl * w
            wz = (1 - bl) * wz + bl * z
        if warm_push > 0.0:
            wx = push_interior(wx, l, u, mask, warm_push)
        x = _into_interior(wx, l, u, mask)
        return PDASState(
            x=x,
            y=wy,
            w=torch.clamp_min(ww, 1e-8),
            z=torch.clamp_min(wz, 1e-8),
            lp=new_lp,
        )
    return PDASState(x=x, y=torch.zeros_like(b), w=w, z=z, lp=new_lp)


def make_pdas_sparse(
    sf,
    block: int = 128,
    config: Optional[PDASConfig] = None,
    dtype=None,
    snode_align: bool = True,
    engine=None,
    device="cuda",
):
    """StandardForm -> (PDASState over a fully sparse SparseKKTLP, engine).

    The at-scale construction: host-side row equilibration and the
    make-pdas initialization (:75-133) on the raw arrays in f64, ELL (and,
    where the byte gates admit them, block-ELL) operands for A and Aᵀ, and
    a pair-schedule tile engine (sparse.tiled.engine_for_sparse) — no dense
    (m, n) operand is ever built.  Pass the engine to pdas(..., engine=...)
    / pdas_dd(..., engine=...).  ``engine`` reuses the engine of an LP with
    the SAME constraint matrix (its schedule bakes the pair weights), so
    only b, c, l and u may differ; a mismatch is not detected."""
    import scipy.sparse as sp

    from cholesky_is_magic_tpu_torch.ingest.standard_form import scale_constraints
    from cholesky_is_magic_tpu_torch.ops import bell, sparse_ops
    from cholesky_is_magic_tpu_torch.sparse.tiled import engine_for_sparse

    if dtype is None:
        dtype = torch.float32
    cfg = config or PDASConfig()
    m, n = sf.ncons, sf.nvars
    vals, b = scale_constraints(sf.a_rows, sf.a_vals, sf.b)
    if engine is None:
        A = sp.csc_matrix((vals, (sf.a_rows, sf.a_cols)), shape=(m, n))
        engine = engine_for_sparse(A, block=block, snode_align=snode_align,
                                   dtype=dtype, device=device)
    kw = dict(dtype=dtype, device=device)
    E = sparse_ops.from_coo(sf.a_rows, sf.a_cols, vals, (m, n), **kw)
    ET = sparse_ops.from_coo(sf.a_cols, sf.a_rows, vals, (n, m), **kw)
    EB = bell.from_coo(sf.a_rows, sf.a_cols, vals, (m, n), **kw)
    ETB = bell.from_coo(sf.a_cols, sf.a_rows, vals, (n, m), **kw)

    # Clamp/widen + primal/dual init, identical to make_pdas, host-side in
    # f64 before the dtype cast.
    big = 1e30
    raw_l = np.clip(np.asarray(sf.l, np.float64), -big, big)
    raw_u = np.clip(np.asarray(sf.u, np.float64), -big, big)
    l = np.clip(raw_l, -cfg.clamp, cfg.clamp)
    u = np.clip(raw_u, -cfg.clamp, cfg.clamp)
    degenerate = (u - l) < 1e-6
    l = np.where(degenerate, l - 5e-7, l)
    u = np.where(degenerate, u + 5e7, u)
    delta = raw_u - raw_l
    x = np.where(
        (raw_l < -1e10) & (raw_u > 1e10),
        0.0,
        np.where(
            raw_l < -1e6,
            raw_u - np.minimum(delta / 2, 1.0 + 0.1 * np.abs(raw_u)),
            np.where(
                raw_u > 1e6,
                raw_l + np.minimum(delta / 2, 1.0 + 0.1 * np.abs(raw_l)),
                (raw_l + raw_u) / 2,
            ),
        ),
    )
    c = np.asarray(sf.c, np.float64)
    z = np.where(c > 0, 1.0 + c, 1.0)
    w = np.where(c < 0, 1.0 - c, 1.0)

    put = lambda v: torch.as_tensor(np.asarray(v, np.float64)).to(**kw)  # noqa: E731
    ones = lambda k: torch.ones(k, dtype=torch.bool, device=device)  # noqa: E731
    lp = SparseKKTLP(E=E, ET=ET, c=put(c), b=put(b), l=put(l), u=put(u),
                     row_mask=ones(m), col_mask=ones(n), m=m, n=n,
                     EB=EB, ETB=ETB)
    st = PDASState(x=put(x), y=torch.zeros(m, **kw), w=put(w), z=put(z), lp=lp)
    return st, engine


def _slack_floor(dtype) -> float:
    """Smallest slack the KKT scaling may see (~eps^1.75)."""
    return 1e-14 if dtype == torch.float64 else 1e-7


def _violation(state: PDASState):
    """Slacks, complementarities, primal and dual residuals (:135-150),
    masked so padded entries are inert (sl = su = 1, rest 0)."""
    lp = state.lp
    mv, rmv = _mv_rmv(lp)
    mask = lp.col_mask
    floor = _slack_floor(state.x.dtype)
    sl = torch.where(mask, torch.clamp_min(state.x - lp.l, floor), 1.0)
    su = torch.where(mask, torch.clamp_min(lp.u - state.x, floor), 1.0)
    wu = torch.where(mask, state.w * su, 0.0)
    zl = torch.where(mask, state.z * sl, 0.0)
    primal = mv(state.x) - lp.b
    dual = torch.where(mask, (rmv(state.y) + state.z) - (state.w + lp.c), 0.0)
    return sl, su, wu, zl, primal, dual


def _objectives(state: PDASState, clamp: float = 1e8):
    """pobj = c·x; dobj = b·y + l·z - u·w (:325-328), with bounds at the
    +/-clamp encoding of infinity contributing nothing."""
    lp = state.lp
    mask = lp.col_mask
    pobj = torch.dot(state.x, lp.c)
    z_active = mask & (lp.l > -0.999 * clamp)
    w_active = mask & (lp.u < 0.999 * clamp)
    dobj = (
        torch.dot(lp.b, state.y)
        + torch.sum(torch.where(z_active, lp.l * state.z, 0.0))
        - torch.sum(torch.where(w_active, lp.u * state.w, 0.0))
    )
    return pobj, dobj


def _box_step(sl, su, dx):
    """Largest t with slacks staying positive under x -= t*dx (:166-180)."""
    inf = torch.tensor(float("inf"), dtype=dx.dtype, device=dx.device)
    lim = torch.where(dx > 0, sl / dx, torch.where(dx < 0, su / (-dx), inf))
    return torch.min(torch.clamp_min(lim, 0.0))


def _pos_step(v, dv):
    """Largest t with v - t*dv >= 0 (:182-192)."""
    inf = torch.tensor(float("inf"), dtype=dv.dtype, device=dv.device)
    lim = torch.where(dv > 0, v / dv, inf)
    return torch.min(torch.clamp_min(lim, 0.0))


def pdas(
    state: PDASState,
    config: Optional[PDASConfig] = None,
    engine=None,
    mesh=None,
) -> SolveResult:
    """The solver loop (pdas, :385-396): iterate until the relative duality gap
    < gap_tol at a primal-feasible iterate, arming the recenter path
    whenever the step stalls below 1e-6.  ``engine`` is the tile engine of
    a state built by :func:`make_pdas_sparse`, or a sparse engine of a
    dense state's A (``sparse.engine_for``, ``BlockSparseCholesky``).
    ``mesh`` (every rank of the mesh makes the call) runs every normal
    solve over its 'tp' axis: a dense state's LP is held by columns
    (parallel.sharded.shard_lp_columns, unless it already is) and its
    products and factorizations are column-sharded; a fully sparse state's
    engine shards its assembly and Schur updates.  Every rank returns the
    whole result."""
    cfg = config or PDASConfig()
    check_backend(state.lp, engine, mesh)
    state = dataclasses.replace(state, lp=shard_for(state.lp, mesh))
    return _pdas_loop(state, cfg, engine, mesh)


def _one_iteration(st: PDASState, repair_flag, cfg: PDASConfig, engine,
                   per_lane: bool = False, mesh=None):
    """one-pdas-iteration (:319-383). Returns (new_st, gap, pviol, step, ok).

    Repair, recenter and Newton all reduce to ONE scaled normal solve
    (A·diag(s))(A·diag(s))ᵀ y = rhs with a branch-selected (s, rhs).
    ``per_lane``: a lane under ``torch.func.vmap`` (the dbound retry and
    the Krylov gate become per-lane selects); ``mesh``: see :func:`pdas`."""
    lp = st.lp
    sl, su, wu, zl, primal, dual = _violation(st)
    pobj, dobj = _objectives(st, cfg.clamp)
    gap = torch.abs(pobj - dobj) / torch.clamp_min(
        torch.maximum(torch.abs(pobj), torch.abs(dobj)), 1.0
    )
    pviol = torch.max(torch.abs(primal))
    repair_b = pviol >= cfg.primal_feasible_tol
    recenter_b = (~repair_b) & repair_flag
    newton_b = ~(repair_b | recenter_b)

    mask = lp.col_mask
    mv, rmv = _mv_rmv(lp)
    boost = _row_boost(lp)
    slack = _slack(lp.l, st.x, lp.u, cfg.repair_slack_cap, mask)
    red = kkt_reduce(sl, su, st.w, st.z, wu, zl, dual)
    c_dir = _centering_direction(lp.l, st.x, lp.u, mask)
    sc = -(slack * c_dir)

    s_sel = torch.where(newton_b, red.s, slack)
    rhs_sel = torch.where(
        repair_b,
        -primal,  # b - Ax (one-repair-iteration residual)
        torch.where(recenter_b, mv(slack * sc), primal - mv(red.alpha)),
    )
    gate = None
    if cfg.krylov_steps > 0 and cfg.krylov_gate_gap > 0.0:
        gate = gap < cfg.krylov_gate_gap
    solve_fn, ok = _prepare_normal_backend(
        lp, engine, s_sel, boost, cfg.refine_steps, mesh,
        cfg.dbound, cfg.krylov_steps, krylov_gate=gate,
        method=cfg.factor_method, per_lane=per_lane,
    )
    y = solve_fn(rhs_sel)
    ty = rmv(y)

    # --- newton branch updates (:367-379) ---
    d = kkt_backsub(red, sl, su, st.w, st.z, wu, zl, y, ty, ok)
    # Ratio tests on the TRUE slacks (not the floored ones).
    sl_t = torch.where(mask, st.x - lp.l, 1.0)
    su_t = torch.where(mask, lp.u - st.x, 1.0)
    gamma_n = cfg.gamma
    if cfg.mehrotra:
        # Mehrotra corrector on the SAME factorization; selected out on the
        # repair/recenter branches.  Present-bound sets mask padded columns.
        pu = (su <= FILTER_THRESHOLD) & mask
        pl = (sl <= FILTER_THRESHOLD) & mask
        t_aff = torch.clamp_max(
            torch.minimum(
                _box_step(sl_t, su_t, d.dx),
                torch.minimum(_pos_step(st.w, d.dw), _pos_step(st.z, d.dz)),
            ),
            1.0,
        )
        cnt = torch.clamp_min(torch.sum(pu) + torch.sum(pl), 1).to(sl.dtype)
        mu = (
            torch.sum(torch.where(pu, wu, 0.0))
            + torch.sum(torch.where(pl, zl, 0.0))
        ) / cnt
        wn = st.w - t_aff * d.dw
        sun = su + t_aff * d.dx
        zn = st.z - t_aff * d.dz
        sln = sl - t_aff * d.dx
        mu_aff = torch.clamp_min(
            (
                torch.sum(torch.where(pu, wn * sun, 0.0))
                + torch.sum(torch.where(pl, zn * sln, 0.0))
            ) / cnt,
            0.0,
        )
        tiny = torch.finfo(sl.dtype).tiny
        sigma = torch.clamp((mu_aff / torch.clamp_min(mu, tiny)) ** 3, 0.0, 1.0)
        target = sigma * mu
        de = torch.where(pu, -d.dw * d.dx - target, 0.0)
        df = torch.where(pl, d.dz * d.dx - target, 0.0)
        red2 = kkt_reduce(sl, su, st.w, st.z, wu + de, zl + df, dual)
        y2 = solve_fn(primal - mv(red2.alpha))
        d2 = kkt_backsub(
            red2, sl, su, st.w, st.z, wu + de, zl + df, y2, rmv(y2), ok
        )
        if cfg.gondzio_correctors > 0:
            # Gondzio's correctors on the same factor (PDASConfig): each
            # candidate is computed whether or not it is kept, and kept by a
            # select (the JAX package's vectorized accept), so a lane of the
            # batched loop runs them with no host read.
            def g_step(dd_):
                return torch.clamp_max(torch.minimum(
                    _box_step(sl_t, su_t, dd_.dx),
                    torch.minimum(_pos_step(st.w, dd_.dw), _pos_step(st.z, dd_.dz))),
                    1.0)

            def mu_pred(dd_, t_):
                # The duality measure at the DAMPED step this direction
                # would take: the accept checks progress, not only step
                # length.
                ts = cfg.mehrotra_gamma * t_
                return (torch.sum(torch.where(pu, (st.w - ts * dd_.dw) * (su + ts * dd_.dx),
                                              0.0))
                        + torch.sum(torch.where(pl, (st.z - ts * dd_.dz) * (sl - ts * dd_.dx),
                                                0.0))) / cnt

            t_cur = g_step(d2)
            mu_cur = mu_pred(d2, t_cur)
            de_acc, df_acc = de, df
            active = ok & (gap > cfg.gondzio_gate_gap)
            lo_t = cfg.gondzio_beta_min * target
            hi_t = cfg.gondzio_beta_max * target
            for _ in range(cfg.gondzio_correctors):
                t_t = torch.clamp_max(t_cur + cfg.gondzio_delta, 1.0)
                vu = (st.w - t_t * d2.dw) * (su + t_t * d2.dx)
                vl = (st.z - t_t * d2.dz) * (sl - t_t * d2.dx)
                de_t = de_acc - torch.where(pu, torch.clamp(vu, lo_t, hi_t) - vu, 0.0)
                df_t = df_acc - torch.where(pl, torch.clamp(vl, lo_t, hi_t) - vl, 0.0)
                red3 = kkt_reduce(sl, su, st.w, st.z, wu + de_t, zl + df_t, dual)
                y3 = solve_fn(primal - mv(red3.alpha))
                d3 = kkt_backsub(red3, sl, su, st.w, st.z, wu + de_t, zl + df_t, y3,
                                 rmv(y3), ok)
                t_new = g_step(d3)
                mu_new = mu_pred(d3, t_new)
                acc = active & (t_new >= t_cur + cfg.gondzio_gamma * cfg.gondzio_delta) & (
                    mu_new <= mu_cur)
                d2 = type(d2)(*(torch.where(acc, b, a) for a, b in zip(d2, d3)))
                de_acc = torch.where(acc, de_t, de_acc)
                df_acc = torch.where(acc, df_t, df_acc)
                t_cur = torch.where(acc, t_new, t_cur)
                mu_cur = torch.where(acc, mu_new, mu_cur)
                active = acc
        d = type(d)(*(torch.where(newton_b, c, a) for a, c in zip(d, d2)))
        gamma_n = cfg.mehrotra_gamma
    step_n = torch.minimum(
        _box_step(sl_t, su_t, d.dx),
        torch.minimum(_pos_step(st.w, d.dw), _pos_step(st.z, d.dz)),
    )
    t = torch.clamp_max(gamma_n * step_n, 1.0)
    x_n = _into_interior(st.x - t * d.dx, lp.l, lp.u, mask)
    w_n, y_n, z_n = st.w - t * d.dw, st.y - t * d.dy, st.z - t * d.dz

    # --- repair branch updates (one-repair-iteration :268-288) ---
    g_r = torch.where(mask, slack * ty, 0.0) * slack
    step_r = cfg.gamma * torch.clamp_max(
        _max_step(lp.l, st.x, lp.u, g_r, mask), 1.0 / cfg.gamma
    )
    floor = torch.minimum(lp.l + cfg.repair_floor, lp.u)
    x_r = torch.where(mask, torch.maximum(st.x + step_r * g_r, floor), st.x)
    x_r = torch.where(ok, _into_interior(x_r, lp.l, lp.u, mask), st.x)

    # --- recenter branch updates (:348-366) ---
    dx_rc = torch.where(mask, sc - slack * ty, 0.0) * slack
    step_c = 0.5 * _max_step(lp.l, st.x, lp.u, dx_rc, mask)
    x_c = torch.where(
        ok, _into_interior(st.x + step_c * dx_rc, lp.l, lp.u, mask), st.x
    )
    maskf = mask.to(st.w.dtype)
    w_c, z_c = st.w + 1e-4 * maskf, st.z + 1e-4 * maskf

    inf = torch.tensor(float("inf"), dtype=st.x.dtype, device=st.x.device)
    new = dataclasses.replace(
        st,
        x=torch.where(newton_b, x_n, torch.where(repair_b, x_r, x_c)),
        w=torch.where(newton_b, w_n, torch.where(recenter_b, w_c, st.w)),
        y=torch.where(newton_b, y_n, st.y),
        z=torch.where(newton_b, z_n, torch.where(recenter_b, z_c, st.z)),
    )
    return new, gap, pviol, torch.where(newton_b, step_n, inf), ok


def _bounced(cfg: PDASConfig, gap, best_gap):
    """Bounce exit (PDASConfig.bounce_exit_ratio)."""
    if cfg.bounce_exit_ratio <= 0.0:
        return torch.zeros((), dtype=torch.bool, device=gap.device)
    return (best_gap < cfg.bounce_exit_floor) & (
        gap > cfg.bounce_exit_ratio * best_gap
    )


def _new_trace(cfg: PDASConfig, n: int, dtype, device, n_iterates: int):
    """NaN-filled (gap, objective, step[, iterate columns...]) buffers."""
    rows = cfg.max_iters if (cfg.record_trace or cfg.record_iterates) else 0
    trace = [torch.full((rows,), float("nan"), dtype=dtype, device=device)
             for _ in range(3)]
    if cfg.record_iterates:
        trace += [torch.full((cfg.max_iters, n), float("nan"), dtype=dtype,
                             device=device) for _ in range(n_iterates)]
    return trace


class _Carry(NamedTuple):
    """The loop's carry besides the iterate and its count (the JAX
    ``while_loop`` carry): 0-dim tensors, or (B,) in a batch."""

    repair_flag: torch.Tensor
    gap: torch.Tensor
    pviol: torch.Tensor
    best_gap: torch.Tensor
    bad_count: torch.Tensor
    since_best: torch.Tensor
    status: torch.Tensor
    best_st: tuple  # (x, y, w, z) of the best pre-step iterate


def _start(st: PDASState) -> _Carry:
    dt, dev = st.x.dtype, st.x.device
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return _Carry(
        repair_flag=torch.zeros((), dtype=torch.bool, device=dev),
        gap=inf, pviol=inf, best_gap=inf, bad_count=zero, since_best=zero,
        status=torch.tensor(Status.RUNNING, dtype=torch.int32, device=dev),
        best_st=(st.x, st.y, st.w, st.z),
    )


def _keep_going(cfg: PDASConfig, c: _Carry):
    """The loop condition but the iteration budget, as a 0-dim bool tensor.
    The duality-gap stop only counts at a primal-feasible iterate."""
    converged = (c.gap < cfg.gap_tol) & (c.pviol < cfg.primal_feasible_tol)
    return (~converged & (c.status == Status.RUNNING)
            & (c.since_best < cfg.stall_exit_iters)
            & ~_bounced(cfg, c.gap, c.best_gap))


def _advance(cfg: PDASConfig, c: _Carry, st: PDASState, gap_i, pviol, step,
             ok) -> _Carry:
    """The carry after one iteration from ``st`` that measured gap_i, pviol,
    step and ok."""
    # Feasibility-gated best-iterate tracking of the PRE-step state.
    improved = (gap_i < c.best_gap) & (pviol < cfg.primal_feasible_tol)
    best_st = tuple(
        torch.where(improved, new, b)
        for b, new in zip(c.best_st, (st.x, st.y, st.w, st.z))
    )
    best_gap = torch.where(improved, gap_i, c.best_gap)
    since_best = torch.where(improved, 0, c.since_best + 1).to(torch.int32)
    stalled = torch.isfinite(step) & (step < cfg.stall_step)  # :393
    # Divergence detector: 4 consecutive gap increases arm the recenter.
    grew = torch.isfinite(step) & (gap_i > c.gap)
    bad_count = torch.where(grew, c.bad_count + 1, 0).to(torch.int32)
    repair_flag = stalled | (bad_count >= 4)
    bad_count = torch.where(repair_flag, 0, bad_count).to(torch.int32)
    return _Carry(
        repair_flag=repair_flag, gap=gap_i, pviol=pviol, best_gap=best_gap,
        bad_count=bad_count, since_best=since_best,
        status=torch.where(ok, Status.RUNNING, Status.SINGULAR).to(torch.int32),
        best_st=best_st,
    )


def _finish(cfg: PDASConfig, st: PDASState, c: _Carry) -> dict:
    """The result's tensors from the last iterate and the carry."""
    lp = st.lp
    # Return the best-seen iterate (<=: on convergence `gap` belongs to the
    # pre-step iterate recorded as best, the carry to the post-step one).
    use_best = c.best_gap <= c.gap
    bx, by, bw, bz = (
        torch.where(use_best, b, cur)
        for b, cur in zip(c.best_st, (st.x, st.y, st.w, st.z))
    )
    st = dataclasses.replace(st, x=bx, y=by, w=bw, z=bz)
    exit_bounced = _bounced(cfg, c.gap, c.best_gap)  # on the PRE-min exit gap
    gap = torch.minimum(c.best_gap, c.gap)
    pobj, dobj = _objectives(st, cfg.clamp)
    mv_f, _ = _mv_rmv(lp)
    primal_final = mv_f(st.x) - lp.b
    resid = torch.linalg.norm(primal_final)
    feasible = torch.max(torch.abs(primal_final)) < cfg.primal_feasible_tol
    final_status = torch.where(
        c.status != Status.RUNNING,
        c.status,
        torch.where(
            (gap < cfg.gap_tol) & feasible,
            Status.OPTIMAL,
            torch.where(
                (c.since_best >= cfg.stall_exit_iters) | exit_bounced,
                Status.PRECISION_FLOOR,
                Status.MAX_ITERS,
            ),
        ),
    ).to(torch.int32)
    return dict(x=st.x, objective=pobj, status=final_status,
                residual_norm=resid, gap=gap, dual_objective=dobj, y=st.y,
                w=st.w, z=st.z)


def _result(out: dict, iterations, trace, cfg: PDASConfig) -> SolveResult:
    return SolveResult(
        x=out["x"],
        objective=out["objective"],
        status=out["status"],
        iterations=iterations,
        residual_norm=out["residual_norm"],
        extra={
            "gap": out["gap"], "dual_objective": out["dual_objective"],
            "y": out["y"], "w": out["w"], "z": out["z"],
            "trace": {
                "gap": trace[0], "objective": trace[1], "step": trace[2],
                **({"x": trace[3]} if cfg.record_iterates else {}),
            },
        },
    )


@highest_precision
def _pdas_loop(state: PDASState, cfg: PDASConfig, engine,
               mesh=None) -> SolveResult:
    lp = state.lp
    trace = _new_trace(cfg, state.x.shape[0], state.x.dtype, state.x.device, 1)
    st, c, i = state, _start(state), 0
    while i < cfg.max_iters and bool(_keep_going(cfg, c)):
        new_st, gap_i, pviol, step, ok = _one_iteration(st, c.repair_flag, cfg,
                                                        engine, mesh=mesh)
        if cfg.record_trace or cfg.record_iterates:
            vals = [gap_i, torch.dot(st.x, lp.c), step]
            if cfg.record_iterates:
                vals.append(st.x)
            for buf, v in zip(trace, vals):
                buf[i] = v
        c = _advance(cfg, c, st, gap_i, pviol, step, ok)
        st, i = new_st, i + 1
    return _result(_finish(cfg, st, c), torch.tensor(i, dtype=torch.int32),
                   trace, cfg)


def _write_trace(trace, i, active, vals) -> list:
    """Each active lane's values into its own row ``i`` of the (B, rows,
    ...) trace buffers (a frozen lane writes nothing)."""
    if not trace or trace[0].shape[1] == 0:
        return trace
    rows = torch.arange(trace[0].shape[1], device=i.device)
    hit = active[:, None] & (rows[None, :] == i[:, None])
    out = []
    for buf, v in zip(trace, vals):
        h = hit.view(*hit.shape, *([1] * (buf.dim() - 2)))
        out.append(torch.where(h, v.to(buf.dtype).unsqueeze(1), buf))
    return out


def _lane_loop(cfg, st, c, step, finish, trace, iterates=None,
               keep_going=None):
    """The batched ``while_loop`` over stacked states ``st`` with the
    per-lane carry ``c`` (of :func:`_start`, its pdas_dd twin or the affine
    loop's): each iteration is ``lanes.vmap(step, st, c)`` -> (the state's
    new fields by name, the new carry, the trace's values); a lane whose
    own condition (``keep_going(carry)``, by default :func:`_keep_going`,
    and the budget ``cfg.max_iters``) fails keeps its iterate, carry,
    count and trace rows from then on, as a lane of the JAX package's
    vmapped ``while_loop`` does.  One host read per iteration: whether any
    lane is still running.  ``iterates(st)`` gives the trace's iterate
    columns, where they are recorded.  Returns (``lanes.vmap(finish, st,
    c)``, the per-lane counts, the trace)."""
    first = lanes.flatten(c)[0][0]
    i = torch.zeros(first.shape[0], dtype=torch.int32, device=first.device)
    if keep_going is None:
        keep_going = lambda k: _keep_going(cfg, k)  # noqa: E731
    record = bool(trace) and trace[0].shape[1] > 0

    def active_lanes():
        return (i < cfg.max_iters) & lanes.vmap(keep_going, c)

    active = active_lanes()
    while bool(active.any()):
        new_fields, new_c, vals = lanes.vmap(step, st, c)
        if record:
            vals = list(vals) + (iterates(st) if iterates else [])
            trace = _write_trace(trace, i, active, vals)
        old = {k: getattr(st, k) for k in new_fields}
        st = dataclasses.replace(st, **lanes.select(active, new_fields, old))
        c = lanes.select(active, new_c, c)
        i = i + active.to(torch.int32)
        active = active_lanes()
    return lanes.vmap(finish, st, c), i, trace


def _lane_trace(cfg: PDASConfig, B: int, n: int, dtype, device,
                n_iterates: int) -> list:
    """:func:`_new_trace`'s buffers with a leading lane axis."""
    return [t.expand(B, *t.shape).clone()
            for t in _new_trace(cfg, n, dtype, device, n_iterates)]


@highest_precision
def _pdas_lanes(states: PDASState, cfg: PDASConfig, engine=None) -> SolveResult:
    """:func:`_pdas_loop` over stacked states (every tensor with a leading
    lane axis B) by :func:`_lane_loop`: each iteration vmaps
    :func:`_one_iteration` with ``per_lane`` (no host read inside it).
    Dense states, with or without a dense-A ``engine`` of their shared
    pattern (each lane assembles from its own A), or sparse states of one A
    with its ``engine`` (the lanes share the engine's schedule and differ in
    b, c, l, u and iterates).  Returns one SolveResult whose tensors have
    the lane axis first."""
    check_backend(states.lp, engine, None)
    B, n = states.x.shape
    trace = _lane_trace(cfg, B, n, states.x.dtype, states.x.device, 1)

    def step(st, c):
        new_st, gap_i, pviol, stp, ok = _one_iteration(
            st, c.repair_flag, cfg, engine, per_lane=True)
        return (dict(x=new_st.x, y=new_st.y, w=new_st.w, z=new_st.z),
                _advance(cfg, c, st, gap_i, pviol, stp, ok),
                (gap_i, torch.dot(st.x, st.lp.c), stp))

    out, i, trace = _lane_loop(
        cfg, states, lanes.vmap(_start, states), step,
        lambda s, k: _finish(cfg, s, k), trace,
        (lambda s: [s.x]) if cfg.record_iterates else None)
    return _result(out, i, trace, cfg)
