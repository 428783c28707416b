"""Crossover: polish an interior-point iterate to a vertex-exact solution.

Counterpart of ``cholesky_is_magic_tpu/solvers/crossover.py``, with its
names, so each function has its twin there.  The reference stops at the
interior gap its f64 arithmetic reaches; crossover reads the active set off
the final iterate and turns it into a certified vertex for one more
normal-equations factorization:

1. **Classify** each column as basic or bound-active (basic iff
   ``min(x-l, u-x) > theta * (z + w)``; free and padded columns are basic).
2. **Snap** nonbasic columns to their nearer bound, leaving B x_B = r.
3. **Solve through the IPM's own normal equations** with d = 1_basic:
   N_B = B·Bᵀ, factored by ops.dense.prepare_normal, a dense-A engine's
   prepare_normal or the tile engine's prepare_normal_ell (dbound singular
   retry and PCG refinement included).
4. **Double-word iterative refinement** around the f32 factor: the
   right-hand sides are O(1)-class, so the residual is re-evaluated in
   double-word against the exact operator and the correction re-solved.
5. **Duals and certificate**: y from the same factorization, rc = c - Aᵀy
   in double-word, z / w the sign-clipped rc on the on-bound columns, and a
   dd-evaluated certificate (primal and dual residuals, bound violation,
   gap).  ``certified`` is a checked claim; when it fails the caller gets
   the original iterate back.

A host-driven repair loop (:func:`crossover`) moves columns between the
basic and the bound-active sets when the certificate fails on a degenerate
face.  The partition lives on the host as NumPy booleans; each pass uploads
its three masks once and reads the certificate's scalars with one transfer.
Nothing here is compiled: keep ``torch.compile`` away from the double-word
reductions (ops/dd.py).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from cholesky_is_magic_tpu_torch.ingest.device import SparseKKTLP
from cholesky_is_magic_tpu_torch.ops import dd as ddm
from cholesky_is_magic_tpu_torch.ops.dd import DD
from cholesky_is_magic_tpu_torch.solvers.backend import (
    check_backend,
    dd_linops,
    prepare_normal_backend,
    row_boost,
)
from cholesky_is_magic_tpu_torch.solvers.result import SolveResult, Status
from cholesky_is_magic_tpu_torch.utils.precision import highest_precision

# Per-pass repair-loop tracing (developer aid): CIM_XO_DEBUG=1.
_DEBUG = os.environ.get("CIM_XO_DEBUG", "") not in ("", "0")

# The certificate's scalars, in the order _polish stacks them for one read.
_CERT_KEYS = ("certified", "factor_ok", "primal_rel", "bound_violation",
              "dual_rel", "gap", "n_basic", "n_lower", "n_upper")


@dataclasses.dataclass(frozen=True)
class CrossoverConfig:
    """Field for field the JAX package's CrossoverConfig (its comments give
    the measurements behind each default)."""

    # Basic iff min(sl, su) > theta * (z + w): the standard primal-dual
    # indicator.
    theta: float = 1.0
    # Outer double-word iterative-refinement rounds around the f32 factor.
    ir_steps: int = 3
    # Inner refinement of each f32 solve: flexible PCG steps on the f32
    # factor (ops.krylov); 0 falls back to Richardson (refine_steps).
    krylov_steps: int = 6
    refine_steps: int = 2  # Richardson depth when krylov_steps == 0
    dbound: float = 1e-6  # singular-retry jitter (ops.dense.prepare_normal)
    # Certificate tolerances (relative, dd-evaluated).
    primal_tol: float = 1e-6
    dual_tol: float = 1e-6
    gap_tol: float = 1e-7
    # Repair passes (one factorization each); 0 = single-shot.
    max_repairs: int = 12
    # Widen-repair threshold on the polished rc, scaled by sqrt(gap); 0.0
    # disables the whole widen family (pricing-widen included).
    widen_dual_tol: float = 1e-3
    # Demote reach, scaled by 3·sqrt(gap_in); 0.0 disables the whole demote
    # family (the sign-directed forced demote included).
    demote_near_tol: float = 1e-3
    # Demote bulk cap while the primal side of the certificate is clean.
    demote_max: int = 16
    # Max columns per OMP completion pass (the escalation after a
    # regressed widen); 0 disables it.
    omp_widen_max: int = 64
    # |bound| above this is "no bound" for snapping (the PDAS clamp).
    clamp: float = 1e8
    # Entry min-norm repair toward Ax = b when the entry's relative primal
    # infeasibility exceeds this; 0.0 disables.
    entry_repair_tol: float = 1e-6
    # Refinement rounds for the entry-repair solve.
    entry_repair_ir: int = 2


def classify_basis(x, z, w, l, u, col_mask, theta: float = 1.0,
                   clamp: float = 1e8):
    """Partition columns into (basic, at_lower, at_upper) boolean masks.

    The primal-dual indicator: basic iff min-slack > theta * dual.  Free
    columns (both bounds at the clamp) and padded columns are basic; a
    column whose NEARER bound is unclamped never snaps to the clamp value.
    """
    sl = x - l
    su = u - x
    dual = torch.abs(z) + torch.abs(w)
    has_l = l > -0.999 * clamp
    has_u = u < 0.999 * clamp
    inf = torch.full_like(sl, float("inf"))
    smin = torch.where(has_l & has_u, torch.minimum(sl, su),
                       torch.where(has_l, sl, torch.where(has_u, su, inf)))
    basic = (smin > theta * dual) | ~col_mask | ~(has_l | has_u)
    lower_nearer = torch.where(has_l & has_u, sl <= su, has_l)
    at_lower = ~basic & lower_nearer
    at_upper = ~basic & ~lower_nearer
    return basic, at_lower, at_upper


def _mask_dd(m, v: DD) -> DD:
    # m is 0/1 (or bool): the product is exact.
    mf = m.to(v.hi.dtype) if m.dtype == torch.bool else m
    return DD(mf * v.hi, mf * v.lo)


def _ops_for(lp, engine):
    """(prepare, mv_dd, rmv_dd, boost) for the operand set, from
    solvers.backend: ops.dense, a dense-A engine's tiles (sparse.engine_for,
    BlockSparseCholesky) or the tile engine of the fully sparse set."""
    check_backend(lp, engine, None)
    boost = row_boost(lp)
    mv_dd, rmv_dd, _ = dd_linops(lp)

    def prepare(d, cfg):
        return prepare_normal_backend(
            lp, engine, d, boost, cfg.refine_steps, dbound=cfg.dbound,
            krylov_steps=cfg.krylov_steps,
        )

    return prepare, mv_dd, rmv_dd, boost


def _ir_solve(solve_fn, apply_dd, rhs: DD, steps: int) -> DD:
    """Double-word iterative refinement: y_{k+1} = y_k + M⁻¹(rhs - N y_k)
    with the residual in dd against the exact operator (Wilkinson IR; the
    f32 factorization M only needs to contract, dd carries the accuracy)."""
    y = ddm.dd_from(solve_fn(rhs.to_working()))
    for _ in range(steps):
        r = ddm.dd_sub(rhs, apply_dd(y))
        y = ddm.dd_add(y, ddm.dd_from(solve_fn(r.to_working())))
    return y


def _dd_dot_full(a, x: DD) -> DD:
    # a (exact) · x (dd), compensated: dd_dot on hi + plain dot on lo.
    return ddm.dd_add_w(ddm.dd_dot(a, x.hi), torch.dot(a, x.lo))


def _mask_dot(mask, coef, v: DD) -> DD:
    """Σ_mask coef_j * v_j in dd.  The caller folds the dual sign/support
    condition into ``mask`` so no operand is ever negated (negate results,
    never the inputs of a dd reduction: docs/DEVNOTES.md "neg upstream of
    dd reductions")."""
    c = torch.where(mask, coef, torch.zeros_like(coef))
    return ddm.dd_add_w(ddm.dd_dot(c, v.hi), torch.dot(c, v.lo))


def _normal_apply_dd(d, mv_dd, rmv_dd, boost):
    """N_d v = A (d ∘ (Aᵀ v)) + boost ∘ v, all in double-word."""

    def apply_dd(v: DD) -> DD:
        out = mv_dd(_mask_dd(d, rmv_dd(v)))
        return ddm.dd_add_w(out, boost * v.to_working())

    return apply_dd


@highest_precision
def _polish(lp, x_hi, x_lo, y0, basic, at_lower, at_upper,
            cfg: CrossoverConfig, engine=None):
    """One polish pass for a FIXED partition (the body of the JAX
    package's ``_polish_jit``; see crossover() for the loop around it).

    PROXIMAL form: both solves are for gap-sized CORRECTIONS from the IPM
    iterate, so on a degenerate (rank-deficient) basis the f32
    null-direction noise scales with the correction, not with ‖b‖.
    Returns (x_dd, y_d, z_out, w_out, pobj, dobj, primal_norm, rc_hi,
    price, cert) with ``cert`` the certificate's scalars stacked in
    _CERT_KEYS order (one tensor, one host read)."""
    d = basic.to(lp.c.dtype)
    prepare, mv_dd, rmv_dd, boost = _ops_for(lp, engine)
    solve_fn, ok = prepare(d, cfg)
    apply_dd = _normal_apply_dd(d, mv_dd, rmv_dd, boost)
    zero = torch.zeros_like(x_hi)

    # --- Primal: snap nonbasic to bounds, correct the basic block. ---
    x_n = torch.where(at_lower, lp.l, torch.where(at_upper, lp.u, zero))
    x0 = DD(torch.where(basic, x_hi, x_n), torch.where(basic, x_lo, zero))
    ax0 = mv_dd(x0)
    rhs_p = ddm.dd_sub(ddm.dd_from(lp.b), ax0)  # b - A x0 (dd, ~gap-sized)
    y_p = _ir_solve(solve_fn, apply_dd, rhs_p, cfg.ir_steps)
    t = _mask_dd(d, rmv_dd(y_p))  # basic correction Aᵀ y (dd)
    x_dd = ddm.dd_add(x0, t)  # nonbasic entries: t is 0 there by the mask

    # --- Dual: correct y from the iterate, same factorization. ---
    y0_dd = ddm.dd_from(y0)
    rc0 = ddm.dd_sub(ddm.dd_from(lp.c), rmv_dd(y0_dd))
    rhs_d = mv_dd(_mask_dd(d, rc0))  # B rc_B (dd, ~gap-sized)
    dy = _ir_solve(solve_fn, apply_dd, rhs_d, cfg.ir_steps)
    y_d = ddm.dd_add(y0_dd, dy)
    rc = ddm.dd_sub(rc0, rmv_dd(dy))  # c - Aᵀ y (dd)

    # The duals and the whole certificate are read off the POLISHED POINT,
    # not the solve partition: a (widened) basic column that lands on its
    # bound may legitimately carry a dual on a degenerate face.
    mask_f = lp.col_mask
    on_tol = cfg.primal_tol
    on_l = mask_f & (lp.l > -0.999 * cfg.clamp) & (
        torch.abs(x_dd.hi - lp.l) <= on_tol * (1.0 + torch.abs(lp.l))
    )
    on_u = mask_f & (lp.u < 0.999 * cfg.clamp) & (
        torch.abs(x_dd.hi - lp.u) <= on_tol * (1.0 + torch.abs(lp.u))
    ) & ~on_l
    z_out = torch.where(on_l, torch.clamp_min(rc.hi, 0.0), zero)
    w_out = torch.where(on_u, torch.clamp_min(-rc.hi, 0.0), zero)

    # --- Certificate, every term double-word, all point-based. ---
    ax = mv_dd(x_dd)
    primal_res = ddm.dd_add_w(ax, -lp.b).to_working()
    primal_norm = torch.linalg.norm(primal_res)
    # SIGNED residual pricing Aᵀ(Ax - b) for the pricing-widen repair: a
    # column at its LOWER bound absorbs infeasibility only when this score
    # is negative (the mirror for upper); the host applies the sign rule.
    price = rmv_dd(ddm.dd_from(primal_res)).to_working()
    primal_rel = torch.max(torch.abs(primal_res)) / (1.0 + torch.max(torch.abs(lp.b)))
    bound_viol = torch.max(torch.where(
        mask_f, torch.maximum(lp.l - x_dd.hi, x_dd.hi - lp.u), zero))
    # Dual residual: strictly-interior columns need rc = 0; on-bound
    # columns only the sign-violating part is an error.
    dual_err = torch.where(
        on_l, torch.clamp_min(-rc.hi, 0.0),
        torch.where(
            on_u, torch.clamp_min(rc.hi, 0.0),
            torch.where(mask_f, torch.abs(rc.to_working()), zero),
        ),
    )
    dual_rel = torch.max(dual_err) / (1.0 + torch.max(torch.abs(lp.c)))

    pobj = _dd_dot_full(lp.c, x_dd)
    # b'y + l'z - u'w over the on-bound columns, written WITHOUT negating
    # any reduction operand: with w = -rc on the on_u & rc<0 columns,
    # -u'w = +Σ u*rc there, so both bound payments are masked dots of rc.
    dobj = ddm.dd_add(
        _dd_dot_full(lp.b, y_d),
        ddm.dd_add(
            _mask_dot(on_l & (rc.hi > 0.0), lp.l, rc),
            _mask_dot(on_u & (rc.hi < 0.0), lp.u, rc),
        ),
    )
    gap = torch.abs(ddm.dd_sub(pobj, dobj).to_working()) / (
        1.0 + torch.abs(pobj.to_working())
    )

    # Bound-magnitude scale over ALL finite bounds.
    bscale = torch.maximum(
        torch.max(torch.where((torch.abs(lp.u) < cfg.clamp) & mask_f,
                              torch.abs(lp.u), zero)),
        torch.max(torch.where((torch.abs(lp.l) < cfg.clamp) & mask_f,
                              torch.abs(lp.l), zero)),
    )
    certified = (
        ok
        & (primal_rel < cfg.primal_tol)
        & (bound_viol < cfg.primal_tol * (1.0 + bscale))
        & (dual_rel < cfg.dual_tol)
        & (gap < cfg.gap_tol)
    )
    dt = primal_rel.dtype
    cert = torch.stack([
        certified.to(dt), ok.to(dt), primal_rel, bound_viol, dual_rel, gap,
        torch.sum(basic & mask_f).to(dt), torch.sum(on_l).to(dt),
        torch.sum(on_u).to(dt),
    ])
    return (x_dd, y_d, z_out, w_out, pobj, dobj, primal_norm, rc.hi,
            price, cert)


def _cert_to_host(cert: torch.Tensor) -> dict:
    """The stacked certificate -> {key: bool | float | int} (one read)."""
    v = cert.cpu().tolist()
    out = dict(zip(_CERT_KEYS, v))
    for k in ("certified", "factor_ok"):
        out[k] = bool(out[k])
    for k in ("n_basic", "n_lower", "n_upper"):
        out[k] = int(out[k])
    return out


@highest_precision
def _entry_repair(lp, x_hi, x_lo, cfg: CrossoverConfig, engine=None):
    """Min-norm LS correction of the ENTRY iterate toward Ax = b (the body
    of the JAX package's ``_entry_repair_jit``).

    The reference's repair iteration over ALL columns: with r = b - Ax,
    solve (AAᵀ) dy = r (d = col_mask) and take x += Aᵀ dy, in double-word
    with PCG refinement on the f32 factor.  Returns (x_hi, x_lo,
    pviol_before, pviol_after) with pviol the relative ∞-norm primal
    infeasibility the certificate uses."""
    prepare, mv_dd, rmv_dd, boost = _ops_for(lp, engine)
    d = lp.col_mask.to(lp.c.dtype)
    solve_fn, ok = prepare(d, cfg)
    apply_dd = _normal_apply_dd(d, mv_dd, rmv_dd, boost)

    x = DD(x_hi, x_lo)
    bscale = 1.0 + torch.max(torch.abs(lp.b))
    r0 = ddm.dd_sub(ddm.dd_from(lp.b), mv_dd(x))
    pv0 = torch.max(torch.abs(r0.to_working())) / bscale
    dy = _ir_solve(solve_fn, apply_dd, r0, cfg.entry_repair_ir)
    x1 = ddm.dd_add(x, _mask_dd(d, rmv_dd(dy)))
    r1 = ddm.dd_sub(ddm.dd_from(lp.b), mv_dd(x1))
    pv1 = torch.max(torch.abs(r1.to_working())) / bscale
    # Keep the repair only where it helped (ok guards a singular factor).
    use = ok & (pv1 < pv0)
    return (torch.where(use, x1.hi, x.hi), torch.where(use, x1.lo, x.lo),
            pv0, torch.where(use, pv1, pv0))


def _to_host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _column_norms(lp) -> np.ndarray:
    """Host-side ‖a_j‖ per column, for pricing-score normalization (the
    cosine form makes the score scale-invariant).  One-time O(nnz)."""
    if isinstance(lp, SparseKKTLP):
        vals = _to_host(lp.ET.values).astype(np.float64)  # row i of ET = col i of A
        nrm = np.sqrt((vals * vals).sum(axis=1))
    else:
        nrm = np.linalg.norm(_to_host(lp.A).astype(np.float64), axis=0)
    return np.maximum(nrm, 1e-30)


def _host_csc(lp):
    """Host-side fp64 CSC of A (one-time, lazy — built only when the OMP
    completion triggers).  For the ELL operand set the padded slots carry
    value 0.0 and are eliminated."""
    import scipy.sparse as sp

    if isinstance(lp, SparseKKTLP):
        idx = _to_host(lp.E.indices).astype(np.int64)
        vals = _to_host(lp.E.values).astype(np.float64)
        m, k = idx.shape
        rows = np.repeat(np.arange(m, dtype=np.int64), k)
        A = sp.csc_matrix(
            (vals.ravel(), (rows, idx.ravel())), shape=(m, lp.E.n_cols)
        )
        A.eliminate_zeros()
        return A
    return sp.csc_matrix(_to_host(lp.A).astype(np.float64))


def _omp_select(A_csc, r0, basic, elig_l, elig_u, col_norm, k_max: int,
                stop_inf: float):
    """Orthogonal-matching-pursuit basis completion (host fp64).

    The rank-deficit failure mode: the classified basis B misses a handful
    of columns, so the snap residual r0 has a component outside range(B)
    that no refinement removes, and correlation-only admission picks
    near-parallel candidates.  After each pick the candidate pool is
    re-scored against the residual deflated by the selected direction's
    range(B)-COMPLEMENT component (LSMR projection + Gram-Schmidt), so
    near-parallel junk scores ~0 once its direction is covered.  r0 itself
    needs no projection (the polish residual IS the basic least-squares
    residual).

    Sign eligibility per step: an at-lower column may only increase
    (a_jᵀ r > 0), an at-upper column only decrease (mirror).

    Returns (selection mask, deflated residual inf-norm).
    """
    from scipy.sparse.linalg import lsmr

    r = np.asarray(r0, np.float64).copy()
    n = A_csc.shape[1]
    B = A_csc[:, np.flatnonzero(basic)]
    Q: list[np.ndarray] = []
    sel: list[int] = []
    for _ in range(max(k_max, 0)):
        if np.linalg.norm(r, np.inf) <= stop_inf:
            break
        s = (A_csc.T @ r) / col_norm
        score = np.where((elig_l & (s > 0.0)) | (elig_u & (s < 0.0)),
                         np.abs(s), 0.0)
        if sel:
            score[np.asarray(sel)] = 0.0
        j = int(np.argmax(score))
        if score[j] <= stop_inf * 1e-3:
            break  # no sign-eligible candidate sees the leftover residual
        a_j = np.asarray(A_csc[:, [j]].todense(), np.float64).ravel()
        # range(B)-complement component of a_j (LSMR: min ‖B t − a_j‖).
        t = lsmr(B, a_j, atol=1e-12, btol=1e-12, maxiter=2000)[0]
        q = a_j - B @ t
        for qk in Q:
            q -= (qk @ q) * qk
        nq = np.linalg.norm(q)
        if nq <= 1e-10 * col_norm[j]:
            # Numerically inside span(B ∪ selected): the correlation was
            # projection noise — stop rather than admit junk.
            break
        q /= nq
        Q.append(q)
        sel.append(j)
        r -= (q @ r) * q
    mask = np.zeros(n, bool)
    if sel:
        mask[np.asarray(sel)] = True
    return mask, float(np.linalg.norm(r, np.inf))


def crossover(
    result: SolveResult,
    lp,
    engine=None,
    config: Optional[CrossoverConfig] = None,
) -> SolveResult:
    """Polish an IPM result to a vertex-exact, certified solution.

    ``result`` must carry duals (extra y/w/z — pdas, pdas_dd and the api
    front door all do).  ``lp`` is the DeviceLP / SparseKKTLP the solver
    ran on; pass the same ``engine`` for the fully sparse path, or a sparse
    engine of a DeviceLP's A (``sparse.engine_for``,
    ``BlockSparseCholesky``) to factor B·Bᵀ by its tiles.  The
    returned SolveResult has the polished x / objective / duals and
    ``extra["crossover"]`` with the dd-evaluated certificate; when
    ``certified`` is False the ORIGINAL result is returned, with only
    ``extra["crossover"]`` added — crossover never makes the answer worse.

    Degenerate faces: up to ``config.max_repairs`` repair passes, each one
    factorization, host-driven.  A bound violation is repaired exclusively
    (push-to-bound); otherwise the dual-side and primal-side repairs are
    selected independently and applied in the SAME pass:

    - dual residual -> demote a near-bound basic column whose post-solve
      |rc| stays large to its near bound (bulk while the primal is clean,
      else one per pass); with no near-bound candidate, the sign-violation
      widen, then the sign-directed forced demote;
    - primal residual -> widen zero-rc bound-active columns with pricing
      relevance; with none, pricing-widen one column per pass; after a
      regressed multi-column widen, OMP completion on the host.

    Thresholds scale with the current certificate gap and the incoming IPM
    gap; a repeated (partition, ban-list) state ends the loop, and evicted
    widen candidates are banned from re-admission.
    """
    cfg = config or CrossoverConfig()
    x = result.x
    z = result.extra["z"]
    w = result.extra["w"]
    y0 = result.extra["y"]
    x_lo = result.extra.get("x_lo")
    if x_lo is None:
        x_lo = torch.zeros_like(x)
    l_np = _to_host(lp.l).astype(np.float64)
    u_np = _to_host(lp.u).astype(np.float64)
    b_host = _to_host(lp.b).astype(np.float64)
    entry_pviol = (None, None)
    if cfg.entry_repair_tol > 0.0:
        # Gate host-side on the solver's own primal residual so clean
        # entries pay nothing (the 2-norm bounds the relative ∞-norm the
        # repair targets).
        rel = float(result.residual_norm) / (1.0 + float(np.max(np.abs(b_host))))
        if rel > cfg.entry_repair_tol:
            x, x_lo, pv0, pv1 = _entry_repair(lp, x, x_lo, cfg, engine=engine)
            entry_pviol = tuple(torch.stack([pv0, pv1]).cpu().tolist())
            if _DEBUG:
                print(f"[crossover] entry repair: pviol {entry_pviol[0]:.3e}"
                      f" -> {entry_pviol[1]:.3e}")
    parts = classify_basis(
        x, z, w, lp.l, lp.u, lp.col_mask, theta=cfg.theta, clamp=cfg.clamp
    )
    basic, at_lower, at_upper = (_to_host(p) for p in parts)
    has_l = l_np > -0.999 * cfg.clamp
    has_u = u_np < 0.999 * cfg.clamp
    # Violation tolerance scales with the magnitude of ALL finite bounds
    # (mirroring the certificate's bscale).
    bmag = max(
        np.max(np.abs(np.where(has_u, u_np, 0.0))),
        np.max(np.abs(np.where(has_l, l_np, 0.0))),
    )
    tol = cfg.primal_tol * (1.0 + bmag)
    c_np = np.abs(_to_host(lp.c).astype(np.float64))
    cm_np = _to_host(lp.col_mask)
    col_norm = _column_norms(lp)
    widened = np.zeros(c_np.shape, bool)
    # Persistent ban set: a widened column that a later pass evicted
    # (demote or revert) may not be re-admitted by ANY widen rule.
    banned = np.zeros(c_np.shape, bool)
    gap_in = float(result.extra.get("gap", np.inf))  # IPM gap: trustworthy
    repairs = 0
    seen_partitions = set()
    prev = None  # (basic, at_lower, at_upper, widened, score, act_wid)
    use_omp = False  # escalate widen selection to OMP (see omp_widen_max)
    n_reverts = 0
    A_host = None  # lazy host CSC, built only if OMP fires
    put = lambda a: torch.from_numpy(a).to(x.device)  # noqa: E731
    while True:
        (x_dd, y_d, z_out, w_out, pobj, dobj, primal_norm, rc_hi,
         price, cert_t) = _polish(
            lp, x, x_lo, y0, put(basic), put(at_lower), put(at_upper), cfg,
            engine=engine,
        )
        cert = _cert_to_host(cert_t)
        if _DEBUG:
            print(f"[crossover] pass {repairs}: "
                  f"certified={cert['certified']} "
                  f"primal {cert['primal_rel']:.2e} "
                  f"dual {cert['dual_rel']:.2e} "
                  f"gap {cert['gap']:.2e} "
                  f"bv {cert['bound_violation']:.2e} "
                  f"basic {cert['n_basic']}")
        if cert["certified"] or repairs >= cfg.max_repairs:
            break
        # How badly the certificate fails, in tolerance units.
        fail_score = max(cert["primal_rel"] / cfg.primal_tol,
                         cert["dual_rel"] / cfg.dual_tol)
        if prev is not None and prev[5].any() and fail_score > 10.0 * prev[4]:
            # Revert-on-regression: the last action admitted columns and
            # made the certificate DECISIVELY worse.  Restore the
            # pre-action partition, permanently ban the admitted columns,
            # and let the next pass pick the next candidate.  Each revert
            # bans at least one column, so this cannot loop forever.
            basic, at_lower, at_upper, widened = prev[:4]
            banned = banned | prev[5]
            n_reverts += 1
            # A reverted MULTI-column widen (or repeated single reverts):
            # the next widen goes through OMP.
            if int(prev[5].sum()) > 1 or n_reverts >= 3:
                use_omp = True
            if _DEBUG:
                print(f"[crossover]   revert+ban {int(prev[5].sum())} "
                      f"(score {prev[4]:.1e} -> {fail_score:.1e})"
                      + (" -> OMP" if use_omp else ""))
            prev = None
            repairs += 1
            continue
        # The loop state is (partition, ban list): `widened` and `banned`
        # are part of the cycle key, so a push that evicts a just-widened
        # column still lets the next pass try the next pricing candidate.
        key = (basic.tobytes() + at_lower.tobytes()
               + widened.tobytes() + banned.tobytes())
        if key in seen_partitions:
            break  # true 2-cycle: the face straddles the tols
        seen_partitions.add(key)
        gap_now = max(cert["gap"], 0.0)
        sqrt_gap = float(np.sqrt(gap_now))
        # Widen scaling gap: the smaller of the current certificate gap
        # and the INCOMING iterate's IPM gap.
        sqrt_gap_safe = float(np.sqrt(min(gap_now, max(gap_in, 0.0))))
        # Demote reach scales with the INCOMING gap alone.
        sqrt_gap_in = float(np.sqrt(max(gap_in, 0.0))) \
            if np.isfinite(gap_in) else sqrt_gap
        xp = _to_host(x_dd.hi).astype(np.float64) + _to_host(x_dd.lo).astype(np.float64)
        b_np = basic
        viol_l = b_np & has_l & (xp < l_np - tol)
        viol_u = b_np & has_u & (xp > u_np + tol)
        if viol_l.any() or viol_u.any():
            basic = b_np & ~(viol_l | viol_u)
            at_lower = at_lower | viol_l
            at_upper = at_upper | viol_u
            repairs += 1
            if _DEBUG:
                print(f"[crossover]   push {int((viol_l | viol_u).sum())}")
            continue
        # --- Select repairs.  Demote (evict basic) and widen (admit
        # nonbasic) act on DISJOINT column sets, so when both sides of the
        # certificate fail, both repairs apply in the SAME pass.
        sel_dem_l = np.zeros_like(b_np)
        sel_dem_u = np.zeros_like(b_np)
        sel_wid = np.zeros_like(b_np)
        rc_np = _to_host(rc_hi).astype(np.float64)
        if cert["dual_rel"] > cfg.dual_tol and cfg.demote_near_tol > 0:
            # Dual-driven demotion: a basic column whose |rc| stayed large
            # cannot be basic.  Widened columns demote unconditionally to
            # their NEAR bound; other basic columns only within the
            # gap-scaled reach of a bound.
            large_rc = b_np & cm_np & (
                np.abs(rc_np) > cfg.dual_tol * (1.0 + c_np)
            )
            reach = max(cfg.demote_near_tol, 3.0 * sqrt_gap_in)
            near_bound = (
                (has_l & (np.abs(xp - l_np)
                          <= reach * (1.0 + np.abs(l_np))))
                | (has_u & (np.abs(u_np - xp)
                            <= reach * (1.0 + np.abs(u_np))))
            )
            demote = large_rc & (widened | near_bound)
            # Bulk cap: every offender in one pass while the primal side is
            # CLEAN and no candidate is a widened column; otherwise
            # single-column pivot discipline.
            primal_clean = cert["primal_rel"] < cfg.primal_tol
            bulk = (cfg.demote_max
                    if primal_clean and not (demote & widened).any() else 1)
            if int(demote.sum()) > bulk:
                keep = np.argsort(-np.abs(np.where(demote, rc_np, 0.0))
                                  )[:bulk]
                demote = np.zeros_like(demote)
                demote[keep] = True
            if not demote.any():
                # Sign-violation widen (one column): a NONBASIC on-bound
                # column with an infeasible-sign rc is the simplex
                # entering-column signal.  Banned columns excluded.
                sviol = cm_np & ~b_np & ~widened & ~banned & (
                    (at_lower & (rc_np < -cfg.dual_tol * (1.0 + c_np)))
                    | (at_upper & (rc_np > cfg.dual_tol * (1.0 + c_np)))
                )
                if sviol.any():
                    j_s = int(np.argmax(np.where(sviol, np.abs(rc_np), 0.0)))
                    sel_wid[j_s] = True
                    if _DEBUG:
                        print(f"[crossover]   sign-widen j={j_s} "
                              f"rc={rc_np[j_s]:.2e}")
                elif large_rc.any():
                    # Forced demote (one column, SIGN-directed): rc_j > 0
                    # pins x_j at its LOWER bound, rc_j < 0 at its upper.
                    # Only columns whose sign-preferred bound exists are
                    # candidates.
                    pref_ok = np.where(rc_np > 0.0, has_l, has_u)
                    cand = large_rc & pref_ok
                    if cand.any():
                        j_f = int(np.argmax(
                            np.where(cand, np.abs(rc_np), 0.0)))
                        if rc_np[j_f] > 0.0:
                            sel_dem_l[j_f] = True
                        else:
                            sel_dem_u[j_f] = True
            else:
                near_l = (demote & has_l
                          & (((xp - l_np) <= (u_np - xp)) | ~has_u))
                near_u = demote & has_u & ~near_l
                sel_dem_l, sel_dem_u = near_l, near_u  # free cols excluded
        omp_fired = False
        if (use_omp and cfg.omp_widen_max > 0
                and cert["primal_rel"] > cfg.primal_tol
                and cfg.widen_dual_tol > 0):
            # OMP escalation (CrossoverConfig.omp_widen_max): the
            # correlation widen regressed — select a mutually
            # orthogonalized completion set on the host instead.
            try:
                if A_host is None:
                    A_host = _host_csc(lp)
            except ImportError:
                A_host = False  # no scipy: escalation unavailable
            if A_host is not False:
                r_host = b_host - A_host @ xp
                elig = cm_np & ~b_np & ~widened & ~banned
                omp_sel, r_left = _omp_select(
                    A_host, r_host, b_np,
                    elig & at_lower, elig & at_upper,
                    col_norm, cfg.omp_widen_max,
                    0.5 * cfg.primal_tol * (1.0 + np.max(np.abs(b_host))),
                )
                if omp_sel.any():
                    sel_wid |= omp_sel
                    omp_fired = True
                    if _DEBUG:
                        print(f"[crossover]   omp-widen "
                              f"{int(omp_sel.sum())} "
                              f"(residual left {r_left:.2e})")
        if (not omp_fired
                and cert["primal_rel"] > cfg.primal_tol
                and cfg.widen_dual_tol > 0):
            # Widen-repair (CrossoverConfig.widen_dual_tol): degenerate
            # bound-active columns back into the basis, identified by the
            # POLISHED rc.
            rc_ab = np.abs(rc_np)
            wtol = max(cfg.widen_dual_tol, sqrt_gap_safe)
            # Signed eligibility (see the price comment in _polish).
            signed = _to_host(price).astype(np.float64) / col_norm
            can_move = ((at_lower & (signed < 0.0))
                        | (at_upper & (signed > 0.0)))
            score = np.where(can_move & cm_np, np.abs(signed), 0.0)
            smax = float(score.max())
            # rc-widen requires pricing RELEVANCE too, and a live pricing
            # signal (smax > 0), or it would bulk-admit every small-rc
            # column into a rank-deficient basis.
            degen = (~b_np) & cm_np & (
                rc_ab < wtol * (1.0 + c_np)
            ) & (smax > 0.0) & (score >= 0.02 * smax) & ~widened & ~banned
            if not degen.any():
                # Pricing-widen: ONE column per pass, the nonbasic column
                # most parallel to the residual.
                score = np.where(widened | banned, 0.0, score)
                if float(score.max()) > 0.0:
                    degen = np.zeros_like(b_np)
                    degen[int(np.argmax(score))] = True
            if degen.any() and _DEBUG:
                print(f"[crossover]   widen {int(degen.sum())}")
            sel_wid |= degen
        sel_dem = sel_dem_l | sel_dem_u
        if not (sel_dem.any() or sel_wid.any()):
            break  # failure is not a repairable one
        if _DEBUG and sel_dem.any():
            print(f"[crossover]   demote {int(sel_dem.sum())}")
        # Record the pre-action state for revert-on-regression; a demoted
        # WIDENED column was tried-and-rejected — ban it.
        prev = (basic, at_lower, at_upper, widened, fail_score,
                sel_wid.copy())
        banned = banned | (widened & sel_dem)
        widened = (widened & ~sel_dem) | sel_wid
        basic = (b_np & ~sel_dem) | sel_wid
        at_lower = (at_lower | sel_dem_l) & ~sel_wid
        at_upper = (at_upper | sel_dem_u) & ~sel_wid
        repairs += 1
    cert["repairs"] = repairs
    cert["widened"] = int(widened.sum())
    if entry_pviol[0] is not None:
        cert["entry_repair_pviol"] = entry_pviol
    extra = dict(result.extra)
    extra["crossover"] = cert
    if not cert["certified"]:
        return dataclasses.replace(result, extra=extra)
    extra.update(
        gap=cert_t[_CERT_KEYS.index("gap")], dual_objective=dobj.to_working(),
        x_lo=x_dd.lo, y=y_d.to_working(), w=w_out, z=z_out,
    )
    return SolveResult(
        x=x_dd.to_working(),
        objective=pobj.to_working(),
        status=torch.tensor(Status.OPTIMAL, dtype=torch.int32, device=x.device),
        iterations=result.iterations,
        residual_norm=primal_norm,
        extra=extra,
    )
