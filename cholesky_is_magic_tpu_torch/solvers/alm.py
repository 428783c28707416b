"""Augmented Lagrangian Method outer loops over the APPROX inner solver.

Counterpart of ``cholesky_is_magic_tpu/solvers/alm.py`` (reference:
alm-approx.lisp §2.10), all four outer-loop variants:

- :func:`alm`           — the production driver (alm, :539-561) over
  alm-iteration2 (adaptive mu from the violation-improvement ratio, clamped
  multipliers, :493-537), in f32/f64 or with the double-word inner driver
  (``ALMConfig.dd_gradient``);
- :func:`alm_iteration` — the v1 LANCELOT-style minor/major schedule
  (:451-491);
- :func:`aalm`          — Nesterov-extrapolated multipliers (:563-610);
- :func:`adcd`          — the experimental alternating direction variant
  (:612-656) with its staged mu escalation.

The JAX package jits each outer loop as one ``lax.while_loop``.  Here the
outer loops are host loops that read their condition (the violation and
the projected gradient) once per outer step; the inner APPROX loop reads
its stop test once per chunk of iterations (solvers.approx).  Multiplier
sign bounds come from the row types (make-alm, :427-449).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from cholesky_is_magic_tpu_torch.ingest.device import DeviceLP, SparseLP
from cholesky_is_magic_tpu_torch.ingest.standard_form import StandardForm
from cholesky_is_magic_tpu_torch.ops import dd as ddm
from cholesky_is_magic_tpu_torch.solvers.approx import (
    _approx_dd,
    _approx_jit,
    _dd_ops,
    approx,
    dual_value,
    make_alm_subproblem,
    project_box,
    quad_violations,
)
from cholesky_is_magic_tpu_torch.utils.precision import highest_precision

BIG = 1e30


@dataclasses.dataclass(frozen=True)
class ALMConfig:
    """The JAX package's ALMConfig, field for field.  Defaults follow the
    reference's f64 tolerances (1e-5/1e-6); for f32 problems use ~1e-4 for
    violation_tol/pg_tol/omega_floor, or the inner APPROX loop burns its full
    budget every outer step without converging."""

    mu0: float = 10.0  # initial penalty (make-alm :427)
    mu_max: float = 1e7  # cap (:529; v1 uses 1e6 at :485)
    violation_tol: float = 1e-5  # outer stop (:556)
    pg_tol: float = 1e-5  # outer stop (:557)
    omega_floor: float = 1e-6  # inner-accuracy floor (:505,531)
    inner_iters: int = 1_000_000  # approx budget per outer step (:503)
    max_outer: int = 10_000  # (:546)
    # Record per-outer-step (violation, mu, pg, value) into result.trace
    # (max_outer floats per series).
    record_trace: bool = False
    # Run the inner APPROX loop in double-word (dd iterates, dd gradients:
    # approx._approx_dd) — the escape from the f32 precision floor.
    # Warm-start it from a stalled f32 run, keeping the multipliers but
    # resetting mu to ~100 (the f32 phase inflates mu toward mu_max).
    dd_gradient: bool = False


@dataclasses.dataclass(frozen=True)
class ALMState:
    """alm-state (:411-419) + the multiplier clamp bounds."""

    lp: DeviceLP | SparseLP
    mu: torch.Tensor
    omega: torch.Tensor
    nu: torch.Tensor
    multipliers: torch.Tensor  # (M,)
    mult_l: torch.Tensor  # (M,) lower clamp (0 for '<=' rows)
    mult_u: torch.Tensor  # (M,) upper clamp (0 for '>=' rows)


def make_alm(
    lp,
    mu: float = 10.0,
    multipliers: Optional[torch.Tensor] = None,
) -> ALMState:
    """make-alm (:427-449): multiplier sign bounds from row types — lambda
    >= 0 on '<=' rows, <= 0 on '>=' rows, free on equalities; padded rows
    pinned at 0.  Accepts a dense DeviceLP or an ELL SparseLP."""
    dtype = lp.E.values.dtype if isinstance(lp, SparseLP) else lp.A.dtype
    rt = lp.row_type
    f64 = dict(dtype=torch.float64, device=rt.device)
    zero = torch.zeros((), **f64)
    low = torch.where(rt == StandardForm.ROW_LE, zero, torch.full((), -BIG, **f64))
    high = torch.where(rt == StandardForm.ROW_GE, zero, torch.full((), BIG, **f64))
    if not isinstance(lp, SparseLP):
        low = torch.where(lp.row_mask, low, zero)
        high = torch.where(lp.row_mask, high, zero)
    mu = torch.as_tensor(mu, dtype=dtype, device=rt.device)
    return ALMState(
        lp=lp,
        mu=mu,
        omega=1.0 / mu,
        nu=(1.0 / mu) ** 0.1,
        multipliers=(
            multipliers
            if multipliers is not None
            else torch.zeros(lp.b.shape, dtype=dtype, device=rt.device)
        ),
        mult_l=low.to(dtype),
        mult_u=high.to(dtype),
    )


class ALMResult(NamedTuple):
    x: torch.Tensor
    multipliers: torch.Tensor
    violation: torch.Tensor  # inf-norm of constraint violation
    pg: torch.Tensor  # final inner projected-gradient norm
    value: torch.Tensor  # dual value at the solution
    outer_iterations: torch.Tensor
    inner_iterations: torch.Tensor  # *approx-iterations* total (:540)
    # Per-outer-step series (violation, mu, pg, value) when
    # ALMConfig.record_trace; empty tensors otherwise.
    trace: Optional[dict] = None
    # Final penalty parameter, for a warm restart of the outer loop.
    mu: Optional[torch.Tensor] = None
    # Inner iterations the chunked loops ran, the masked ones after each
    # stop included (a host int): what the inner products were launched
    # for; equal to inner_iterations when every inner solve ran to budget.
    inner_slots: Optional[int] = None


def _update(state: ALMState, viol, viol0, has_x: bool, cfg: ALMConfig):
    """alm-iteration2's multiplier, mu, nu and omega updates."""
    viol2 = torch.linalg.norm(viol)
    # The floor must be representable in the working dtype: 1e-300
    # underflows to 0.0 in f32, and an exactly-converged subproblem
    # (viol0 = 0) would make improvement = 0/0 = NaN and poison mu.
    tiny = torch.finfo(viol0.dtype).tiny
    improvement = viol2 / torch.clamp(viol0, min=tiny)
    lam = torch.clamp(state.multipliers + state.mu * viol, state.mult_l, state.mult_u)
    one = torch.ones_like(improvement)
    growth = (torch.maximum(one, torch.minimum(2.0 * improvement, 2.0 * one))
              if has_x else one)
    mu = torch.clamp(state.mu * growth, max=cfg.mu_max)
    return dataclasses.replace(
        state,
        multipliers=lam,
        mu=mu,
        nu=mu ** -0.1,
        omega=torch.clamp(1.0 / mu, min=cfg.omega_floor),
    )


def _iteration2(state: ALMState, x, precision, has_x: bool, cfg: ALMConfig):
    """alm-iteration2 (:493-537): solve the subproblem, update clamped
    multipliers, adapt mu from the violation-improvement ratio."""
    prob = make_alm_subproblem(state.lp, state.multipliers, state.mu)
    viol0 = torch.linalg.norm(quad_violations(prob, x))
    res = _approx_jit(prob, project_box(prob, x), precision, cfg.inner_iters)
    viol = quad_violations(prob, res.x)
    value = dual_value(prob, res.x)
    return _update(state, viol, viol0, has_x, cfg), res, viol, value


def _iteration2_dd(state: ALMState, x_dd, precision, has_x: bool, cfg: ALMConfig):
    """alm-iteration2 with the double-word inner driver: the same updates,
    the violation measured from the dd residual, the iterate kept dd across
    outer steps.  Returns (state, z, pg, iterations, viol, value, slots)."""
    prob = make_alm_subproblem(state.lp, state.multipliers, state.mu)
    # ||A x - b|| at the incoming iterate, dd-measured.
    mv, _ = _dd_ops(state.lp)
    r0 = ddm.dd_add_w(mv(x_dd), -prob.q)
    viol0 = torch.linalg.norm(r0.hi + r0.lo)
    z, pg, iters, r_z, slots = _approx_dd(
        state.lp, prob, state.multipliers, state.mu, x_dd, precision,
        cfg.inner_iters,
    )
    viol = torch.where(prob.s != 0, r_z.hi + r_z.lo, 0.0)
    value = dual_value(prob, z.hi + z.lo)
    return _update(state, viol, viol0, has_x, cfg), z, pg, iters, viol, value, slots


def _scalars(like: torch.Tensor, *values):
    return [torch.full((), v, dtype=like.dtype, device=like.device) for v in values]


def alm(
    state: ALMState,
    x0: Optional[torch.Tensor] = None,
    config: Optional[ALMConfig] = None,
) -> ALMResult:
    """The driver (alm, :539-561): outer stop at inf-norm violation and
    projected gradient both below their tolerances, with the monotone
    accuracy tightening schedule."""
    cfg = config or ALMConfig()
    mult = state.multipliers
    x_init = (x0 if x0 is not None
              else torch.zeros(state.lp.c.shape[0], dtype=mult.dtype, device=mult.device))
    if cfg.dd_gradient:
        _dd_ops(state.lp)  # raise early if the operands are unsuitable
    return _alm_jit(state, x_init, cfg)


@highest_precision
def _alm_jit(state: ALMState, x_init, cfg: ALMConfig) -> ALMResult:
    dd = cfg.dd_gradient
    accuracy, v, pg, value = _scalars(x_init, *[float("inf")] * 4)
    inner = torch.zeros((), dtype=torch.int32, device=x_init.device)
    series = cfg.max_outer if cfg.record_trace else 0
    trace = [torch.full((series,), float("nan"), dtype=x_init.dtype,
                        device=x_init.device) for _ in range(4)]
    st, x = state, (ddm.dd_from(x_init) if dd else x_init)
    i = slots = 0
    # The loop's one host read per outer step: its condition.
    while i < cfg.max_outer and bool((v > cfg.violation_tol) | (pg > cfg.pg_tol)):
        precision = torch.minimum(accuracy, st.omega)
        if dd:
            st2, x2, pg, iters, viol, value, ran = _iteration2_dd(
                st, x, precision, i > 0, cfg)
        else:
            st2, res, viol, value = _iteration2(st, x, precision, i > 0, cfg)
            x2, pg, iters, ran = res.x, res.pg, res.iterations, res.slots
        v = torch.max(torch.abs(viol))
        accuracy = torch.minimum(accuracy, torch.clamp(v, min=cfg.violation_tol))
        accuracy = torch.where(v < cfg.violation_tol, cfg.violation_tol, accuracy)
        if cfg.record_trace:
            for series, val in zip(trace, (v, st.mu, pg, value)):
                series[i] = val
        st, x = st2, x2
        inner = inner + iters
        slots += ran
        i += 1
    return ALMResult(
        x=(x.hi + x.lo) if dd else x,
        multipliers=st.multipliers,
        violation=v,
        pg=pg,
        value=value,
        outer_iterations=torch.tensor(i, dtype=torch.int32, device=inner.device),
        inner_iterations=inner,
        trace=dict(zip(("violation", "mu", "pg", "value"), trace)),
        mu=st.mu,
        inner_slots=slots,
    )


def alm_iteration(state: ALMState, x, precision=None, cfg: Optional[ALMConfig] = None):
    """The v1 LANCELOT-style minor/major update (alm-iteration, :451-491):
    minor step (multipliers only, tighter nu/omega) when ||viol|| < nu,
    major step (mu *= 1.5) otherwise.  A single outer step; the branch is a
    select on the device, as ``lax.cond`` of the JAX package computes it."""
    cfg = cfg or ALMConfig()
    prob = make_alm_subproblem(state.lp, state.multipliers, state.mu)
    prec = precision if precision is not None else torch.clamp(state.omega, min=1e-5)
    res = approx(prob, cfg.inner_iters, x, prec)
    viol = quad_violations(prob, res.x)
    viol2 = torch.linalg.norm(viol)
    value = dual_value(prob, res.x)
    lam = state.multipliers + state.mu * viol
    minor = viol2 < state.nu
    mu_major = torch.clamp(1.5 * state.mu, max=1e6)
    new_state = dataclasses.replace(
        state,
        multipliers=lam,
        mu=torch.where(minor, state.mu, mu_major),
        nu=torch.where(minor, state.nu / state.mu ** 0.9, mu_major ** -0.1),
        omega=torch.where(minor, torch.clamp(state.omega / state.mu, min=1e-5),
                          torch.clamp(1.0 / mu_major, min=1e-5)),
    )
    return new_state, res.x, viol, value


def _next_extrapolation(weight):
    # next-extrapolation (:563-564).
    return 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * weight * weight))


def aalm(
    state: ALMState,
    x0: Optional[torch.Tensor] = None,
    config: Optional[ALMConfig] = None,
) -> ALMResult:
    """Accelerated ALM (aalm, :579-610): Nesterov extrapolation on the
    multiplier sequence.  Kept for parity; the reference notes it under-
    performs plain alm (:578).

    Deviation (PARITY.md), as in the JAX package: the extrapolated
    multipliers are clamped to the row-type sign bounds, exactly as
    alm-iteration2 clamps its raw update — the reference extrapolates
    unclamped, which in f32 lets wrong-signed multipliers blow the
    subproblem up to NaN."""
    cfg = config or ALMConfig()
    mult = state.multipliers
    x_init = (x0 if x0 is not None
              else torch.zeros(state.lp.c.shape, dtype=mult.dtype, device=mult.device))
    return _aalm_jit(state, x_init, cfg)


@highest_precision
def _aalm_jit(state: ALMState, x_init, cfg: ALMConfig) -> ALMResult:
    def extrapolate(weight, prev, accelerated, current):
        nxt = _next_extrapolation(weight)
        vanilla = (weight - 1.0) / nxt
        accel = weight / nxt
        return current + vanilla * (current - prev) + accel * (current - accelerated)

    def going(v, pg, val):
        return ((v > cfg.violation_tol)
                | ((pg > cfg.pg_tol) & (pg > 2e-6 * (1.0 + torch.abs(val)))))

    accuracy, v, pg, value, weight = _scalars(x_init, *[float("inf")] * 4, 1.0)
    inner = torch.zeros((), dtype=torch.int32, device=x_init.device)
    st, x, prev_mult = state, x_init, state.multipliers
    i = slots = 0
    # The loop's one host read per outer step: its condition.
    while i < cfg.max_outer and bool(going(v, pg, value)):
        prev_accel = st.multipliers
        precision = torch.minimum(accuracy, st.omega)
        st2, res, viol, value = _iteration2(st, x, precision, i > 0, cfg)
        v = torch.max(torch.abs(viol))
        accuracy = torch.minimum(accuracy, torch.clamp(v, min=1e-6))
        accuracy = torch.where(v < cfg.violation_tol, 1e-6, accuracy)
        new_mult = extrapolate(weight, prev_mult, prev_accel, st2.multipliers)
        new_mult = torch.clamp(new_mult, st2.mult_l, st2.mult_u)
        st = dataclasses.replace(st2, multipliers=new_mult)
        x, pg = res.x, res.pg
        inner = inner + res.iterations
        slots += res.slots
        prev_mult, weight = st2.multipliers, _next_extrapolation(weight)
        i += 1
    return ALMResult(
        x=x, multipliers=st.multipliers, violation=v, pg=pg, value=value,
        outer_iterations=torch.tensor(i, dtype=torch.int32, device=inner.device),
        inner_iterations=inner, mu=st.mu, inner_slots=slots,
    )


def adcd_iteration(state: ALMState, x, has_x, cfg: Optional[ALMConfig] = None):
    """The experimental alternating-direction variant (adcd-iteration,
    :612-656): short inner solves far from feasibility, staged mu
    escalation, done when pg < 1e-2 and ||viol|| < 1e-2.

    Returns (new_state, x, done, pg).  The 10000-vs-100 inner budget switch
    is a host branch on one read (a ``lax.cond`` in the JAX package)."""
    cfg = cfg or ALMConfig()
    prob = make_alm_subproblem(state.lp, state.multipliers, state.mu)
    viol_x = torch.linalg.norm(quad_violations(prob, x))
    close = bool(has_x) and bool(viol_x < 5e-2)
    x0 = project_box(prob, x)
    acc = torch.full((), 1e-2, dtype=x0.dtype, device=x0.device)
    res = _approx_jit(prob, x0, acc, 10_000 if close else 100)
    viol = quad_violations(prob, res.x)
    viol2 = torch.linalg.norm(viol)
    out_close = res.pg < 5e-2
    almost = viol2 < 5e-2
    done = (res.pg < 1e-2) & (viol2 < 1e-2)
    one, half, ten = _scalars(state.mu, 1.0, 0.5, 10.0)
    weight = torch.where(out_close, one, half) * state.mu
    lam = state.multipliers + weight * viol
    mu = torch.clamp(
        state.mu * torch.where(out_close & almost, one, torch.where(out_close, ten, one)),
        max=1e6,
    )
    new_state = dataclasses.replace(
        state,
        multipliers=lam,
        mu=mu,
        nu=mu ** -0.1,
        omega=1.0 / mu,
    )
    return new_state, res.x, done, res.pg


def adcd(
    state: ALMState,
    x0: Optional[torch.Tensor] = None,
    config: Optional[ALMConfig] = None,
) -> ALMResult:
    """Driver for the experimental alternating-direction variant: iterate
    adcd_iteration until its `done` signal (the reference's ``throw 'done``
    out of a ``catch`` block, alm-approx.lisp:637-639) or cfg.max_outer, a
    host loop over the iteration, as in the reference and the JAX package."""
    cfg = config or ALMConfig()
    mult = state.multipliers
    x = (x0 if x0 is not None
         else torch.zeros(state.lp.c.shape, dtype=mult.dtype, device=mult.device))
    has_x = False
    pg = torch.full((), float("inf"), dtype=mult.dtype, device=mult.device)
    outer = 0
    for outer in range(1, cfg.max_outer + 1):
        state, x, done, pg = adcd_iteration(state, x, has_x, cfg)
        has_x = True
        if bool(done):
            break
    prob = make_alm_subproblem(state.lp, state.multipliers, state.mu)
    viol = quad_violations(prob, x)
    return ALMResult(
        x=x, multipliers=state.multipliers,
        violation=torch.max(torch.abs(viol)),
        pg=pg,
        value=dual_value(prob, x),
        outer_iterations=torch.tensor(outer, dtype=torch.int32, device=pg.device),
        inner_iterations=torch.tensor(0, dtype=torch.int32, device=pg.device),
        mu=state.mu,
    )
