"""One-call front door: ``solve(problem, solver, device=...) -> SolveReport``.

Counterpart of ``cholesky_is_magic_tpu/api.py`` for the dense ``"pdas"`` and
two-phase ``"pdas_dd"`` flows: pdas to its native 1e-4 gap, then the
double-word finisher warm-started from its iterates, escalating to PCG
refinement when the finisher stops at the precision floor short of the
target gap.  The other solver families, ``sparse``, ``presolve`` and
``crossover`` are not ported and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import numpy as np
import torch


@dataclasses.dataclass
class SolveReport:
    """What :func:`solve` returns."""

    solver: str
    status: str
    objective: float  # original-sense objective (obj_sign applied)
    summary: dict  # solver-family scalar metrics
    result: Any  # raw SolveResult
    sf: Any  # the StandardForm that was solved
    solution: dict  # extract_solution(sf, result.x): x, slacks, objective


def _row_scale(sf) -> np.ndarray:
    """make_pdas's row equilibration s_i = 1 / max_j |a_ij| (1 below 1e-6)."""
    norm = np.zeros(sf.ncons)
    np.maximum.at(norm, sf.a_rows, np.abs(sf.a_vals))
    return np.where(norm < 1e-6, 1.0, 1.0 / np.where(norm == 0, 1.0, norm))


def _feasibility_gap_bound(sf, x, y, gap, pobj) -> float:
    """Feasibility-adjusted optimality bound for a pdas-family iterate,
    evaluated on the host in f64 (the JAX package's api._feasibility_gap_bound,
    whose docstring derives it): with ŷ = s·y and rd = c - Aᵀŷ,
    p* >= b'ŷ + Σ_j min(rd_j·l_j, rd_j·u_j), coordinates whose rd points at
    an infinite bound priced at the iterate, plus ||ŷ||_inf·||Ax-b||_1.
    Returned relative (denominator 1 + |pobj|), never below ``gap``."""
    x = np.asarray(x, np.float64)[: sf.nvars]
    y = np.asarray(y, np.float64)[: sf.ncons]
    yhat = y * _row_scale(sf)
    c = np.asarray(sf.c, np.float64)
    b = np.asarray(sf.b, np.float64)
    vals = np.asarray(sf.a_vals, np.float64)
    l = np.asarray(sf.l, np.float64)
    u = np.asarray(sf.u, np.float64)
    rd = c.copy()
    np.add.at(rd, sf.a_cols, -vals * yhat[sf.a_rows])
    r = -b.copy()
    np.add.at(r, sf.a_rows, vals * x[sf.a_cols])

    def _side(bnd):
        fin = np.isfinite(bnd)
        out = np.where(fin, rd * np.where(fin, bnd, 0.0), 0.0)
        inf_side = np.where((rd > 0) == (bnd > 0), np.inf, -np.inf)
        return np.where(fin, out, np.where(rd == 0.0, 0.0, inf_side))

    contrib = np.minimum(_side(l), _side(u))
    contrib = np.where(np.isfinite(contrib), contrib, rd * x)
    lagrangian = float(b @ yhat + contrib.sum())
    pobj64 = float(c @ x)
    feas = float(np.max(np.abs(yhat), initial=0.0) * np.sum(np.abs(r)))
    denom = 1.0 + abs(pobj64)
    return max((max(pobj64 - lagrangian, 0.0) + feas) / denom, float(gap))


def _to_standard_form(problem, rescale: bool):
    from cholesky_is_magic_tpu_torch.ingest.mps import MPSData, read_mps_file
    from cholesky_is_magic_tpu_torch.ingest.standard_form import (
        StandardForm,
        rescale_sf,
        to_standard_form,
    )

    if isinstance(problem, StandardForm):
        sf = problem
    elif isinstance(problem, MPSData):
        sf = to_standard_form(problem)
    elif isinstance(problem, str):
        sf = to_standard_form(read_mps_file(problem))
    else:
        raise TypeError(
            f"problem must be a path, MPSData, or StandardForm; got {type(problem)}"
        )
    if rescale:
        rescale_sf(sf)
    return sf


def solve(
    problem: Union[str, "MPSData", "StandardForm"],  # noqa: F821
    solver: str = "pdas",
    *,
    device="cpu",
    dtype: Optional[torch.dtype] = None,
    sparse: bool = False,
    rescale: bool = False,
    pad_multiple: int = 128,
    max_iters: int = 500,
    refine_steps: int = 1,
    gap_tol: Optional[float] = None,
    krylov_steps: int = 0,
    krylov_gate_gap: float = 0.0,
    record_trace: bool = False,
    presolve: bool = False,
    warm: Optional[SolveReport] = None,
    warm_push: float = 0.0,
    warm_blend: float = 0.0,
    mehrotra: bool = False,
    crossover: bool = False,
    entry_repair_tol: float = 0.0,
) -> SolveReport:
    """Solve an LP end to end with ``"pdas"`` or ``"pdas_dd"`` on dense
    padded operands on ``device`` (default f32).

    The options mean what they mean in the JAX package's ``api.solve``:
    ``gap_tol`` (pdas default 1e-4, pdas_dd finisher 1e-9),
    ``krylov_steps`` / ``krylov_gate_gap`` (PCG refinement; with 0 the
    pdas_dd finisher escalates to PCG by itself at the precision floor),
    ``mehrotra``, ``entry_repair_tol``, and ``warm`` / ``warm_push`` /
    ``warm_blend`` (restart from a previous report of the same LP, same
    ``pad_multiple``; pdas_dd then skips phase 1).
    """
    from cholesky_is_magic_tpu_torch.ingest.device import to_device_lp
    from cholesky_is_magic_tpu_torch.ingest.standard_form import extract_solution
    from cholesky_is_magic_tpu_torch.solvers.pdas import (
        PDASConfig,
        PDASState,
        make_pdas,
        pdas,
    )

    if solver not in ("pdas", "pdas_dd"):
        raise NotImplementedError(f"solver {solver!r} is not ported")
    for flag, name in ((sparse, "sparse"), (presolve, "presolve"),
                       (crossover, "crossover")):
        if flag:
            raise NotImplementedError(f"{name}=True is not ported")
    if dtype is None:
        dtype = torch.float32
    sf = _to_standard_form(problem, rescale)
    lp = to_device_lp(sf, pad_multiple=pad_multiple, dtype=dtype, device=device)

    def warm_state():
        r = warm.result
        put = lambda v: torch.as_tensor(v).to(device=device, dtype=dtype)
        return PDASState(x=put(r.x), y=put(r.extra["y"]), w=put(r.extra["w"]),
                         z=put(r.extra["z"]), lp=None)

    if solver == "pdas":
        kw = {} if gap_tol is None else {"gap_tol": gap_tol}
        cfg = PDASConfig(
            max_iters=max_iters, refine_steps=refine_steps,
            krylov_steps=krylov_steps, krylov_gate_gap=krylov_gate_gap,
            record_trace=record_trace, mehrotra=mehrotra, **kw,
        )
        st = make_pdas(
            lp, cfg, warm=warm_state() if warm is not None else None,
            warm_push=warm_push, warm_blend=warm_blend,
        )
        res = pdas(st, cfg)
        summary = dict(
            status=res.status_name, objective=float(res.objective),
            dual_objective=float(res.extra["dual_objective"]),
            gap=float(res.extra["gap"]), iterations=int(res.iterations),
            residual=float(res.residual_norm),
        )
    else:
        from cholesky_is_magic_tpu_torch.solvers.pdas_dd import make_pdas_dd, pdas_dd

        cfg1 = PDASConfig(
            max_iters=max_iters, refine_steps=max(refine_steps, 2),
            mehrotra=mehrotra,
        )
        cfg2 = PDASConfig(
            max_iters=max_iters, gap_tol=1e-9 if gap_tol is None else gap_tol,
            refine_steps=max(refine_steps, 2), krylov_steps=krylov_steps,
            krylov_gate_gap=krylov_gate_gap, record_trace=record_trace,
            mehrotra=mehrotra, entry_repair_tol=entry_repair_tol,
        )
        phase1 = (warm_state() if warm is not None
                  else pdas(make_pdas(lp), cfg1))
        st_dd = make_pdas_dd(lp, warm=phase1, warm_push=warm_push,
                             warm_blend=(warm_blend if warm is not None
                                         else 0.0))
        res = pdas_dd(st_dd, cfg2)
        if (res.status_name == "precision_floor" and krylov_steps == 0
                and float(res.extra["gap"]) > cfg2.gap_tol):
            # Auto-escalation: Richardson refinement hit the f32 wall short
            # of the target; retry warm with PCG refinement.
            cfg2k = dataclasses.replace(cfg2, krylov_steps=8)
            res2 = pdas_dd(make_pdas_dd(lp, warm=res), cfg2k)
            if float(res2.extra["gap"]) < float(res.extra["gap"]):
                res = res2
                res.extra["krylov_escalated"] = True
        summary = dict(
            status=res.status_name, objective=float(res.objective),
            dual_objective=float(res.extra["dual_objective"]),
            gap=float(res.extra["gap"]), iterations=int(res.iterations),
            phase1_iterations=(0 if warm is not None
                               else int(phase1.iterations)),
            residual=float(res.residual_norm),
        )
        if res.extra.get("krylov_escalated"):
            summary["krylov_escalated"] = True

    x = res.x.cpu().numpy()
    solution = extract_solution(sf, x)
    # Row duals in the ORIGINAL row space (make_pdas equilibrated the rows:
    # the user-space dual is s_i * y_i); reduced costs z - w.
    y = res.extra["y"].cpu().numpy()
    solution["y"] = y[: sf.ncons] * _row_scale(sf)
    solution["reduced_costs"] = (
        (res.extra["z"] - res.extra["w"]).cpu().numpy()[: sf.nvars]
    )
    summary["gap_bound"] = _feasibility_gap_bound(
        sf, x, y, summary["gap"], summary["objective"],
    )
    return SolveReport(
        solver=solver,
        status=summary["status"],
        objective=solution["objective"],
        summary=summary,
        result=res,
        sf=sf,
        solution=solution,
    )
