"""One-call front door: ``solve(problem, solver, device=...) -> SolveReport``.

Counterpart of ``cholesky_is_magic_tpu/api.py`` for every solver family:
the ``"affine"``, ``"pdas"`` and two-phase ``"pdas_dd"`` flows, on dense
padded operands or, with ``sparse=True``, on the fully sparse pipeline (ELL /
block-ELL operands and the pair-schedule tile engine): primal affine
scaling; pdas to its native 1e-4 gap; pdas then the double-word finisher
warm-started from its iterates, escalating to PCG refinement when the
finisher stops at the precision floor short of the target gap.  The
matrix-free family runs on dense padded operands: ``"alm"`` and ``"aalm"``
(the augmented Lagrangian over the APPROX inner solver, with the JAX
package's f32 tolerances) and ``"selfdual"`` (APPROX on the self-dual
reformulation).  ``presolve=True`` runs the host presolve (ingest.presolve)
first and restores the solution and duals to the original variable space.
``crossover=True`` (pdas / pdas_dd, dense and sparse, with or without
presolve) polishes the final iterate to a certified vertex
(solvers.crossover) and reports its certificate in ``summary["crossover"]``.

``solve_batch(problems)`` solves many LPs in one lane-batched pdas loop
(parallel.batched_pdas) in a common padded box; ``embed_batch`` builds that
box once for repeated solves (:class:`BatchEmbed`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import numpy as np
import torch

from cholesky_is_magic_tpu_torch.utils.spans import span


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


@dataclasses.dataclass
class BatchEmbed:
    """A device-resident embedded LP batch: build once, solve many.

    ``embed_batch(problems)`` pays the host embed (to_device_lp x B) and the
    stacked host-to-device copy once; every ``solve_batch(embed, ...)``
    skips both and goes straight to the batched solve (the serving loop:
    re-solve one fleet against new iterates or configs)."""

    sfs: list  # the StandardForms, for postsolve
    stacked_lp: Any  # stacked DeviceLP (one device tensor per field)
    pad_multiple: int
    dtype: Any


def _check_device(device, name: str) -> None:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{name}: no CUDA device; pass device='cpu' to "
                           "solve on the CPU")


@span("setup.embed")
def embed_batch(problems, *, pad_multiple: int = 64, dtype=None,
                rescale: bool = False, device="cuda") -> BatchEmbed:
    """Embed (possibly heterogeneous) LPs into one padded batch on
    ``device`` (the card unless the caller asks for ``"cpu"``): the box is
    the batch maxima rounded up to ``pad_multiple``; the operands are built
    on the host and copied up once per field (the build and copy phases of
    :func:`solve_batch`, factored out so that their cost amortizes over
    repeated solves)."""
    from cholesky_is_magic_tpu_torch.ingest.device import round_up, to_device_lp
    from cholesky_is_magic_tpu_torch.utils import lanes

    _check_device(device, "embed_batch")
    if dtype is None:
        dtype = torch.float32
    sfs = [_to_standard_form(p, rescale) for p in problems]
    if not sfs:
        return BatchEmbed([], None, pad_multiple, dtype)
    M = round_up(max(sf.ncons for sf in sfs), pad_multiple)
    N = round_up(max(sf.nvars for sf in sfs), pad_multiple)
    lps = [
        dataclasses.replace(
            to_device_lp(sf, dtype=dtype, shape=(M, N), device="cpu"),
            m=M, n=N,
        )
        for sf in sfs
    ]
    leaves, build = lanes.flatten(lanes.stack(lps))
    stacked_lp = build([t.to(device) for t in leaves])
    return BatchEmbed(sfs, stacked_lp, pad_multiple, dtype)


def solve_batch(
    problems,
    *,
    device="cuda",
    pad_multiple: int = 64,
    dtype=None,
    rescale: bool = False,
    max_iters: int = 500,
    refine_steps: int = 1,
    gap_tol=None,
    mesh=None,
    mehrotra: bool = False,
    slab_iters: int = 0,
    warm: Optional[list] = None,
    warm_push: float = 0.0,
    warm_blend: float = 0.0,
    factor_method: str = "inverse",
) -> list:
    """Solve a batch of (possibly heterogeneous) LPs as ONE lane-batched
    pdas loop (parallel.batched_pdas) and return one :class:`SolveReport`
    per problem, its ``result`` the problem's slice of the batched result.

    As the JAX package's ``solve_batch``: every problem is embedded into a
    common padded (M, N) box (the batch maxima rounded up to
    ``pad_multiple``), the masks keep the padding inert; ``warm`` (the
    report list of a previous solve_batch over the same problem list and
    box) restarts each lane from its prior (x, y, w, z), with ``warm_blend``
    and ``warm_push`` as in :func:`solve`; a warm list of another length or
    box raises ``ValueError``.  ``factor_method`` defaults to ``"inverse"``
    (blocked Cholesky and an explicit triangular inverse per iteration,
    solves as two products); ``"direct"`` is the single solve's kernel.
    ``problems`` may be a :class:`BatchEmbed` from :func:`embed_batch`:
    the host embed and the copy to the device are then skipped, and
    ``pad_multiple`` / ``dtype`` / ``rescale`` / ``device`` are the
    handle's (the explicit arguments are ignored, as in the JAX package).

    pdas only.  ``slab_iters`` > 0 runs the slabbed loop
    (parallel.batched_pdas_slabbed: lanes that stop are compacted out every
    ``slab_iters`` iterations).  ``mesh`` (a ('dp', 'tp') DeviceMesh,
    ``parallel.lp_mesh``; every rank makes the call) splits the batch's
    lanes over 'dp' (parallel.shard_batched_pdas; the problem count must
    divide by dp unless ``slab_iters`` pads the buckets) and gives every
    rank every report.  ``device`` defaults to the card; without one the
    call raises unless it asks for ``"cpu"``.  The batched result comes to
    the host in one copy per tensor."""
    from cholesky_is_magic_tpu_torch.parallel import (
        batched_pdas,
        batched_pdas_slabbed,
        shard_batched_pdas,
    )
    from cholesky_is_magic_tpu_torch.solvers.pdas import PDASConfig, make_pdas
    from cholesky_is_magic_tpu_torch.utils import lanes

    if mesh is not None:
        from cholesky_is_magic_tpu_torch.parallel.sharded import check_mesh

        check_mesh(mesh)
    if isinstance(problems, BatchEmbed):
        # Pre-embedded: pad_multiple / dtype / rescale / device are the
        # handle's.
        sfs, stacked_lp, dtype = problems.sfs, problems.stacked_lp, problems.dtype
    else:
        emb = embed_batch(problems, pad_multiple=pad_multiple, dtype=dtype,
                          rescale=rescale, device=device)
        sfs, stacked_lp = emb.sfs, emb.stacked_lp
    if not sfs:
        return []
    kw = {} if gap_tol is None else {"gap_tol": gap_tol}
    cfg = PDASConfig(max_iters=max_iters, refine_steps=refine_steps,
                     mehrotra=mehrotra, factor_method=factor_method, **kw)
    batched = lanes.vmap(lambda lp: make_pdas(lp, cfg), stacked_lp)
    if warm is not None:
        from cholesky_is_magic_tpu_torch.solvers.affine import _into_interior
        from cholesky_is_magic_tpu_torch.solvers.pdas import push_interior

        if len(warm) != len(sfs):
            raise ValueError(
                f"warm has {len(warm)} reports for {len(sfs)} problems"
            )
        dev = batched.x.device

        def stack(get):
            # Stacked on the host, one copy up.
            return torch.stack([get(r) for r in warm]).to(device=dev,
                                                          dtype=dtype)

        wx = stack(lambda r: r.result.x)
        wy = stack(lambda r: r.result.extra["y"])
        if wx.shape != batched.x.shape or wy.shape != batched.y.shape:
            raise ValueError(
                "warm reports come from a different padded box "
                f"(x {tuple(wx.shape)} vs {tuple(batched.x.shape)}, "
                f"y {tuple(wy.shape)} vs {tuple(batched.y.shape)}); re-solve "
                "cold or use the same problem list and pad_multiple"
            )
        ww = torch.clamp_min(stack(lambda r: r.result.extra["w"]), 1e-8)
        wz = torch.clamp_min(stack(lambda r: r.result.extra["z"]), 1e-8)
        lpb = batched.lp
        if warm_blend > 0.0:
            bl = warm_blend
            wx = (1 - bl) * wx + bl * batched.x
            wy = (1 - bl) * wy + bl * batched.y
            ww = torch.clamp_min((1 - bl) * ww + bl * batched.w, 1e-8)
            wz = torch.clamp_min((1 - bl) * wz + bl * batched.z, 1e-8)
        if warm_push > 0.0:
            wx = push_interior(wx, lpb.l, lpb.u, lpb.col_mask, warm_push)
        wx = _into_interior(wx, lpb.l, lpb.u, lpb.col_mask)
        batched = dataclasses.replace(batched, x=wx, y=wy, w=ww, z=wz)
    if slab_iters > 0:
        res = batched_pdas_slabbed(batched, cfg, slab_iters=slab_iters,
                                   mesh=mesh)
    else:
        if mesh is not None:
            batched = shard_batched_pdas(batched, mesh)
        res = batched_pdas(batched, cfg)
    # ONE copy per tensor to the host, not a scalar read per report.
    leaves, build = lanes.flatten(res)
    return _postsolve_batch_reports(sfs, build([t.cpu() for t in leaves]),
                                    factor_method)


def _postsolve_batch_reports(sfs, res, factor_method: str) -> list:
    """Slice a host-side batched SolveResult into per-problem SolveReports
    (summary, solution split, duals): the postsolve phase of
    :func:`solve_batch`."""
    from cholesky_is_magic_tpu_torch.ingest.standard_form import extract_solution
    from cholesky_is_magic_tpu_torch.solvers.result import Status
    from cholesky_is_magic_tpu_torch.utils import lanes

    reports = []
    for i, sf in enumerate(sfs):
        one = lanes.lane(res, i)
        status = Status.NAMES.get(int(one.status), "?")
        summary = dict(
            status=status, objective=float(one.objective),
            dual_objective=float(one.extra["dual_objective"]),
            gap=float(one.extra["gap"]), iterations=int(one.iterations),
            residual=float(one.residual_norm),
            # "inverse" trades about one digit of raw solve accuracy at a
            # high condition number of N for the batched speed (refinement
            # recovers it): named so that a regression is attributable.
            factor_method=factor_method,
            gap_bound=_feasibility_gap_bound(
                sf, one.x.numpy(), one.extra["y"].numpy(),
                float(one.extra["gap"]), float(one.objective),
            ),
        )
        solution = extract_solution(sf, one.x.numpy())
        # Row duals in the original row space (see solve()).
        solution["y"] = one.extra["y"].numpy()[: sf.ncons] * _row_scale(sf)
        solution["reduced_costs"] = (
            one.extra["z"] - one.extra["w"]).numpy()[: sf.nvars]
        reports.append(SolveReport(
            solver="pdas", status=status, objective=solution["objective"],
            summary=summary, result=one, sf=sf, solution=solution,
        ))
    return reports


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
    device="cuda",
    dtype: Optional[torch.dtype] = None,
    sparse: bool = False,
    rescale: bool = False,
    pad_multiple: int = 128,
    block: int = 128,
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
    """Solve an LP end to end with ``"affine"``, ``"pdas"``, ``"pdas_dd"``,
    ``"alm"``, ``"aalm"`` or ``"selfdual"`` on ``device`` (the card unless
    the caller asks for ``"cpu"``; without a card the call raises; default
    f32): on dense operands padded to ``pad_multiple``, or (affine, pdas,
    pdas_dd) with ``sparse=True`` on the fully sparse pipeline, whose tile
    engine uses ``block``-wide panels (no dense (m, n) operand is built).

    The options mean what they mean in the JAX package's ``api.solve``:
    ``gap_tol`` (pdas default 1e-4, pdas_dd finisher 1e-9),
    ``krylov_steps`` / ``krylov_gate_gap`` (PCG refinement; with 0 the
    pdas_dd finisher escalates to PCG by itself at the precision floor),
    ``mehrotra``, ``entry_repair_tol``, ``crossover`` (pdas / pdas_dd:
    polish the final iterate to a certified vertex, certificate in
    ``summary["crossover"]``), ``presolve`` (the host reductions
    of ingest.presolve; the report is in the original variable space, its
    summary carries ``presolve``), and ``warm`` / ``warm_push`` /
    ``warm_blend`` (pdas / pdas_dd only: restart from a previous report of
    the same LP, solved with the same ``sparse`` and ``pad_multiple``;
    pdas_dd then skips phase 1).  The affine summary has no gap, ``y`` or
    ``gap_bound``.  ``"alm"`` / ``"aalm"`` take ``max_iters`` outer steps at
    most and report ``value``, ``violation``, ``pg``, ``outer_iterations``
    and ``inner_iterations``; ``"selfdual"`` reports ``objective``, ``pg``
    and ``iterations``.
    """
    from cholesky_is_magic_tpu_torch.ingest.device import to_device_lp
    from cholesky_is_magic_tpu_torch.ingest.standard_form import extract_solution
    from cholesky_is_magic_tpu_torch.solvers.pdas import (
        PDASConfig,
        PDASState,
        make_pdas,
        make_pdas_sparse,
        pdas,
    )

    if sparse and solver not in ("affine", "pdas", "pdas_dd"):
        raise ValueError("sparse=True supports solver affine, pdas, or pdas_dd")
    if warm is not None:
        if solver not in ("pdas", "pdas_dd"):
            raise ValueError("warm starts support solver pdas or pdas_dd")
        if presolve:
            raise ValueError(
                "warm + presolve is unsupported: the reduced variable "
                "spaces of the two solves may differ"
            )
    if crossover and solver not in ("pdas", "pdas_dd"):
        raise ValueError("crossover supports solver pdas or pdas_dd")
    if solver not in ("affine", "pdas", "pdas_dd", "alm", "aalm", "selfdual"):
        raise ValueError(f"unknown solver {solver!r}")
    _check_device(device, "solve")
    if dtype is None:
        dtype = torch.float32
    sf = _to_standard_form(problem, rescale)
    psv = None
    sf_solve = sf
    if presolve:
        from cholesky_is_magic_tpu_torch.ingest.presolve import presolve as _presolve

        sf_red, psv = _presolve(sf)
        if psv.status in ("infeasible", "unbounded"):
            return SolveReport(
                solver=solver, status=psv.status, objective=float("nan"),
                summary=dict(status=psv.status, detail=psv.detail,
                             presolve=psv.report()),
                result=None, sf=sf, solution={},
            )
        if psv.status == "solved":
            solution = extract_solution(sf, psv.restore(None))
            return SolveReport(
                solver=solver, status="optimal",
                objective=solution["objective"],
                summary=dict(status="optimal", iterations=0,
                             objective=solution["standard_form_objective"],
                             presolve=psv.report()),
                result=None, sf=sf, solution=solution,
            )
        sf_solve = sf_red
    put = lambda v: torch.as_tensor(v).to(device=device, dtype=dtype)  # noqa: E731

    def _apply_crossover(res, state_lp, engine):
        # Certify against the SOLVER state's lp (post row-equilibration):
        # x/z/w are invariant under row scaling, and the returned y stays in
        # the scaled row space the duals below expect.
        from cholesky_is_magic_tpu_torch.solvers.crossover import crossover as _xo

        return _xo(res, state_lp, engine=engine)

    engine = lp = cold = None
    if not sparse:
        lp = to_device_lp(sf_solve, pad_multiple=pad_multiple, dtype=dtype,
                          device=device)
    elif solver != "affine":
        cold, engine = make_pdas_sparse(sf_solve, block=block, dtype=dtype,
                                        device=device)

    def warm_state():
        r = warm.result
        return PDASState(x=put(r.x), y=put(r.extra["y"]), w=put(r.extra["w"]),
                         z=put(r.extra["z"]), lp=None)

    def sparse_start(prior: PDASState) -> PDASState:
        """The sparse cold state restarted from ``prior``'s iterates:
        duals floored at 1e-8, the cold init blended in (``warm_blend``),
        x pushed (``warm_push``) and pulled strictly interior."""
        from cholesky_is_magic_tpu_torch.solvers.affine import _into_interior
        from cholesky_is_magic_tpu_torch.solvers.pdas import push_interior

        l, u, mask = cold.lp.l, cold.lp.u, cold.lp.col_mask
        wx, wy = prior.x, prior.y
        ww, wz = torch.clamp_min(prior.w, 1e-8), torch.clamp_min(prior.z, 1e-8)
        if warm_blend > 0.0:
            bl = warm_blend
            wx = (1 - bl) * wx + bl * cold.x
            wy = (1 - bl) * wy + bl * cold.y
            ww = torch.clamp_min((1 - bl) * ww + bl * cold.w, 1e-8)
            wz = torch.clamp_min((1 - bl) * wz + bl * cold.z, 1e-8)
        if warm_push > 0.0:
            wx = push_interior(wx, l, u, mask, warm_push)
        wx = _into_interior(wx, l, u, mask)
        return dataclasses.replace(cold, x=wx, y=wy, w=ww, z=wz)

    if solver == "affine":
        from cholesky_is_magic_tpu_torch.solvers.affine import (
            AffineConfig,
            affine_scaling,
            make_affine_state,
            make_affine_state_sparse,
        )

        cfg = AffineConfig(max_iters=max_iters, refine_steps=refine_steps,
                           record_trace=record_trace)
        if sparse:
            st, engine = make_affine_state_sparse(sf_solve, block=block,
                                                  dtype=dtype, device=device)
        else:
            st = make_affine_state(lp)
        res = affine_scaling(st, cfg, engine=engine)
        summary = dict(
            status=res.status_name, objective=float(res.objective),
            iterations=int(res.iterations), residual=float(res.residual_norm),
        )
    elif solver == "pdas":
        kw = {} if gap_tol is None else {"gap_tol": gap_tol}
        cfg = PDASConfig(
            max_iters=max_iters, refine_steps=refine_steps,
            krylov_steps=krylov_steps, krylov_gate_gap=krylov_gate_gap,
            record_trace=record_trace, mehrotra=mehrotra, **kw,
        )
        if sparse:
            st = cold if warm is None else sparse_start(warm_state())
        else:
            st = make_pdas(
                lp, cfg, warm=warm_state() if warm is not None else None,
                warm_push=warm_push, warm_blend=warm_blend,
            )
        res = pdas(st, cfg, engine=engine)
        if crossover:
            res = _apply_crossover(res, st.lp, engine)
        summary = dict(
            status=res.status_name, objective=float(res.objective),
            dual_objective=float(res.extra["dual_objective"]),
            gap=float(res.extra["gap"]), iterations=int(res.iterations),
            residual=float(res.residual_norm),
        )
    elif solver in ("alm", "aalm"):
        from cholesky_is_magic_tpu_torch.solvers.alm import (
            ALMConfig,
            aalm,
            alm,
            make_alm,
        )

        # The f32 tolerances of the JAX package (ALMConfig docstring): the
        # reference's f64 targets sit below f32 resolution, and the inner
        # APPROX loop would burn its whole budget every outer step.
        tol_kw = (
            dict(violation_tol=1e-4, pg_tol=1e-4, omega_floor=1e-4,
                 inner_iters=50_000)
            if dtype == torch.float32 else {}
        )
        driver = aalm if solver == "aalm" else alm
        res = driver(
            make_alm(lp),
            config=ALMConfig(max_outer=max_iters, record_trace=record_trace,
                             **tol_kw),
        )
        summary = dict(
            status="optimal" if float(res.violation) < 1e-4 else "max_iters",
            value=float(res.value), violation=float(res.violation),
            pg=float(res.pg), outer_iterations=int(res.outer_iterations),
            inner_iterations=int(res.inner_iterations),
        )
    elif solver == "selfdual":
        from cholesky_is_magic_tpu_torch.solvers.approx import (
            approx,
            make_approx_selfdual,
        )

        prob = make_approx_selfdual(lp, complementarity=True,
                                    pad_multiple=pad_multiple)
        res = approx(prob, 1_000_000, accuracy=1e-9)
        x = res.x.cpu().numpy()[: lp.n]
        summary = dict(
            status="optimal" if float(res.pg) < 1e-6 else "max_iters",
            objective=float(x @ lp.c.cpu().numpy()[: lp.n]),
            pg=float(res.pg), iterations=int(res.iterations),
        )
    else:
        from cholesky_is_magic_tpu_torch.ops import dd as ddm
        from cholesky_is_magic_tpu_torch.solvers.pdas_dd import (
            PDASDDState,
            make_pdas_dd,
            mu_recentered_duals,
            pdas_dd,
        )

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

        def sparse_dd_state(prior) -> PDASDDState:
            """The sparse dd finisher state from a prior result's iterates
            (phase 1's, or a warm re-solve's); the duals are mu-recentered
            unless the cold init was blended in (see make_pdas_dd)."""
            st = sparse_start(PDASState(
                x=put(prior.x), y=put(prior.extra["y"]),
                w=put(prior.extra["w"]), z=put(prior.extra["z"]), lp=None))
            w_, z_ = st.w, st.z
            if warm_blend == 0.0:
                w_, z_ = mu_recentered_duals(st.x, st.lp.l, st.lp.u, w_, z_,
                                             st.lp.col_mask)
            return PDASDDState(x=ddm.dd_from(st.x), y=ddm.dd_from(st.y),
                               w=ddm.dd_from(w_), z=ddm.dd_from(z_), lp=st.lp)

        if sparse:
            phase1 = (warm.result if warm is not None
                      else pdas(cold, cfg1, engine=engine))
            st_dd = sparse_dd_state(phase1)
            finisher = sparse_dd_state
        else:
            phase1 = (warm_state() if warm is not None
                      else pdas(make_pdas(lp), cfg1))
            st_dd = make_pdas_dd(lp, warm=phase1, warm_push=warm_push,
                                 warm_blend=(warm_blend if warm is not None
                                             else 0.0))
            finisher = lambda prior: make_pdas_dd(lp, warm=prior)  # noqa: E731
        res = pdas_dd(st_dd, cfg2, engine=engine)
        if (res.status_name == "precision_floor" and krylov_steps == 0
                and float(res.extra["gap"]) > cfg2.gap_tol):
            # Auto-escalation: Richardson refinement hit the f32 wall short
            # of the target; retry warm with PCG refinement.
            cfg2k = dataclasses.replace(cfg2, krylov_steps=8)
            res2 = pdas_dd(finisher(res), cfg2k, engine=engine)
            if float(res2.extra["gap"]) < float(res.extra["gap"]):
                res = res2
                res.extra["krylov_escalated"] = True
        if crossover:
            res = _apply_crossover(res, st_dd.lp, engine)
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

    if crossover and res.extra.get("crossover") is not None:
        cert = res.extra["crossover"]
        summary["crossover"] = {
            k: (v if isinstance(v, bool)
                else int(v) if (k.startswith("n_") or k == "repairs")
                else [float(t) for t in v] if isinstance(v, (tuple, list))
                else float(v))
            for k, v in cert.items()
        }

    x = res.x.cpu().numpy()
    if psv is not None:
        x_full = psv.restore(x)
        solution = extract_solution(sf, x_full)
        summary["presolve"] = psv.report()
        # Solver metrics are in the REDUCED space; the eliminated columns
        # contribute the constant c'x_fixed to both primal and dual
        # objectives: shift so the summary matches `solution`.
        for key in ("objective", "value", "dual_objective"):
            if key in summary:
                summary[key] += psv.obj_offset
    else:
        solution = extract_solution(sf, x)
    if solver in ("pdas", "pdas_dd"):
        # Row duals in the ORIGINAL row space (make_pdas equilibrated the
        # rows: the user-space dual is s_i * y_i); reduced costs z - w; with
        # presolve, the exact dual postsolve (Presolve.restore_duals).
        y = res.extra["y"].cpu().numpy()
        ys = y[: sf_solve.ncons] * _row_scale(sf_solve)
        rc = (res.extra["z"] - res.extra["w"]).cpu().numpy()[: sf_solve.nvars]
        if psv is not None:
            ys, rc = psv.restore_duals(sf, ys, rc, x_full=x_full)
        solution["y"], solution["reduced_costs"] = ys, rc
        # Reduced space when presolve ran, the space of the gap itself.
        summary["gap_bound"] = _feasibility_gap_bound(
            sf_solve, x, y, summary["gap"], summary["objective"],
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
