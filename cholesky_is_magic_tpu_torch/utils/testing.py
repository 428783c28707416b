"""LP fixtures (NumPy only): random LPs, an MPS writer, the Netlib-scale
synthetic LPs, the constructed-optimum LPs and the HiGHS oracle.

Copies of ``InequalityLP``, ``random_lp``, ``write_mps``, ``NETLIB_SCALES``,
``netlib_like_lp``, ``constructed_optimum_lp`` and
``scipy_reference_solution`` from the JAX package's ``utils/testing.py``, so
that a machine without jax builds the same instances from the same seed
(the same arrays and the same MPS text).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class InequalityLP:
    """min c'x  s.t.  A_ub x <= b_ub,  A_eq x = b_eq,  l <= x <= u."""

    c: np.ndarray
    A_ub: np.ndarray
    b_ub: np.ndarray
    A_eq: np.ndarray
    b_eq: np.ndarray
    l: np.ndarray
    u: np.ndarray


def random_lp(
    seed: int,
    n_ub: int = 6,
    n_eq: int = 2,
    n: int = 8,
    density: float = 0.6,
    bounded: bool = True,
) -> InequalityLP:
    """A random LP guaranteed feasible (a strictly interior point exists).

    Feasibility is arranged by choosing x0 inside the bounds and setting
    b_ub = A_ub x0 + margin, b_eq = A_eq x0.
    """
    rng = np.random.default_rng(seed)

    def sparse(m):
        M = rng.normal(size=(m, n)) * (rng.random(size=(m, n)) < density)
        # Guarantee no all-zero rows.
        for i in range(m):
            if not M[i].any():
                M[i, rng.integers(n)] = rng.normal() + 1.0
        return M

    l = np.where(rng.random(n) < 0.8, -rng.random(n) * 2, -math.inf)
    u = np.where(rng.random(n) < 0.8, rng.random(n) * 2 + 0.5, math.inf)
    if bounded:
        l = np.nan_to_num(l, neginf=-5.0)
        u = np.nan_to_num(u, posinf=5.0)
    lo = np.where(np.isfinite(l), l, -1.0)
    hi = np.where(np.isfinite(u), u, 1.0)
    x0 = lo + (hi - lo) * (0.25 + 0.5 * rng.random(n))

    A_ub = sparse(n_ub)
    b_ub = A_ub @ x0 + 0.1 + rng.random(n_ub)
    A_eq = sparse(n_eq)
    b_eq = A_eq @ x0
    c = rng.normal(size=n)
    return InequalityLP(c=c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq, l=l, u=u)


def write_mps(lp: InequalityLP, name: str = "RANDOM") -> str:
    """Serialize an InequalityLP to MPS text (an independent path from the
    reader, for round-trip testing)."""
    out = [f"NAME          {name}", "ROWS", " N  OBJ"]
    n_ub, n = lp.A_ub.shape
    n_eq = lp.A_eq.shape[0]
    for i in range(n_ub):
        out.append(f" L  UB{i}")
    for i in range(n_eq):
        out.append(f" E  EQ{i}")
    out.append("COLUMNS")
    for j in range(n):
        if lp.c[j] != 0.0:
            out.append(f"    X{j}  OBJ  {float(lp.c[j])!r}")
        for i in range(n_ub):
            if lp.A_ub[i, j] != 0.0:
                out.append(f"    X{j}  UB{i}  {float(lp.A_ub[i, j])!r}")
        for i in range(n_eq):
            if lp.A_eq[i, j] != 0.0:
                out.append(f"    X{j}  EQ{i}  {float(lp.A_eq[i, j])!r}")
    out.append("RHS")
    for i in range(n_ub):
        if lp.b_ub[i] != 0.0:
            out.append(f"    RHS  UB{i}  {float(lp.b_ub[i])!r}")
    for i in range(n_eq):
        if lp.b_eq[i] != 0.0:
            out.append(f"    RHS  EQ{i}  {float(lp.b_eq[i])!r}")
    out.append("BOUNDS")
    for j in range(n):
        lo, hi = lp.l[j], lp.u[j]
        if lo == -math.inf and hi == math.inf:
            out.append(f" FR BD  X{j}")
            continue
        if lo == -math.inf:
            # Reference MI quirk sets ub to 0; emit an explicit pair instead.
            out.append(f" MI BD  X{j}")
            if hi != 0.0 and hi != math.inf:
                out.append(f" UP BD  X{j}  {float(hi)!r}")
            continue
        if lo != 0.0:
            out.append(f" LO BD  X{j}  {float(lo)!r}")
        if hi != math.inf:
            out.append(f" UP BD  X{j}  {float(hi)!r}")
    out.append("ENDATA")
    return "\n".join(out) + "\n"


NETLIB_SCALES = {
    # name: (rows, cols) of the Netlib instance the synthetic LP mimics
    # (BASELINE.json configs; the real files cannot be fetched offline).
    "afiro": (27, 51),
    "adlittle": (56, 97),
    "sc205": (205, 203),
    "25fv47": (821, 1571),
    "pilot": (1441, 3652),
}


def netlib_like_lp(name: str, seed: int = 0) -> InequalityLP:
    """A synthetic LP at the named Netlib instance's scale.

    Staircase-structured constraint matrix (~6 nonzeros per row, stage
    coupling like multi-period production models), mixed equality/
    inequality rows, finite and one-sided bounds — the structural features
    the ingest and solvers must handle, at the real instance's (m, n).
    Guaranteed feasible by construction.
    """
    m, n = NETLIB_SCALES[name]
    rng = np.random.default_rng(seed)
    n_eq = m // 3
    n_ub = m - n_eq

    def staircase(rows):
        A = np.zeros((rows, n))
        width = max(6, n // max(rows, 1) + 4)
        for i in range(rows):
            start = int(i * max(n - width, 1) / max(rows, 1))
            k = rng.integers(3, width)
            cols = start + rng.choice(width, size=min(k, width), replace=False)
            cols = np.clip(cols, 0, n - 1)
            A[i, cols] = rng.normal(size=len(cols))
            if not A[i].any():
                A[i, start % n] = 1.0
        return A

    # All variables boxed: guarantees the LP is bounded regardless of c.
    l = np.where(rng.random(n) < 0.7, 0.0, -1.0 - rng.random(n))
    u = l + 1.0 + 4.0 * rng.random(n)
    x0 = l + (u - l) * (0.2 + 0.6 * rng.random(n))

    A_ub = staircase(n_ub)
    b_ub = A_ub @ x0 + 0.05 + rng.random(n_ub)
    A_eq = staircase(n_eq)
    b_eq = A_eq @ x0
    c = rng.normal(size=n)
    return InequalityLP(c=c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq, l=l, u=u)


def constructed_optimum_lp(
    name: str | None = None,
    m: int | None = None,
    seed: int = 0,
    width: int = 8,
):
    """A staircase LP whose EXACT optimal vertex is known by construction
    — published-optimum-class evidence at ANY scale, independent of any
    oracle (the real Netlib files are unreachable offline; this is the
    generalization of the Klee-Minty analytic family the VERDICT asked
    for: pick the basis and optimum first, then build (b, c) around it).

    Construction (min c'x, Ax = b, l <= x <= u):

    1. The BASIS is nonsingular and well-conditioned BY CONSTRUCTION:
       basis column i has its bottom-most nonzero in row i with a
       dominant pivot (|a_ii| in [2, 4]) and a few small entries in
       nearby rows above — so under the (row = bottom-row) permutation
       B is upper triangular with dominant diagonal.  (A random sparse
       basis, by contrast, is both occasionally singular and
       exponentially ill-conditioned in m.)
    2. Nonbasic columns are ordinary staircase columns (~6 nnz, stage
       coupling) plus an identity block (what slack insertion produces,
       standard-form.lisp:48-86).
    3. x*: nonbasic at a randomly chosen finite bound, basic strictly
       interior with margin >= 0.5 (a NONDEGENERATE vertex); b = A x*.
    4. y* ~ N(0,1); reduced costs rc_B = 0, rc_N signed by the active
       bound with |rc| >= 0.1 (STRICT complementarity); c = A'y* + rc.

    Strict complementarity + the nonsingular basis make (x*, y*) the
    UNIQUE primal-dual optimum, so solvers can be asserted against
    info["objective"] (= c'x*) and info["x"] / info["y"] exactly.

    ``name`` picks a NETLIB_SCALES entry for (m, n_struct); an explicit
    ``m`` overrides with n_struct = 2m (the at-scale staircase shape).
    Returns (StandardForm, info) with info = {x, y, z, w, objective,
    basic} (z/w the bound duals: z = max(rc, 0), w = max(-rc, 0)).
    """
    from cholesky_is_magic_tpu_torch.ingest.standard_form import StandardForm

    rng = np.random.default_rng(seed)
    if name is not None and m is None:
        m, n_struct = NETLIB_SCALES[name]
    else:
        assert m is not None, "pass name= or m="
        n_struct = 2 * m
    n = n_struct + m  # + identity block

    rows, cols, vals = [], [], []
    # Structural staircase columns.  Every K-th column is a BASIS column
    # for its bottom row (round-robin over rows so each row gets at most
    # one structural basis candidate); the rest are generic.
    basis_col_of_row = np.full(m, -1, np.int64)
    stride = max(1, n_struct // m)
    for j in range(n_struct):
        # Stage locality: columns sweep the rows like a staircase.
        center = int(j * max(m - 1, 1) / max(n_struct - 1, 1))
        is_basis = (j % stride == 0) and basis_col_of_row[center] < 0
        if is_basis:
            bottom = center
            k = int(rng.integers(1, min(width, bottom + 1) + 1))
            above = bottom - 1 - rng.choice(
                min(width, max(bottom, 1)), size=max(k - 1, 0), replace=False
            )
            above = above[above >= 0]
            rows.append(bottom)
            cols.append(j)
            vals.append(float(rng.choice([-1, 1]) * (2.0 + 2.0 * rng.random())))
            for r in above:
                rows.append(int(r))
                cols.append(j)
                vals.append(float(0.3 * rng.standard_normal()))
            basis_col_of_row[bottom] = j
        else:
            k = int(rng.integers(3, width))
            rr = np.clip(center + rng.choice(2 * width, size=k, replace=False)
                         - width, 0, m - 1)
            for r in np.unique(rr):
                rows.append(int(r))
                cols.append(j)
                vals.append(float(rng.standard_normal()))
    # Identity block: column n_struct + i covers row i (and is the basis
    # column wherever no structural one was assigned).
    for i in range(m):
        rows.append(i)
        cols.append(n_struct + i)
        vals.append(1.0)
    basic = np.where(basis_col_of_row >= 0, basis_col_of_row,
                     n_struct + np.arange(m))
    is_basic = np.zeros(n, bool)
    is_basic[basic] = True

    # Bounds + x*: nonbasic at a finite bound, basic strictly interior.
    l = np.where(rng.random(n) < 0.7, 0.0, -1.0 - rng.random(n))
    u = l + 1.0 + 4.0 * rng.random(n)
    at_upper = rng.random(n) < 0.4
    x = np.where(at_upper, u, l)
    xb = rng.standard_normal(m)
    x[basic] = xb
    l[basic] = xb - 0.5 - rng.random(m)
    u[basic] = xb + 0.5 + rng.random(m)

    import scipy.sparse as sp

    A = sp.csr_matrix(
        (np.asarray(vals), (np.asarray(rows), np.asarray(cols))), shape=(m, n)
    )
    b = A @ x

    y = rng.standard_normal(m)
    rc = np.where(at_upper, -(0.1 + rng.random(n)), 0.1 + rng.random(n))
    rc[basic] = 0.0
    c = np.asarray(A.T @ y + rc, np.float64)

    sf = StandardForm(
        nvars=n, ncons=m, c=c,
        a_rows=np.asarray(rows, np.int32),
        a_cols=np.asarray(cols, np.int32),
        a_vals=np.asarray(vals, np.float64),
        b=np.asarray(b, np.float64),
        row_type=np.zeros(m, np.int8),
        l=l, u=u, initial_vars=n_struct,
    )
    info = {
        "x": x, "y": y,
        "z": np.maximum(rc, 0.0), "w": np.maximum(-rc, 0.0),
        "objective": float(c @ x), "basic": basic,
    }
    return sf, info


def scipy_reference_solution(lp: InequalityLP):
    """Solve with scipy's HiGHS as the trusted oracle. Returns (status, fun, x)."""
    from scipy.optimize import linprog

    res = linprog(
        lp.c,
        A_ub=lp.A_ub if lp.A_ub.size else None,
        b_ub=lp.b_ub if lp.b_ub.size else None,
        A_eq=lp.A_eq if lp.A_eq.size else None,
        b_eq=lp.b_eq if lp.b_eq.size else None,
        bounds=list(zip(lp.l, lp.u)),
        method="highs",
    )
    return res.status, res.fun, res.x


# ---- ranks of a process group, for the mesh modes on the CPU -------------
#
# The counterpart of the JAX tests' 8-virtual-device CPU mesh: the mesh modes
# (parallel.lp_mesh, ``mesh=``) run SPMD over the ranks of a torch.distributed
# process group, so a test starts the ranks itself, over gloo.  The rank-side
# code lives here, in a module that imports no jax, so that a spawned rank
# never imports a test module (or jax with it).


def _rank_main(rank: int, world_size: int, store: str, results, fn, args):
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=120))
    try:
        results.put((rank, fn(*args)))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world_size: int, *args, timeout: float = 300.0) -> list:
    """``fn(*args)`` on each of ``world_size`` spawned processes that form a
    gloo process group (a file store in a fresh temporary directory);
    returns the ranks' results in rank order.  ``fn`` must be importable by
    name and its arguments and results picklable (numpy arrays, not jax
    ones).  A rank that raises fails the call with its traceback
    (``torch.multiprocessing.ProcessRaisedException``); ranks not done
    within ``timeout`` seconds are killed and the call raises
    ``TimeoutError``."""
    import os
    import queue
    import shutil
    import tempfile
    import time

    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="cim-ranks-")
    results = mp.get_context("spawn").Queue()
    ctx = mp.start_processes(
        _rank_main, args=(world_size, os.path.join(tmp, "store"), results, fn, args),
        nprocs=world_size, join=False, start_method="spawn")
    out: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while True:
            # Drain before joining: a rank whose result is still in the pipe
            # cannot exit.
            try:
                while True:
                    rank, value = results.get(timeout=0.2)
                    out[rank] = value
            except queue.Empty:
                pass
            if ctx.join(timeout=0.2) and len(out) == world_size:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{world_size - len(out)} of {world_size} ranks not done "
                    f"in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world_size)]


def _lp_from_arrays(a: dict):
    """A DeviceLP on the CPU from the numpy arrays of one (``lp_arrays``)."""
    import torch

    from cholesky_is_magic_tpu_torch.ingest.device import DeviceLP

    return DeviceLP(**{k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
                       for k, v in a.items()})


def lp_arrays(lp) -> dict:
    """A dense LP's fields as numpy arrays and ints (either package's
    DeviceLP): what a rank of :func:`run_ranks` can be sent."""
    names = ("A", "c", "b", "l", "u", "row_mask", "col_mask", "row_type")
    out = {k: np.array(getattr(lp, k)) for k in names}
    out.update(m=int(lp.m), n=int(lp.n))
    return out


def result_arrays(res) -> dict:
    """A SolveResult's x, status, iterations, objective and (where it has
    one) gap as numpy arrays."""
    out = {k: np.array(getattr(res, k)) for k in
           ("x", "status", "iterations", "objective")}
    if "gap" in res.extra:
        out["gap"] = np.array(res.extra["gap"])
    return out


def mesh_cases(runs: list) -> list:
    """Rank side of the mesh tests: for each (dp, tp, cases) of ``runs``
    make ``lp_mesh(dp, tp, "cpu")`` and run each case, a (kind, keyword
    arguments) pair, returning its numpy results (a list per run).  Kinds:
    "normal" (parallel.sharded_solve_normal), "placement"
    (parallel.shard_lp_columns), "pdas" / "pdas_dd" / "affine" (the solver
    with ``mesh=`` on a dense LP's state), "sparse" (the fully sparse
    pdas and pdas_dd with ``mesh=`` on fresh engines), "batch" (the dp
    batch: batched_pdas / batched_pdas_dd of shard_batched_pdas, the slabbed
    loop and solve_batch with ``mesh=``), "normal_ell" (the tile engine's
    solve_normal_ell with ``mesh=``, and its sharded assembly's tiles),
    "normal_batch" (batched_normal_solves with ``mesh=``)."""
    from cholesky_is_magic_tpu_torch.parallel import lp_mesh

    out = []
    for dp, tp, cases in runs:
        mesh = lp_mesh(dp, tp, device_type="cpu")
        out.append([_MESH_CASES[kind](mesh, **kw) for kind, kw in cases])
    return out


def _case_normal(mesh, A, d, g, **kw):
    import torch

    from cholesky_is_magic_tpu_torch.parallel import sharded_solve_normal

    t = lambda v: None if v is None else torch.as_tensor(v)  # noqa: E731
    rb = kw.pop("row_boost", None)
    y, ok = sharded_solve_normal(mesh, t(A), t(d), t(g), row_boost=t(rb), **kw)
    return {"y": y.numpy(), "ok": bool(ok)}


def _case_placement(mesh, lp):
    from cholesky_is_magic_tpu_torch.parallel import shard_lp_columns

    slp = shard_lp_columns(_lp_from_arrays(lp), mesh)
    return {"A": slp.A.numpy(), "lo": slp.shard.lo, "shape": slp.shape}


def _solver_case(solver):
    def run(mesh, lp, cfg):
        import importlib

        dlp = _lp_from_arrays(lp)
        if solver == "affine":
            aff = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.affine")
            res = aff.affine_scaling(aff.make_affine_state(dlp),
                                     aff.AffineConfig(**cfg), mesh=mesh)
        else:
            pdas = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas")
            dd = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas_dd")
            cfg = pdas.PDASConfig(**cfg)
            res = (pdas.pdas(pdas.make_pdas(dlp), cfg, mesh=mesh) if solver == "pdas"
                   else dd.pdas_dd(dd.make_pdas_dd(dlp), cfg, mesh=mesh))
        return result_arrays(res)

    return run


def _case_sparse(mesh, sf, block, cfg, dd_cfg):
    """make_pdas_sparse's state through pdas, and make_pdas_dd_sparse's
    through pdas_dd, each on a fresh engine, both with ``mesh``."""
    import importlib

    import torch

    pdas = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas")
    dd = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas_dd")
    kw = dict(block=block, dtype=torch.float64, device="cpu")
    st, eng = pdas.make_pdas_sparse(sf, **kw)
    r1 = pdas.pdas(st, pdas.PDASConfig(**cfg), engine=eng, mesh=mesh)
    st2, eng2 = dd.make_pdas_dd_sparse(sf, **kw)
    r2 = dd.pdas_dd(st2, pdas.PDASConfig(**dd_cfg), engine=eng2, mesh=mesh)
    return {"pdas": result_arrays(r1), "pdas_dd": result_arrays(r2)}


def _case_normal_ell(mesh, sf, block, d, g, refine_steps, dbound=0.0):
    """The tile engine's normal solve with ``mesh`` on a fresh engine of the
    LP's A, and the tiles its sharded assembly gives."""
    import torch

    eng, E, ET = _engine_and_ell(sf, block)
    d, g = torch.as_tensor(d), torch.as_tensor(g)
    y, ok = eng.solve_normal_ell(E, ET, d, g, refine_steps=refine_steps,
                                 dbound=dbound, mesh=mesh)
    tiles = eng.assemble_pairs_tp(mesh, d, torch.zeros(sf.ncons, dtype=d.dtype))
    return {"y": y.numpy(), "ok": bool(ok), "tiles": tiles.numpy()}


def _case_batch(mesh, lps, cfg, dd_cfg, sfs, slab_iters):
    """The dp batch of dense LPs: batched_pdas and batched_pdas_dd on
    shard_batched_pdas's lanes, the slabbed loop and solve_batch, all with
    the mesh; every rank returns the whole batch."""
    import importlib

    import torch

    from cholesky_is_magic_tpu_torch import api, parallel
    from cholesky_is_magic_tpu_torch.utils import lanes

    pdas = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas")
    dd = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas_dd")
    cfg, dd_cfg = pdas.PDASConfig(**cfg), pdas.PDASConfig(**dd_cfg)
    dlps = [_lp_from_arrays(a) for a in lps]
    states = parallel.stack_states([pdas.make_pdas(lp) for lp in dlps])
    r1 = parallel.batched_pdas(parallel.shard_batched_pdas(states, mesh), cfg)
    dd_states = parallel.stack_states([
        dd.make_pdas_dd(lp, warm=lanes.lane(r1, k)) for k, lp in enumerate(dlps)])
    r2 = parallel.batched_pdas_dd(parallel.shard_batched_pdas(dd_states, mesh),
                                  dd_cfg)
    slab = parallel.batched_pdas_slabbed(states, cfg, slab_iters=slab_iters,
                                         mesh=mesh)
    reports = api.solve_batch(sfs, device="cpu", dtype=torch.float64,
                              pad_multiple=16, max_iters=cfg.max_iters,
                              mesh=mesh)
    return {"pdas": result_arrays(r1), "pdas_dd": result_arrays(r2),
            "slabbed": result_arrays(slab),
            "solve_batch": [result_arrays(r.result) for r in reports]}


def _case_normal_batch(mesh, sf, block, D, G, refine_steps):
    """batched_normal_solves with ``mesh`` on an engine of the LP's A."""
    import torch

    from cholesky_is_magic_tpu_torch.parallel import batched_normal_solves

    eng, E, ET = _engine_and_ell(sf, block)
    Y, ok = batched_normal_solves(eng, E, ET, torch.as_tensor(D),
                                  torch.as_tensor(G), mesh=mesh,
                                  refine_steps=refine_steps)
    return {"Y": Y.numpy(), "ok": ok.numpy()}


def _engine_and_ell(sf, block):
    """A fresh f64 CPU tile engine of a StandardForm's A, and its ELL
    forms of A and Aᵀ."""
    import scipy.sparse as sp
    import torch

    from cholesky_is_magic_tpu_torch.ops import sparse_ops
    from cholesky_is_magic_tpu_torch.sparse.tiled import engine_for_sparse

    m, n = sf.ncons, sf.nvars
    A = sp.csc_matrix((sf.a_vals, (sf.a_rows, sf.a_cols)), shape=(m, n))
    eng = engine_for_sparse(A, block=block, dtype=torch.float64, device="cpu")
    kw = dict(dtype=torch.float64, device="cpu")
    E = sparse_ops.from_coo(sf.a_rows, sf.a_cols, sf.a_vals, (m, n), **kw)
    ET = sparse_ops.from_coo(sf.a_cols, sf.a_rows, sf.a_vals, (n, m), **kw)
    return eng, E, ET


_MESH_CASES = {
    "normal_batch": _case_normal_batch,
    "normal": _case_normal,
    "placement": _case_placement,
    "pdas": _solver_case("pdas"),
    "pdas_dd": _solver_case("pdas_dd"),
    "affine": _solver_case("affine"),
    "sparse": _case_sparse,
    "normal_ell": _case_normal_ell,
    "batch": _case_batch,
}
