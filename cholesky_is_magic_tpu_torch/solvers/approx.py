"""APPROX: accelerated parallel proximal coordinate descent, vectorized.

Counterpart of ``cholesky_is_magic_tpu/solvers/approx.py`` (reference:
approx.lisp, and alm-approx.lisp's redefinition used by the ALM drivers).
One iteration is two products with Q and Qᵀ plus elementwise prox work.

Problem representation: a sum of structured terms over variables v in
[l, u]:

- quadratic terms  1/2 (s_i (Q_i·v - q_i))^2  — rows of Q (a padded dense
  matrix or an ELL matrix with its block-ELL renderings) with rhs q and
  per-row scale s (s = 0 marks padding);
- one linear term  c_lin·v;
- optional complementarity terms  +/-(v[a]-a0)(v[b]-b0) for the self-dual
  form, gathered and scattered by index.

ESO weights nu_j = sum_i beta_i s_i^2 Q_ij^2 with beta_i = nnz(Q_i), the
0.95-damped coordinate prox step, and adaptive restart on <g, z'-z> > 0.

The JAX package runs each driver as one ``lax.while_loop``.  Here a driver
is a host loop over chunks of ``_CHUNK`` iterations: every iteration is
masked by the device boolean ``active = ~done & (i < max_iters)``, so once
the stop test holds the state stops changing, and the host reads ``done``
once per chunk.  The final iterate and the iteration count equal the
``while_loop``'s; the iterations after the stop inside the last chunk run
masked (they launch their products, and change nothing).  On the card the
whole chunks after the first replay a CUDA graph of one chunk
(``_ChunkGraph``), which computes what the eager chunk computes.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from cholesky_is_magic_tpu_torch.ingest.device import DeviceLP, SparseLP, round_up
from cholesky_is_magic_tpu_torch.ingest.standard_form import StandardForm
from cholesky_is_magic_tpu_torch.ops import bell as bell_ops
from cholesky_is_magic_tpu_torch.ops import dd as ddm
from cholesky_is_magic_tpu_torch.ops import bell_cuda, dd_cuda, sparse_ops
from cholesky_is_magic_tpu_torch.ops.sparse_ops import ELLMatrix
from cholesky_is_magic_tpu_torch.sparse import tiled_cuda
from cholesky_is_magic_tpu_torch.utils.precision import highest_precision

BIG = 1e30  # encoded infinity (see ingest.device)

# Iterations per host read of the stop test.  A sync per iteration would
# stall the card's queue 10^4-10^6 times a solve; a long chunk wastes up to
# _CHUNK - 1 masked iterations per call, which the ALM outer loop pays at
# every step.
_CHUNK = 16
# Replay the chunks of a loop on the card as a CUDA graph (_ChunkGraph).
_GRAPHS = True


def _qmv(Q, v, QB=None):
    """Q @ v for a dense tensor or an ELLMatrix; rides the block-ELL
    rendering when one exists."""
    if QB is not None:
        return bell_ops.matvec(QB, v)
    if isinstance(Q, ELLMatrix):
        return sparse_ops.matvec(Q, v)
    return Q @ v


def _qrmv(Q, y, QTB=None):
    """Qᵀ @ y for a dense tensor or an ELLMatrix; rides the block-ELL of Qᵀ
    when one exists, else the ELL scatter-add."""
    if QTB is not None:
        return bell_ops.matvec(QTB, y)
    if isinstance(Q, ELLMatrix):
        return sparse_ops.rmatvec(Q, y)
    return Q.T @ y


@dataclasses.dataclass(frozen=True)
class ApproxProblem:
    """min over l<=v<=u of  sum_i 1/2 (s_i (Q_i v - q_i))^2 + c_lin·v
    + sum_k comp_sign_k (v[comp_a_k] - comp_a0_k)(v[comp_b_k] - comp_b0_k)
    (+ constant z0)."""

    # INVARIANT: QB/QTB, when present, must be block-ELL renderings of the
    # SAME operator as Q — _qmv/_qrmv prefer them and never consult Q.  The
    # only constructor that passes them (_make_alm_subproblem_ell) checks
    # the logical shapes.
    Q: object  # (P, N) padded dense tensor, or an ELLMatrix
    QB: object  # ops.bell.BellMatrix of Q, or None
    QTB: object  # ops.bell.BellMatrix of Qᵀ, or None
    q: torch.Tensor  # (P,)
    s: torch.Tensor  # (P,) per-quad scale; 0 on padded rows
    beta: torch.Tensor  # (P,) nnz per quad row (ESO beta, tau = n)
    c_lin: torch.Tensor  # (N,)
    nu: torch.Tensor  # (N,) ESO/Lipschitz weights
    l: torch.Tensor  # (N,)
    u: torch.Tensor  # (N,)
    z0: torch.Tensor  # scalar constant added to values
    # Complementarity terms (empty when unused).
    comp_a: torch.Tensor  # (K,) int64 indices
    comp_b: torch.Tensor  # (K,) int64 indices
    comp_a0: torch.Tensor  # (K,)
    comp_b0: torch.Tensor  # (K,)
    comp_sign: torch.Tensor  # (K,) +/-1; 0 marks padding
    n_quads: int
    n_vars: int
    # The scatter order of the gradient's complementarity terms: for each
    # of comp_a and comp_b, the term positions by occurrence of their index
    # (the first occurrence of every index, then the second, ...), so that
    # no scatter sees an index twice (see _scatter_add).
    comp_a_passes: tuple = ()
    comp_b_passes: tuple = ()


def _occurrence_passes(idx: np.ndarray, device) -> tuple:
    """Positions of ``idx`` grouped by occurrence: pass r holds, in order,
    the positions k whose index idx[k] occurred r times before k."""
    idx = np.asarray(idx, np.int64)
    rank = np.zeros(len(idx), np.int64)
    seen: dict = {}
    for k, j in enumerate(idx.tolist()):
        rank[k] = seen.get(j, 0)
        seen[j] = rank[k] + 1
    return tuple(
        torch.from_numpy(np.flatnonzero(rank == r)).to(device)
        for r in range(int(rank.max()) + 1 if len(idx) else 0)
    )


def comp_fields(comp_a, comp_b, comp_a0, comp_b0, comp_sign, *, dtype,
                device) -> dict:
    """The complementarity fields of an ApproxProblem from host arrays."""
    def put(v, dt):
        return torch.from_numpy(np.ascontiguousarray(v)).to(device=device, dtype=dt)

    comp_a = np.asarray(comp_a, np.int64).reshape(-1)
    comp_b = np.asarray(comp_b, np.int64).reshape(-1)
    return dict(
        comp_a=put(comp_a, torch.int64),
        comp_b=put(comp_b, torch.int64),
        comp_a0=put(np.asarray(comp_a0, np.float64).reshape(-1), dtype),
        comp_b0=put(np.asarray(comp_b0, np.float64).reshape(-1), dtype),
        comp_sign=put(np.asarray(comp_sign, np.float64).reshape(-1), dtype),
        comp_a_passes=_occurrence_passes(comp_a, device),
        comp_b_passes=_occurrence_passes(comp_b, device),
    )


def make_alm_subproblem(lp, lam: torch.Tensor, mu) -> ApproxProblem:
    """The ALM subproblem (make-alm-subproblem, alm-approx.lisp:355-401):

        min  (c + Aᵀλ)·x + mu/2 ||Ax - b||^2 + z0,   z0 = -λ·b,

    i.e. quads = rows of A with rhs b and scale sqrt(mu), linear term
    c + Aᵀλ.  Accepts a dense padded DeviceLP or an ELL-backed SparseLP."""
    if isinstance(lp, SparseLP):
        return _make_alm_subproblem_ell(lp, lam, mu)
    A = lp.A
    dtype = A.dtype
    mu = torch.as_tensor(mu, dtype=dtype, device=A.device)
    s = torch.where(lp.row_mask, torch.sqrt(mu), 0.0).to(dtype)
    beta = torch.sum(A != 0, dim=1).to(dtype)
    c_lin = torch.where(lp.col_mask, lp.c + A.T @ lam, 0.0)
    nu = ((beta * s * s)[None, :] @ (A * A))[0].to(dtype)
    z0 = -torch.dot(lam, lp.b)
    return ApproxProblem(
        Q=A, QB=None, QTB=None, q=lp.b, s=s, beta=beta, c_lin=c_lin, nu=nu,
        l=torch.where(lp.col_mask, lp.l, 0.0),
        u=torch.where(lp.col_mask, lp.u, 0.0),
        z0=z0, n_quads=lp.m, n_vars=lp.n,
        **comp_fields((), (), (), (), (), dtype=dtype, device=A.device),
    )


def _make_alm_subproblem_ell(lp: SparseLP, lam: torch.Tensor, mu) -> ApproxProblem:
    E = lp.E
    # The (Q, QB/QTB) consistency invariant of ApproxProblem.
    if lp.EB is not None and lp.EB.shape != (lp.m, lp.n):
        raise ValueError(f"EB shape {lp.EB.shape} is not ({lp.m}, {lp.n})")
    if lp.ETB is not None and lp.ETB.shape != (lp.n, lp.m):
        raise ValueError(f"ETB shape {lp.ETB.shape} is not ({lp.n}, {lp.m})")
    dtype = E.values.dtype
    mu = torch.as_tensor(mu, dtype=dtype, device=E.values.device)
    s = torch.sqrt(mu).reshape(1).expand(lp.m).contiguous()
    beta = torch.sum(E.values != 0, dim=1).to(dtype)
    # Transpose products ride the block-ELL of Aᵀ when the pattern admits
    # one, else the ELL scatter-add.  The squared-operand product for nu
    # reuses the same layout: padded tiles/slots are zero.
    if lp.ETB is not None:
        c_lin = lp.c + bell_ops.matvec(lp.ETB, lam)
        ETB2 = dataclasses.replace(lp.ETB, blocks=lp.ETB.blocks * lp.ETB.blocks)
        nu = bell_ops.matvec(ETB2, beta * s * s)
    else:
        c_lin = lp.c + sparse_ops.rmatvec(E, lam)
        E2 = dataclasses.replace(E, values=E.values * E.values)
        nu = sparse_ops.rmatvec(E2, beta * s * s)
    z0 = -torch.dot(lam, lp.b)
    return ApproxProblem(
        Q=E, QB=lp.EB, QTB=lp.ETB, q=lp.b, s=s, beta=beta, c_lin=c_lin,
        nu=nu, l=lp.l, u=lp.u, z0=z0, n_quads=lp.m, n_vars=lp.n,
        **comp_fields((), (), (), (), (), dtype=dtype, device=E.values.device),
    )


def make_approx_selfdual(
    lp: DeviceLP,
    complementarity: bool = False,
    scale: bool = True,
    l1_penalty: float = 0.0,
    pad_multiple: int = 128,
) -> ApproxProblem:
    """The self-dual reformulation (make-approx, approx.lisp:195-299).

    Stacked variables v = (x, y, z, w) with x in [l,u], y sign-bounded by
    row type, z, w >= 0 (fixed at 0 when the matching bound is infinite).
    Quadratic terms: |A x - b| rows, |Aᵀy + z - w - c| rows, and the
    duality-gap row c·x - b·y - l·z + u·w = 0; optional complementarity
    terms z_i(x_i - l_i), w_i(u_i - x_i) and an l1 penalty linear term.
    Built on the host in NumPy, as in the JAX package (the same arithmetic,
    bit for bit), and returned padded on ``lp``'s device and dtype.
    """
    m, n = lp.m, lp.n
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    A = host(lp.A).astype(np.float64)[:m, :n]
    b = host(lp.b).astype(np.float64)[:m]
    c = host(lp.c).astype(np.float64)[:n]
    l = host(lp.l).astype(np.float64)[:n]
    u = host(lp.u).astype(np.float64)[:n]
    row_type = host(lp.row_type)[:m]

    NV = 3 * n + m  # x | y | z | w
    ix = np.arange(n)
    iy = n + np.arange(m)
    iz = n + m + np.arange(n)
    iw = n + m + n + np.arange(n)

    lo = np.full(NV, -np.inf)
    hi = np.full(NV, np.inf)
    lo[ix], hi[ix] = l, u
    # Row-type sign bounds on y (approx.lisp:263-266): '<' rows force
    # y <= 0, '>' rows force y >= 0.
    hi[iy[row_type == StandardForm.ROW_LE]] = 0.0
    lo[iy[row_type == StandardForm.ROW_GE]] = 0.0
    # z, w >= 0; fixed at 0 when the matching bound is infinite
    # (approx.lisp:216-244).
    z_active = l > -1e8
    w_active = u < 1e8
    lo[iz] = 0.0
    hi[iz] = np.where(z_active, np.inf, 0.0)
    lo[iw] = 0.0
    hi[iw] = np.where(w_active, np.inf, 0.0)

    P = m + n + 1  # primal rows, dual rows, gap row
    Q = np.zeros((P, NV))
    q = np.zeros(P)
    # Primal rows: A x - b.
    Q[:m, ix] = A
    q[:m] = b
    # Dual rows: Aᵀ y + z - w - c.
    Q[m : m + n, :][:, iy] = A.T
    Q[m + np.arange(n), iz] = np.where(z_active, 1.0, 0.0)
    Q[m + np.arange(n), iw] = np.where(w_active, -1.0, 0.0)
    q[m : m + n] = c
    # Gap row: c·x - b·y - l·z + u·w = 0.
    Q[m + n, ix] = c
    Q[m + n, iy] = -b
    Q[m + n, iz] = np.where(z_active, -l, 0.0)
    Q[m + n, iw] = np.where(w_active, u, 0.0)
    q[m + n] = 0.0

    s = np.ones(P)
    if scale:
        # v1 scale-quadratic (approx.lisp:67-71): scale = 1/||(coefs, rhs)||.
        norm = np.sqrt((Q**2).sum(axis=1) + q**2)
        s = np.where(norm > 1e-6, 1.0 / np.where(norm == 0, 1.0, norm), 1.0)
    beta = (Q != 0).sum(axis=1).astype(np.float64)
    nu = ((beta * s * s)[:, None] * Q * Q).sum(axis=0)

    # l1 penalty linear term (approx.lisp:269-287).
    c_lin = np.zeros(NV)
    if l1_penalty:
        one_sided_neg = (l == -np.inf) & (u < np.inf)
        one_sided_pos = (l > -np.inf) & (u == np.inf)
        c_lin[ix] = np.where(
            one_sided_neg, -l1_penalty, np.where(one_sided_pos, l1_penalty, 0.0)
        )
        c_lin[iz] = l1_penalty
        c_lin[iw] = l1_penalty

    # Complementarity terms z_i (x_i - l_i) and w_i (u_i - x_i)
    # (approx.lisp:85-92, 222-243): sign +1 for (x-l)z, and the flipped
    # (u-x)w becomes -(x-u)w.
    comp_a, comp_b, comp_a0, comp_b0, comp_sign = [], [], [], [], []
    if complementarity:
        for i in range(n):
            if z_active[i]:
                comp_a.append(ix[i]); comp_b.append(iz[i])  # noqa: E702
                comp_a0.append(l[i]); comp_b0.append(0.0); comp_sign.append(1.0)  # noqa: E702
            if w_active[i]:
                comp_a.append(ix[i]); comp_b.append(iw[i])  # noqa: E702
                comp_a0.append(u[i]); comp_b0.append(0.0); comp_sign.append(-1.0)  # noqa: E702

    # Pad everything to fixed shapes.
    NVp = round_up(max(NV, 1), pad_multiple)
    Pp = round_up(max(P, 1), pad_multiple)
    dtype, device = lp.A.dtype, lp.A.device

    def put(v):
        return torch.from_numpy(np.ascontiguousarray(v)).to(device=device, dtype=dtype)

    def padv(v, size, fill=0.0):
        out = np.full(size, fill)
        out[: len(v)] = v
        return put(out)

    Qp = np.zeros((Pp, NVp))
    Qp[:P, :NV] = Q
    lo = np.clip(lo, -BIG, BIG)
    hi = np.clip(hi, -BIG, BIG)
    return ApproxProblem(
        Q=put(Qp),
        QB=None,
        QTB=None,
        q=padv(q, Pp),
        s=padv(s, Pp),  # padded rows scale 0 => inert
        beta=padv(beta, Pp),
        c_lin=padv(c_lin, NVp),
        nu=padv(nu, NVp),
        l=padv(lo, NVp),
        u=padv(hi, NVp),
        z0=torch.zeros((), dtype=dtype, device=device),
        n_quads=P,
        n_vars=NV,
        **comp_fields(comp_a, comp_b, comp_a0, comp_b0, comp_sign,
                      dtype=dtype, device=device),
    )


def _scatter_add(g, idx, vals, passes):
    """g.at[idx].add(vals) of the JAX package: the terms added one after the
    other, in order.  Each pass adds the terms of one occurrence rank, whose
    indices are distinct, so no sum depends on the order of a scatter's
    atomics: the result is the same on the card, run after run, and equals
    the sequential sum of the JAX package on the CPU."""
    for pos in passes:
        g = g.index_add(0, idx[pos], vals[pos])
    return g


def _value_grad(prob: ApproxProblem, v: torch.Tensor, want_value: bool = True):
    """(value, gradient, r, cv): value_and_gradient's pass without the
    max-violation (the drivers need neither it nor, at y, the value)."""
    r = prob.s * (_qmv(prob.Q, v, prob.QB) - prob.q)
    value = 0.5 * torch.sum(r * r) + torch.dot(prob.c_lin, v) if want_value else None
    g = _qrmv(prob.Q, prob.s * r, prob.QTB) + prob.c_lin
    cv = None
    if prob.comp_a.shape[0]:
        va = v[prob.comp_a] - prob.comp_a0
        vb = v[prob.comp_b] - prob.comp_b0
        cv = prob.comp_sign * va * vb
        if want_value:
            value = value + torch.sum(cv)
        g = _scatter_add(g, prob.comp_a, prob.comp_sign * vb, prob.comp_a_passes)
        g = _scatter_add(g, prob.comp_b, prob.comp_sign * va, prob.comp_b_passes)
    return value, g, r, cv


def value_and_gradient(prob: ApproxProblem, v: torch.Tensor):
    """One pass over every term (value-&-gradient, alm-approx.lisp:177-194):
    value, gradient, and the max |term violation|.  Padded quad rows have
    s = 0 and vanish."""
    value, g, r, cv = _value_grad(prob, v)
    maxviol = (torch.max(torch.abs(r)) if r.shape[0]
               else torch.zeros((), dtype=v.dtype, device=v.device))
    if cv is not None:
        maxviol = torch.maximum(maxviol, torch.max(torch.abs(cv)))
    return value, g, maxviol


def dual_value(prob: ApproxProblem, v: torch.Tensor):
    """z0 + linear-term value (dual-value, alm-approx.lisp:139-143)."""
    return prob.z0 + torch.dot(prob.c_lin, v)


def quad_violations(prob: ApproxProblem, v: torch.Tensor):
    """Raw (unscaled) per-quad residuals Q v - q, zero on padded rows —
    `violation c x nil` as used by the ALM outer loop
    (alm-approx.lisp:507-511)."""
    return torch.where(prob.s != 0, _qmv(prob.Q, v, prob.QB) - prob.q, 0.0)


def _solve_coordinate(z, nu, theta, g, l, u):
    """0.95-damped prox step per coordinate (solve-coordinate,
    alm-approx.lisp:196-213), including the nu*theta = 0 degenerate case."""
    step = theta * nu
    best = z - 0.95 * g / torch.where(step == 0, 1.0, step)
    proxed = torch.clamp(best, l, u)
    degenerate = torch.where(g < 0, u, torch.where(g == 0, z, l))
    return torch.where(step == 0, degenerate, proxed)


def complementarity_violation(prob: ApproxProblem, v: torch.Tensor):
    """Total complementarity violation sum |sign·(v[a]-a0)(v[b]-b0)| over
    active terms (complementarity-violation, approx.lisp:154-170)."""
    if not prob.comp_a.shape[0]:
        return torch.zeros((), dtype=v.dtype, device=v.device)
    va = v[prob.comp_a] - prob.comp_a0
    vb = v[prob.comp_b] - prob.comp_b0
    return torch.sum(torch.abs(prob.comp_sign * va * vb))


def project_box(prob: ApproxProblem, v):
    return torch.clamp(v, prob.l, prob.u)


def projected_gradient_norm(prob: ApproxProblem, v, g):
    """||v - clip(v - g)||_2 (project-gradient, alm-approx.lisp:264-280)."""
    p = v - torch.clamp(v - g, prob.l, prob.u)
    return torch.linalg.norm(p)


class ApproxResult(NamedTuple):
    x: torch.Tensor
    pg: torch.Tensor  # final projected-gradient norm
    iterations: torch.Tensor
    value: torch.Tensor  # final primal value (incl. z0)
    # Iterations the chunked loop ran, the masked ones after the stop
    # included (a host int; what the loop's products were launched for).
    slots: Optional[int] = None


def _where(c, new, old):
    if isinstance(new, ddm.DD):
        return ddm.dd_where(c, new, old)
    return torch.where(c, new, old)


def _flatten(carry) -> tuple[list, list]:
    """A carry of tensors and DDs as a flat list, and its spec."""
    flat, spec = [], []
    for c in carry:
        parts = [c.hi, c.lo] if isinstance(c, ddm.DD) else [c]
        flat += parts
        spec.append(len(parts))
    return flat, spec


def _unflatten(flat, spec) -> tuple:
    out, k = [], 0
    for n in spec:
        out.append(ddm.DD(flat[k], flat[k + 1]) if n == 2 else flat[k])
        k += n
    return tuple(out)


_COUNTERS = (dd_cuda.LAUNCHES, bell_cuda.LAUNCHES, tiled_cuda.LAUNCHES)


class _ChunkGraph:
    """One chunk of masked iterations captured as a CUDA graph, replayed in
    place on its own copy of the loop state: the host queues a chunk in one
    launch instead of ~60 (f32) or ~400 (double-word) per iteration.  The
    replay runs the captured kernels on the captured addresses, so it
    computes what the eager chunk computes.  The capture launches nothing,
    so the launch counters of the hand-written kernels (``ops.dd_cuda``,
    ``ops.bell_cuda``, ``sparse.tiled_cuda``) are put back after it, and each
    replay adds the launches it holds."""

    def __init__(self, step, state: list):
        dev = state[0].device
        self.state = [t.clone() for t in state]
        before = [dict(c) for c in _COUNTERS]
        self.graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(device=dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self.graph.capture_begin()
            try:
                out = self.state
                for _ in range(_CHUNK):
                    out = step(out)
                for buf, t in zip(self.state, out):
                    buf.copy_(t)
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.launches = [{k: c[k] - v for k, v in b.items()}
                         for c, b in zip(_COUNTERS, before)]
        for c, b in zip(_COUNTERS, before):
            c.update(b)

    def replay(self) -> list:
        self.graph.replay()
        for c, held in zip(_COUNTERS, self.launches):
            for k, n in held.items():
                c[k] += n
        return self.state


def _chunked(body, carry: tuple, max_iters: int):
    """``lax.while_loop(cond, body, carry)`` with the JAX package's cond
    ``~done & (i < max_iters)``, as a host loop over chunks of ``_CHUNK``
    masked iterations.  ``body(carry, i) -> (carry', done')`` computes one
    iteration from the pre-increment count ``i``.  Returns the final carry,
    ``i`` (a 0-d int32 tensor) and the iterations run (a host int).

    On the card, once one chunk has run eagerly and two whole chunks are
    left in the budget, the loop captures a chunk as a CUDA graph
    (_ChunkGraph) and replays it for every further whole chunk; on the CPU
    every chunk runs eagerly."""
    flat, spec = _flatten(carry)
    dev = flat[0].device
    state = flat + [torch.zeros((), dtype=torch.int32, device=dev),
                    torch.zeros((), dtype=torch.bool, device=dev)]

    def step(state):
        carry, i, done = _unflatten(state[:-2], spec), state[-2], state[-1]
        active = ~done & (i < max_iters)
        new, new_done = body(carry, i)
        flat, _ = _flatten(tuple(_where(active, a, b) for a, b in zip(new, carry)))
        return flat + [i + active.to(torch.int32), torch.where(active, new_done, done)]

    graph = None
    ran = 0
    while ran < max_iters:
        # While no stop was seen, i == ran: the last chunk ends at max_iters.
        n = min(_CHUNK, max_iters - ran)
        if (_GRAPHS and graph is None and dev.type == "cuda" and ran >= _CHUNK
                and max_iters - ran >= 2 * _CHUNK):
            graph = _ChunkGraph(step, state)
        if graph is not None and n == _CHUNK:
            state = graph.replay()
        else:
            for _ in range(n):
                state = step(state)
        ran += n
        if bool(state[-1]):  # the chunk's one host read
            break
    return _unflatten(state[:-2], spec), state[-2], ran


def _theta_next(theta):
    return 0.5 * (torch.sqrt((theta * theta + 4.0) * theta * theta) - theta * theta)


def approx(
    prob: ApproxProblem,
    max_iters: int,
    x0: Optional[torch.Tensor] = None,
    accuracy=1e-5,
) -> ApproxResult:
    """The accelerated driver (approx, alm-approx.lisp:307-346):

    y = (1-theta) x + theta z;  z' = prox(z, grad f(y));  x' = y + theta(z'-z);
    theta' = (sqrt((theta^2+4)theta^2) - theta^2)/2, with adaptive restart
    when <grad f(z'), z'-z> > 0 and stop at ||projected grad|| < accuracy
    after 10 iterations.
    """
    x_init = project_box(prob, x0 if x0 is not None else torch.zeros_like(prob.c_lin))
    acc = torch.as_tensor(accuracy, dtype=x_init.dtype, device=x_init.device)
    return _approx_jit(prob, x_init, acc, max_iters)


@highest_precision
def _approx_jit(prob: ApproxProblem, x_init, accuracy, max_iters: int) -> ApproxResult:
    def body(carry, i):
        x, z, theta, _pg, _val = carry
        y = (1.0 - theta) * x + theta * z
        _, gy, _, _ = _value_grad(prob, y, want_value=False)
        zp = _solve_coordinate(z, prob.nu, theta, gy, prob.l, prob.u)
        x_new = y + theta * (zp - z)
        theta_new = _theta_next(theta)
        value, g, _, _ = _value_grad(prob, zp)
        restart = torch.dot(g, zp - z) > 0  # adaptive restart (:321-324)
        x_next = torch.where(restart, z, x_new)
        theta_next = torch.where(restart, 1.0, theta_new)
        z_next = torch.where(restart, z, zp)
        pg = projected_gradient_norm(prob, z_next, g)
        done = (i > 10) & (pg < accuracy)
        return (x_next, z_next, theta_next, pg, value + prob.z0), done

    one = torch.ones((), dtype=x_init.dtype, device=x_init.device)
    inf = torch.full((), float("inf"), dtype=x_init.dtype, device=x_init.device)
    (_x, z, _theta, pg, value), iters, ran = _chunked(
        body, (x_init, x_init, one, inf, inf), max_iters)
    return ApproxResult(x=z, pg=pg, iterations=iters, value=value, slots=ran)


# ---------------------------------------------------------------------------
# Double-word inner driver (the JAX package's _approx_dd): the f32 ALM wall
# is a precision wall — the cancellation lives in r = Ax - b and in
# g = mu·Aᵀr + c + Aᵀλ, and the iterate updates near convergence are below
# ulp(z).  This driver carries x, z and the gradient pipeline in double-word
# (ops.dd), on the dense dd kernels or the block-ELL dd products; reached via
# ALMConfig.dd_gradient.
# ---------------------------------------------------------------------------


def _dd_ops(lp):
    """(matvec_dd, rmatvec_dd) for a SparseLP (block-ELL required) or a
    dense DeviceLP (the dd A·x and Aᵀ·x kernels on f32 CUDA tensors)."""
    if isinstance(lp, SparseLP):
        if lp.EB is None or lp.ETB is None:
            raise ValueError(
                "ALMConfig.dd_gradient needs block-ELL operands (SparseLP"
                ".EB/ETB); this pattern was gated out by ops.bell.from_coo"
                " — raise max_bytes in to_sparse_lp or use the dense path."
            )
        return (lambda v: bell_ops.dd_matvec_dd(lp.EB, v),
                lambda t: bell_ops.dd_matvec_dd(lp.ETB, t))
    return (lambda v: ddm.dd_matvec_dd(lp.A, v),
            lambda t: ddm.dd_rmatvec_dd(lp.A, t))


def _approx_dd(lp, prob: ApproxProblem, lam, mu, x0, accuracy,
               max_iters: int):
    """Accelerated APPROX in double-word: same iteration as _approx_jit with
    dd iterates and an exactly-fused gradient  g = Aᵀ(mu·r + λ) + c,
    r = Ax - b.

    Returns (z: DD, pg, iterations, r_z: DD, slots) with r_z the
    double-word primal residual at z (the outer loop's violation) and slots
    the iterations the chunked loop ran.
    """
    mv, rmv = _dd_ops(lp)
    b, c = prob.q, lp.c
    l, u = prob.l, prob.u
    nu = prob.nu
    mu = torch.as_tensor(mu, dtype=l.dtype, device=l.device)
    zero = torch.zeros_like(l)

    def grad(v):
        r = ddm.dd_add_w(mv(v), -b)
        t = ddm.dd_add_w(ddm.dd_scale(r, mu), lam)
        return ddm.dd_add_w(rmv(t), c)

    def prox(z, theta, g):
        step = theta * nu
        inv = 0.95 / torch.where(step == 0, 1.0, step)
        best = ddm.dd_sub(z, ddm.dd_scale(g, inv))
        proxed = ddm.dd_clip(best, l, u)
        degenerate = ddm.dd_where(
            g.hi < 0, ddm.DD(u, zero),
            ddm.dd_where((g.hi == 0) & (g.lo == 0), z, ddm.DD(l, zero)))
        return ddm.dd_where(step == 0, degenerate, proxed)

    def body(carry, i):
        x, z, theta, _pg = carry
        y = ddm.dd_add(ddm.dd_scale(x, 1.0 - theta), ddm.dd_scale(z, theta))
        gy = grad(y)
        zp = prox(z, theta, gy)
        dz = ddm.dd_sub(zp, z)
        x_new = ddm.dd_add(y, ddm.dd_scale(dz, theta))
        theta_new = _theta_next(theta)
        g = grad(zp)
        # Restart test <g, zp - z> with the eps^2 cross terms kept.
        dot = (torch.dot(g.hi, dz.hi)
               + torch.dot(g.hi, dz.lo) + torch.dot(g.lo, dz.hi))
        restart = dot > 0
        x_next = ddm.dd_where(restart, z, x_new)
        z_next = ddm.dd_where(restart, z, zp)
        theta_next = torch.where(restart, 1.0, theta_new)
        proj = ddm.dd_sub(z_next, ddm.dd_clip(ddm.dd_sub(z_next, g), l, u))
        pg = torch.linalg.norm(proj.hi + proj.lo)
        done = (i > 10) & (pg < accuracy)
        return (x_next, z_next, theta_next, pg), done

    one = torch.ones((), dtype=l.dtype, device=l.device)
    inf = torch.full((), float("inf"), dtype=l.dtype, device=l.device)
    x0 = ddm.dd_clip(x0, l, u)
    (_x, z, _theta, pg), iters, ran = _chunked(body, (x0, x0, one, inf), max_iters)
    r_z = ddm.dd_add_w(mv(z), -b)
    return z, pg, iters, r_z, ran
