"""Column-sharded normal equations: the tensor-parallel ('tp') mode.

Counterpart of ``cholesky_is_magic_tpu/parallel/sharded.py``.  For an LP
with n >> m the cost of an iteration is assembling N = (A·D)(A·D)ᵀ, O(m²n)
over an (m, n) operand.  Shard A by columns over the mesh's 'tp' axis:

    N = sum_k (A_k · D_k)(A_k · D_k)ᵀ        (one all-reduce over 'tp')

The JAX package writes this as a ``shard_map`` with ``psum('tp')`` and lets
GSPMD partition the loop's other products.  Here every rank of the 'tp'
group runs the same call on its own (m, n/tp) column block A_k (SPMD):
``psum('tp')`` is ``dist.all_reduce`` over the mesh's 'tp' group,
``lax.axis_index('tp')`` is ``mesh.get_local_rank('tp')``, and a replicated
out-spec ``P()`` is a tensor every rank computes alike.  The loop's
products on a sharded LP are explicit too (:class:`ColumnShard`): A·v is
one all-reduce of A_k·v_k, Aᵀ·y an all-gather of A_kᵀ·y, and the
double-word products all-reduce (or all-gather) their hi and lo words
separately.  The factorization of N (m x m) and the triangular solves are
replicated; the row vectors, the column vectors and the iterates stay whole
on every rank, so the solver loops around these calls run unchanged.

On the card the double-word products of a rank's block run the dd kernels
(``ops.dd``), on the CPU their plain forms.  At tp = 1 every collective is
the identity, and each function here computes what its unsharded
counterpart computes, operation for operation, except where the JAX
package's sharded form differs by construction: the normal solve refines
against the UNASSEMBLED operator (JAX ``sharded.py:126-135``), as
``ops.dense.operator_residual`` does, where ``ops.dense.prepare_normal``
by default refines against the assembled N.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from cholesky_is_magic_tpu_torch.ingest.device import DeviceLP
from cholesky_is_magic_tpu_torch.ops import dd as ddm
from cholesky_is_magic_tpu_torch.ops import dense as dense_ops
from cholesky_is_magic_tpu_torch.ops.dd import DD
from cholesky_is_magic_tpu_torch.utils.spans import host_bool, span


def check_mesh(mesh) -> None:
    """Raise ``TypeError`` unless ``mesh`` is a ('dp', 'tp') DeviceMesh
    (:func:`.mesh.lp_mesh`)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or mesh.mesh_dim_names != ("dp", "tp"):
        raise TypeError(f"mesh must be a ('dp', 'tp') DeviceMesh (lp_mesh), got {mesh!r}")


class ColumnShard:
    """This rank's column block A_k = A[:, lo:hi] of a tp-sharded A, and the
    collectives that make its products whole.  Vectors of length n (the
    column space) are whole on every rank; a product reads its slice."""

    def __init__(self, mesh, A_k: torch.Tensor, lo: int):
        self.mesh = mesh
        self.group = mesh.get_group("tp")
        self.size = dist.get_world_size(self.group)
        self.A = A_k
        self.lo, self.hi = lo, lo + A_k.shape[-1]

    @classmethod
    def of(cls, mesh, A: torch.Tensor) -> "ColumnShard":
        """This rank's block of the whole (m, n) A, a contiguous copy (A
        itself at tp = 1); n must divide by the 'tp' size."""
        size = dist.get_world_size(mesh.get_group("tp"))
        n = A.shape[-1]
        if n % size:
            raise ValueError(f"{n} columns do not divide over tp={size}")
        w = n // size
        lo = mesh.get_local_rank("tp") * w
        return cls(mesh, A[:, lo:lo + w].contiguous(), lo)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the 'tp' ranks (``psum('tp')``), in place
        on ``t``, which the caller owns."""
        t = t.contiguous()
        dist.all_reduce(t, group=self.group)
        return t

    def cat(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` concatenated in rank order (a column-sharded
        vector made whole)."""
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts)

    def mv(self, v: torch.Tensor) -> torch.Tensor:
        """A·v: one all-reduce of A_k·v_k."""
        return self.sum(self.A @ v[self.lo:self.hi])

    def rmv(self, y: torch.Tensor) -> torch.Tensor:
        """Aᵀ·y: an all-gather of A_kᵀ·y."""
        return self.cat(self.A.T @ y)

    def sum_dd(self, u: DD) -> DD:
        """A double-word partial summed over the ranks, its hi and lo words
        all-reduced separately (the JAX package's two psums)."""
        return DD(self.sum(u.hi), self.sum(u.lo))

    def mv_dd(self, x: DD) -> DD:
        """A·x in double-word on a dd x."""
        s = slice(self.lo, self.hi)
        return self.sum_dd(ddm.dd_matvec_dd(self.A, DD(x.hi[s], x.lo[s])))

    def rmv_dd(self, y: DD) -> DD:
        """Aᵀ·y in double-word on a dd y."""
        t = ddm.dd_rmatvec_dd(self.A, y)
        return DD(self.cat(t.hi), self.cat(t.lo))

    def rmv_w(self, v: torch.Tensor) -> DD:
        """Aᵀ·v in double-word on a working-precision v."""
        t = ddm.dd_rmatvec(self.A, v)
        return DD(self.cat(t.hi), self.cat(t.lo))


def _shard(mesh, A) -> ColumnShard:
    check_mesh(mesh)
    return A if isinstance(A, ColumnShard) else ColumnShard.of(mesh, A)


@dataclasses.dataclass(frozen=True)
class ShardedLP:
    """A padded dense LP with A held by columns over the mesh's 'tp' axis
    (:func:`shard_lp_columns`): each rank keeps its (M, N/tp) block in
    ``shard``; every other tensor is whole (N or M long) on every rank.
    ``A`` is the rank's block, ``shape`` the whole (M, N)."""

    shard: ColumnShard
    c: torch.Tensor  # (N,)
    b: torch.Tensor  # (M,)
    l: torch.Tensor  # (N,)
    u: torch.Tensor  # (N,)
    row_mask: torch.Tensor  # (M,) bool
    col_mask: torch.Tensor  # (N,) bool
    row_type: torch.Tensor  # (M,) int8
    m: int
    n: int

    @property
    def A(self) -> torch.Tensor:
        return self.shard.A

    @property
    def mesh(self):
        return self.shard.mesh

    @property
    def shape(self) -> tuple[int, int]:
        return self.shard.A.shape[-2], self.c.shape[-1]


def shard_lp_columns(lp: DeviceLP, mesh) -> ShardedLP:
    """The LP with A held by columns over 'tp': this rank keeps its
    contiguous (M, N/tp) block; b, c, l, u and the masks stay whole.  The
    padded column count must divide by the 'tp' size (``ValueError``)."""
    if not isinstance(lp, DeviceLP):
        raise TypeError(f"shard_lp_columns takes a DeviceLP, got {type(lp).__name__}")
    return ShardedLP(
        shard=_shard(mesh, lp.A), c=lp.c, b=lp.b, l=lp.l, u=lp.u,
        row_mask=lp.row_mask, col_mask=lp.col_mask, row_type=lp.row_type,
        m=lp.m, n=lp.n,
    )


def sharded_prepare_normal(
    mesh,
    A,
    d: torch.Tensor,
    row_boost: Optional[torch.Tensor] = None,
    refine_steps: int = 0,
    dbound: float = 0.0,
    krylov_steps: int = 0,
    krylov_gate=None,
):
    """Factor once, solve many, over 'tp': returns (solve_fn, ok).

    ``A`` is the whole (m, n) matrix (each rank takes its block) or a
    :class:`ColumnShard`; ``d`` is whole.  Each rank forms its partial Gram
    matrix (A_k D_k)(A_k D_k)ᵀ, one all-reduce assembles N, and the
    Cholesky of N (with the ``dbound`` singular retry of
    ops.dense.prepare_normal, read on the host) is replicated.  Each
    solve_fn(g) runs the replicated triangular solves plus
    ``refine_steps`` corrections whose residual g - N·y is computed in
    double-word against the unassembled operator on each rank's block
    (A_kᵀ·y, then A_k of its hi and lo words: both dd kernels on the card),
    hi and lo all-reduced separately.  ``krylov_steps`` > 0 runs flexible
    PCG with the replicated factor as the preconditioner and the N-applies
    and dd residuals sharded the same way, per call when ``krylov_gate``
    (a 0-dim bool tensor) is given (ops.krylov.gated)."""
    sh = _shard(mesh, A)
    with span("normal.assemble"):
        AD = sh.A * d[sh.lo:sh.hi][None, :]
        N = sh.sum(AD @ AD.T)
        N = 0.5 * (N + N.T)
        if row_boost is not None:
            N = N + torch.diag(row_boost.to(N.dtype))
    f = dense_ops.factorize(N)
    if dbound > 0.0 and not host_bool(f.ok):
        jitter = dbound * torch.max(torch.diagonal(N))
        eye = torch.eye(N.shape[0], dtype=N.dtype, device=N.device)
        f = dense_ops.factorize(N + jitter * eye)
    L, ok = f.L, f.ok

    def gram_dd(t: DD) -> DD:
        # AD·t for a dd t on this rank's block, summed over the ranks.
        return sh.sum_dd(ddm.dd_add(ddm.dd_matvec(AD, t.hi), ddm.dd_matvec(AD, t.lo)))

    def residual(y, g):
        u = gram_dd(ddm.dd_rmatvec(AD, y))
        if row_boost is not None:
            u = ddm.dd_add_w(u, row_boost.to(y.dtype) * y)
        return ddm.dd_add_w(ddm.dd_neg(u), g).to_working()

    def richardson_fn(g):
        y = dense_ops.chol_solve(L, g)
        for _ in range(refine_steps):
            with span("normal.refine"):
                r = residual(y, g)
            y = y + dense_ops.chol_solve(L, r)
        return torch.where(ok, y, torch.zeros_like(y))

    if krylov_steps == 0:
        return richardson_fn, ok
    from cholesky_is_magic_tpu_torch.ops import krylov

    def apply_n(p):
        q = sh.sum(AD @ (AD.T @ p))
        return q + row_boost * p if row_boost is not None else q

    def pcg_fn(g):
        def residual_dd(x: DD):
            u = gram_dd(ddm.dd_rmatvec_dd(AD, x))
            if row_boost is not None:
                u = ddm.dd_add(u, ddm.two_prod(row_boost, x.hi))
                u = ddm.dd_add_w(u, row_boost * x.lo)
            return ddm.dd_add_w(ddm.dd_neg(u), g).to_working()

        x = krylov.pcg_refine(
            precond=lambda r: dense_ops.chol_solve(L, r), apply_n=apply_n,
            residual_dd=residual_dd, b=g, iters=krylov_steps)
        return torch.where(ok, x.to_working(), torch.zeros_like(g))

    return krylov.gated(pcg_fn, richardson_fn, krylov_gate), ok


def sharded_solve_normal(
    mesh,
    A,
    d: torch.Tensor,
    g: torch.Tensor,
    row_boost: Optional[torch.Tensor] = None,
    refine_steps: int = 0,
    dbound: float = 0.0,
    krylov_steps: int = 0,
):
    """(A·diag(d))(A·diag(d))ᵀ y = g over 'tp' (see
    :func:`sharded_prepare_normal`): (y, ok), equal up to the reduction
    order of the all-reduces to ops.dense.solve_normal with the same
    refinement against the unassembled operator."""
    solve_fn, ok = sharded_prepare_normal(
        mesh, A, d, row_boost=row_boost, refine_steps=refine_steps,
        dbound=dbound, krylov_steps=krylov_steps,
    )
    return solve_fn(g), ok


def sharded_kkt_operator(
    mesh,
    A,
    row_boost: Optional[torch.Tensor] = None,
    refine_steps: int = 0,
    dbound: float = 0.0,
    krylov_steps: int = 0,
    krylov_gate=None,
):
    """KKTOperator over the tp pipeline: the column-sharded normal solve in
    the same elimination the dense and sparse backends use, so tp is a
    solver mode.  Its products are the sharded ones of
    :class:`ColumnShard` (``A`` whole, or a ColumnShard)."""
    from cholesky_is_magic_tpu_torch.kkt.newton import KKTOperator

    sh = _shard(mesh, A)

    def prepare_scaled_normal(s):
        return sharded_prepare_normal(
            mesh, sh, s, row_boost=row_boost, refine_steps=refine_steps,
            dbound=dbound, krylov_steps=krylov_steps, krylov_gate=krylov_gate,
        )

    def solve_scaled_normal(s, g):
        solve_fn, ok = prepare_scaled_normal(s)
        return solve_fn(g), ok

    return KKTOperator(
        mv=sh.mv, rmv=sh.rmv,
        solve_scaled_normal=solve_scaled_normal,
        prepare_scaled_normal=prepare_scaled_normal,
    )
