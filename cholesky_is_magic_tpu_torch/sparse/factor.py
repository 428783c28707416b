"""Blocked-sparse Cholesky driven by the symbolic FactorPlan.

Counterpart of ``cholesky_is_magic_tpu/sparse/factor.py`` (the
``cholmod_factorize`` replacement): the host analysis fixed a permutation
and the set of structurally nonzero (b, b) tiles of L; this module runs
exactly that tile schedule on the padded dense (n_pad, n_pad) square:

    for each column panel k:            (host loop, static offsets)
        L[k,k]   = chol(S[k,k])             ops.chol.cholesky
        L[i,k]   = S[i,k] · L[k,k]^-T       TRSM, only nonzero tiles
        S[i,j]  -= L[i,k] · L[j,k]ᵀ         matmul, only affected tiles

Tiles the analysis proved zero are never touched.  Each diagonal tile goes
through ``ops.chol.cholesky``: the hand-written potrf on a float32 CUDA
tensor, ``blocked_cholesky`` elsewhere (what the JAX package runs for
every tile).  The TRSM is ``chol._rsolve_lower_T`` on the CPU, operation
for operation as in the JAX package, and ``torch.linalg.solve_triangular``
on the card, chosen by the operands' device: the plain recursive TRSM
would cost hundreds of launches per tile there.  The Schur updates keep
the JAX package's order, tile pair by tile pair.  ``ok`` is read on the
host once per factorization, and only when the dbound retry is armed.

Inside a lane of a batch of dense states (``per_lane``: the lanes share
A's pattern, each assembles N from its own A under ``torch.func.vmap``) a
float32 CUDA tile goes through the tile-factor operator of ops.chol, one
batched tile-kernel launch per panel for all the lanes, and the dbound
retry and the Krylov gate are per-lane selects.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from cholesky_is_magic_tpu_torch.ops import chol, normal
from cholesky_is_magic_tpu_torch.ops import dense as dense_ops
from cholesky_is_magic_tpu_torch.ops.cuda_build import takes_kernel
from cholesky_is_magic_tpu_torch.sparse.symbolic import FactorPlan
from cholesky_is_magic_tpu_torch.utils.spans import count, span


class BlockSparseCholesky:
    """Reusable factor + solve engine for one sparsity pattern: build once
    per LP (cholmod-analyze, affine-scaling.lisp:271), call
    :meth:`solve_normal` every IPM iteration."""

    def __init__(self, plan: FactorPlan, device="cuda"):
        self.plan = plan
        self.device = torch.device(device)
        B = plan.block_mask.shape[0]
        self.n_tiles = B
        mask = plan.block_mask | np.eye(B, dtype=bool)
        self._mask = mask
        # Panel schedule: for each column panel k, the nonzero sub-diagonal
        # row tiles, and the (i, j) Schur-update pairs whose destination is
        # resident (the others contribute exact zeros: fill-path theorem).
        self.panel_rows = [
            [i for i in range(k + 1, B) if mask[i, k]] for k in range(B)
        ]
        self.updates = []
        for k in range(B):
            rows = [k] + self.panel_rows[k]
            self.updates.append([
                (i, j) for i in rows for j in rows
                if i >= j and i > k and j > k and mask[i, j]
            ])
        # Permutation gather indices (padded; padding maps to itself), and
        # the inverse that takes a solution back to the original rows.
        n_pad = plan.n_padded
        pperm = np.arange(n_pad)
        pperm[: plan.n] = plan.perm
        slot_of = np.empty(n_pad, np.int64)
        slot_of[pperm] = np.arange(n_pad)
        self.pperm = torch.as_tensor(pperm, device=self.device)
        self.slot_of = torch.as_tensor(slot_of, device=self.device)

    # ---- factorization -------------------------------------------------

    @span("normal.factorize")
    def factorize(self, N_perm: torch.Tensor, per_lane: bool = False) -> torch.Tensor:
        """L·Lᵀ of the (padded, permuted) normal matrix by the tile
        schedule; ``N_perm`` is left as it is.  ``per_lane``: a lane under
        ``torch.func.vmap`` (see the module docstring)."""
        count("normal.factorizations")
        b = self.plan.block
        S = N_perm.clone()
        L = torch.zeros_like(N_perm)
        sl = lambda t: slice(t * b, (t + 1) * b)  # noqa: E731
        on_card = S.is_cuda
        lane_kernel = per_lane and takes_kernel(S.device, S.dtype)
        for k in range(self.n_tiles):
            Lkk = S[sl(k), sl(k)].contiguous()
            if lane_kernel:
                chol.factor_tile_(Lkk, torch.zeros_like(Lkk), per_lane=True)
            else:
                Lkk = chol.cholesky(Lkk)
            L[sl(k), sl(k)] = Lkk
            cols = {}
            for i in self.panel_rows[k]:
                if on_card:
                    Lik = torch.linalg.solve_triangular(
                        Lkk.T, S[sl(i), sl(k)], upper=True, left=False)
                else:
                    Lik = chol._rsolve_lower_T(Lkk, S[sl(i), sl(k)])
                L[sl(i), sl(k)] = Lik
                cols[i] = Lik
            for i, j in self.updates[k]:
                S[sl(i), sl(j)] -= cols[i] @ cols[j].T
        return L

    @span("normal.assemble")
    def assemble_normal(
        self,
        A: torch.Tensor,
        d: torch.Tensor,
        row_boost: Optional[torch.Tensor] = None,
        tile_sparse: Optional[bool] = None,
    ) -> torch.Tensor:
        """Permuted N = P (A·D)(A·D)ᵀ Pᵀ (+ boost), padded to the plan size.

        With ``tile_sparse`` (by default on when under 60% of the lower
        tiles are nonzero, the JAX package's gate) only the structurally
        nonzero tiles of N are computed, one (b, n) x (n, b) matmul per
        tile, and mirrored, and N is put together from them and zero tiles
        by concatenation (no write into a tensor made beforehand, so that
        it runs under ``torch.func.vmap`` too); otherwise one product
        AD·ADᵀ, symmetrized."""
        n_pad = self.plan.n_padded
        m = A.shape[0]
        if m < n_pad:
            A = F.pad(A, (0, 0, 0, n_pad - m))
            if row_boost is None:
                row_boost = torch.zeros(m, dtype=A.dtype, device=A.device)
            row_boost = F.pad(row_boost, (0, n_pad - m), value=1.0)
        AD = A[self.pperm, :] * d[None, :]
        B = self.n_tiles
        b = self.plan.block
        density = self._mask.sum() / (B * (B + 1) / 2)
        if tile_sparse is None:
            tile_sparse = density < 0.6
        if tile_sparse:
            sl = lambda t: slice(t * b, (t + 1) * b)  # noqa: E731
            T = {(i, j): AD[sl(i)] @ AD[sl(j)].T
                 for i in range(B) for j in range(i + 1) if self._mask[i, j]}
            zero = AD.new_zeros((b, b))

            def tile(i, j):
                if i >= j:
                    return T.get((i, j), zero)
                return T[(j, i)].T if (j, i) in T else zero

            N = torch.cat([torch.cat([tile(i, j) for j in range(B)], dim=1)
                           for i in range(B)])
        else:
            N = AD @ AD.T
            N = 0.5 * (N + N.T)
        if row_boost is not None:
            N = N + torch.diag(row_boost[self.pperm].to(N.dtype))
        return N

    def _check(self, L: torch.Tensor) -> torch.Tensor:
        return torch.all(torch.isfinite(L)) & torch.all(torch.diagonal(L) > 0)

    def prepare_normal(
        self,
        A: torch.Tensor,
        d: torch.Tensor,
        row_boost: Optional[torch.Tensor] = None,
        refine_steps: int = 0,
        dbound: float = 0.0,
        krylov_steps: int = 0,
        krylov_gate=None,
        per_lane: bool = False,
    ):
        """Assemble and factor once; return (solve_fn, ok).  ``dbound`` > 0
        arms the singular retry: on a failed factorization, refactor once
        with dbound·max(diag N) added to the diagonal; refinement still
        runs against the unregularized, unassembled operator
        (ops.dense.operator_residual).  ``krylov_steps`` > 0: flexible PCG
        on the factor, per call when ``krylov_gate`` is given.
        ``per_lane``: a lane under ``torch.func.vmap`` (the retry computed
        always and selected where the first factorization failed)."""
        n_pad = self.plan.n_padded
        m = A.shape[0]
        N = self.assemble_normal(A, d, row_boost)

        def factor(shift):
            L = self.factorize(N if shift is None else normal.shifted(N, shift), per_lane)
            return (L,), self._check(L)

        (L,), ok = normal.factor_with_retry(factor, dbound, per_lane)
        AD = A * d[None, :] if (refine_steps or krylov_steps) else None
        rows = self.slot_of[:m]

        def raw_solve(r):
            count("normal.solves")
            with span("normal.solve"):
                rp = F.pad(r, (0, n_pad - m))[self.pperm]
                t = torch.linalg.solve_triangular(L, rp[:, None], upper=False)
                yp = torch.linalg.solve_triangular(L.T, t, upper=True)[:, 0]
                return yp[rows]

        residual, pcg = dense_ops.unassembled_operator(AD, row_boost)
        return normal.refined_solve(raw_solve, residual, ok, refine_steps, krylov_steps,
                                    krylov_gate, pcg, per_lane), ok

    def solve_normal(
        self,
        A: torch.Tensor,
        d: torch.Tensor,
        g: torch.Tensor,
        row_boost: Optional[torch.Tensor] = None,
        refine_steps: int = 0,
        dbound: float = 0.0,
        krylov_steps: int = 0,
    ):
        """Solve (A·D)(A·D)ᵀ y = g with the planned sparse factorization;
        (y, ok) in the ORIGINAL row order, a drop-in for
        ops.dense.solve_normal."""
        solve_fn, ok = self.prepare_normal(
            A, d, row_boost=row_boost, refine_steps=refine_steps,
            dbound=dbound, krylov_steps=krylov_steps,
        )
        return solve_fn(g), ok
