"""Factor once, solve many: the mechanics every normal-equations backend shares.

Each backend (ops.dense, sparse.factor.BlockSparseCholesky, the tile
engine's dense-A and fully sparse entry points, parallel.sharded) assembles
N = (A·D)(A·D)ᵀ, factors it and solves by its own triangular solves, and
computes its own refinement residuals.  Around those parts it calls

- :func:`factor_with_retry`: the CHOLMOD-dbound singular retry, which
  refactors once with :func:`jitter` added to N's diagonal;
- :func:`refined_solve`: the solve_fn(g) it returns, the raw solve refined
  by Richardson steps against a double-word residual, or by flexible PCG
  (ops.krylov), chosen per call by the Krylov gate.

Where the JAX package branches with ``lax.cond``, the port branches in
Python on a 0-dim tensor, one host read each; with ``per_lane`` (a lane of
a batched solve under ``torch.func.vmap``) it computes both branches and
selects per lane, as ``lax.cond`` does under ``jax.vmap``.
"""

from __future__ import annotations

import torch

from cholesky_is_magic_tpu_torch.ops import krylov
from cholesky_is_magic_tpu_torch.utils.spans import host_bool, span


def jitter(dbound: float, diag: torch.Tensor) -> torch.Tensor:
    """The retry's diagonal shift, dbound·max(diag N); ``diag`` holds N's
    diagonal in any shape."""
    return dbound * torch.max(diag)


def shifted(N: torch.Tensor, dbound: float) -> torch.Tensor:
    """N + dbound·max(diag N)·I, the retry's operand for a square N."""
    shift = jitter(dbound, torch.diagonal(N))
    return N + shift * torch.eye(N.shape[0], dtype=N.dtype, device=N.device)


def factor_with_retry(factor, dbound: float, per_lane: bool = False):
    """Factor with the dbound singular retry; returns (factors, ok).

    ``factor(shift)`` returns (factors, ok), ``factors`` a tuple of
    tensors: the plain factorization for ``shift`` None, the retry's for
    ``shift`` = ``dbound`` (the backend adds :func:`jitter` to N's
    diagonal its own way).  With ``dbound`` <= 0 there is one factorization
    and no host read.  Otherwise ``ok`` is read on the host once and the
    retry runs only where the first factorization failed; under
    ``per_lane`` both run and every factor is selected per lane."""
    factors, ok = factor(None)
    if dbound <= 0.0 or (not per_lane and host_bool(ok)):
        return factors, ok
    retry, ok2 = factor(dbound)
    if not per_lane:
        return retry, ok2
    return tuple(torch.where(ok, a, b) for a, b in zip(factors, retry)), ok | ok2


def refined_solve(raw_solve, residual, ok, refine_steps: int,
                  krylov_steps: int = 0, krylov_gate=None, pcg=None,
                  per_lane: bool = False):
    """The solve_fn(g) of a factor-once backend, zero where the
    factorization failed (``ok`` False).

    ``raw_solve(r)`` runs the backend's triangular solves and
    ``residual(y, g)`` computes g - N·y in double-word.  With
    ``krylov_steps`` = 0 the solve is ``raw_solve`` plus ``refine_steps``
    Richardson corrections.  With ``krylov_steps`` > 0 it is flexible PCG
    (ops.krylov.pcg_refine) preconditioned by ``raw_solve`` on ``pcg`` =
    (apply_n, residual_dd), where ``apply_n(p)`` applies N in working
    precision and ``residual_dd(g)`` returns the double-word residual of a
    dd iterate; ``krylov_gate`` (a 0-dim bool tensor) chooses PCG or
    Richardson per call (ops.krylov.gated, both and a select under
    ``per_lane``)."""

    def richardson_fn(g):
        y = raw_solve(g)
        for _ in range(refine_steps):
            with span("normal.refine"):
                r = residual(y, g)
            y = y + raw_solve(r)
        return torch.where(ok, y, torch.zeros_like(y))

    if krylov_steps == 0:
        return richardson_fn
    apply_n, residual_dd = pcg

    def pcg_fn(g):
        x = krylov.pcg_refine(precond=raw_solve, apply_n=apply_n,
                              residual_dd=residual_dd(g), b=g, iters=krylov_steps)
        y = x.to_working()
        return torch.where(ok, y, torch.zeros_like(y))

    return krylov.gated(pcg_fn, richardson_fn, krylov_gate, per_lane=per_lane)
