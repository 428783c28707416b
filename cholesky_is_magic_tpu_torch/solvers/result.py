"""Solver status codes and results (codes identical to the JAX package's)."""

from __future__ import annotations

import dataclasses

import torch


class Status:
    RUNNING = 0
    OPTIMAL = 1
    SINGULAR = 2  # normal-equations factorization failed
    UNBOUNDED = 3  # ratio test exceeded the unbounded threshold
    MAX_ITERS = 4
    PRECISION_FLOOR = 5  # gap stopped improving at working precision

    NAMES = {0: "running", 1: "optimal", 2: "singular", 3: "unbounded",
             4: "max_iters", 5: "precision_floor"}


@dataclasses.dataclass(frozen=True)
class SolveResult:
    x: torch.Tensor  # primal solution (padded length N)
    objective: torch.Tensor  # c'x
    status: torch.Tensor  # Status code (int32)
    iterations: torch.Tensor  # int32
    residual_norm: torch.Tensor  # ||Ax - b||
    extra: dict  # solver-specific diagnostics (duality gap, duals, ...)

    @property
    def status_name(self) -> str:
        return Status.NAMES.get(int(self.status), "?")
