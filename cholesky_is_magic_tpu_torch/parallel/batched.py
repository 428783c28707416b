"""Batched LP solves over stacked, equal-padded dense LPs.

Counterpart of ``cholesky_is_magic_tpu/parallel/batched.py:31-107``.  The
JAX package maps its whole jitted solver over a stacked batch with
``jax.vmap``; here the solver loops are host loops, so a batch runs the
lane loops of ``solvers.pdas`` / ``solvers.pdas_dd``: every iteration is
``torch.func.vmap`` of the one-lane iteration, a lane that has stopped is
frozen, and the host reads one flag per iteration (any lane running).  The
dbound retry, the Krylov gate and the entry repair, host branches in the
single solve, run both ways and select per lane, as ``lax.cond`` does
under ``jax.vmap``.  On the card in float32 the double-word products run
through the batched kernels (``ops.dd_cuda``), one launch per product for
the whole batch.

Every LP of a batch shares one padded (M, N) box; the masks keep each
LP's padding inert, so the lanes are independent.
"""

from __future__ import annotations

from typing import Optional, Sequence

from cholesky_is_magic_tpu_torch.ingest.device import DeviceLP
from cholesky_is_magic_tpu_torch.solvers.pdas import PDASConfig, _pdas_lanes
from cholesky_is_magic_tpu_torch.solvers.pdas_dd import _pdas_dd_lanes
from cholesky_is_magic_tpu_torch.solvers.result import SolveResult
from cholesky_is_magic_tpu_torch.utils import lanes

_LATER = "is not ported (ROADMAP.md §1, {})"


def stack_device_lps(lps: Sequence[DeviceLP]) -> DeviceLP:
    """Stack equal-shaped padded LPs into one batched DeviceLP (each tensor
    with a leading lane axis; ``m`` and ``n`` must agree, as the JAX
    package's pytree stack requires)."""
    shapes = {tuple(lp.A.shape) for lp in lps}
    if len(shapes) != 1:
        raise ValueError(f"all LPs must share a padded shape, got {shapes}")
    return lanes.stack(lps)


def stack_states(states: Sequence):
    """Stack equal-shaped dense ``PDASState``s or ``PDASDDState``s (the JAX
    ``jax.tree.map(jnp.stack)`` over states)."""
    return lanes.stack(states)


def batched_pdas(states, config: Optional[PDASConfig] = None,
                 engine=None) -> SolveResult:
    """The pdas loop over a stacked dense PDASState, each lane as its own
    solve (status, count, best iterate); one SolveResult whose tensors
    have the lane axis first.  ``engine`` (the sparse batch) raises."""
    if engine is not None:
        raise NotImplementedError(
            "batched_pdas(engine=...) " + _LATER.format("sparse batching"))
    return _pdas_lanes(states, config or PDASConfig())


def batched_pdas_dd(states, config: Optional[PDASConfig] = None,
                    engine=None) -> SolveResult:
    """The double-word finisher over a stacked dense PDASDDState, each lane
    as its own solve; ``config.entry_repair_tol`` repairs each lane's entry
    iterate independently.  ``engine`` raises."""
    if engine is not None:
        raise NotImplementedError(
            "batched_pdas_dd(engine=...) " + _LATER.format("sparse batching"))
    return _pdas_dd_lanes(states, config or PDASConfig())


def stack_sparse_states(states):
    raise NotImplementedError("stack_sparse_states " + _LATER.format(
        "sparse batching"))


def batched_normal_solves(*args, **kwargs):
    raise NotImplementedError("batched_normal_solves " + _LATER.format(
        "sparse batching"))


def batched_affine(states, config=None):
    raise NotImplementedError("batched_affine " + _LATER.format(
        "batched_affine"))


def batched_pdas_slabbed(states, config=None, slab_iters: int = 16,
                         mesh=None):
    raise NotImplementedError("batched_pdas_slabbed " + _LATER.format(
        "batched_pdas_slabbed"))


def shard_batched_pdas(states, mesh):
    raise NotImplementedError("shard_batched_pdas " + _LATER.format(
        "multi-device"))
