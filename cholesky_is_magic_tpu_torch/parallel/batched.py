"""Batched LP solves over stacked LPs: dense, same-A sparse, and slabbed.

Counterpart of ``cholesky_is_magic_tpu/parallel/batched.py``.  The JAX
package maps its whole jitted solver over a stacked batch with
``jax.vmap``; here the solver loops are host loops, so a batch runs the
lane loops of ``solvers.pdas`` / ``solvers.pdas_dd`` / ``solvers.affine``:
every iteration is ``torch.func.vmap`` of the one-lane iteration, a lane
that has stopped is frozen, and the host reads one flag per iteration (any
lane running).  The host branches of the single solve (the dbound retry,
the Krylov gate, the entry repair, affine's repair / optimize, slack-cap
and stall retries) run both ways and select per lane, as ``lax.cond`` does
under ``jax.vmap``.  On the card in float32 the kernels run once for the
whole batch: the double-word products on stacked dense operands
(``ops.dd_cuda``), and on the sparse engine the pair-schedule assembly
(``sparse.tiled_cuda``) and the tile factor (``ops.chol_cuda``).

Dense lanes share one padded (M, N) box; the masks keep each LP's padding
inert.  Sparse lanes (:func:`stack_sparse_states`, ``engine=``) share one
constraint matrix A, and with it one tile engine: its assembly schedule
bakes A's pair weights, so only b, c, l, u and the iterates may differ (the
JAX contract at ``parallel/batched.py:62-68``, not checked there or here).

The mesh-sharded batch (``shard_batched_pdas``, ``mesh=``) is not ported
(ROADMAP.md §1, multi-device).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from cholesky_is_magic_tpu_torch.ingest.device import DeviceLP
from cholesky_is_magic_tpu_torch.solvers.affine import (
    AffineConfig,
    _affine_lanes,
)
from cholesky_is_magic_tpu_torch.solvers.pdas import PDASConfig, _pdas_lanes
from cholesky_is_magic_tpu_torch.solvers.pdas_dd import _pdas_dd_lanes
from cholesky_is_magic_tpu_torch.solvers.result import SolveResult, Status
from cholesky_is_magic_tpu_torch.utils import lanes
from cholesky_is_magic_tpu_torch.utils.precision import highest_precision

_MESH = "is not ported (ROADMAP.md §1, multi-device)"


def stack_device_lps(lps: Sequence[DeviceLP]) -> DeviceLP:
    """Stack equal-shaped padded LPs into one batched DeviceLP (each tensor
    with a leading lane axis; ``m`` and ``n`` must agree, as the JAX
    package's pytree stack requires)."""
    shapes = {tuple(lp.A.shape) for lp in lps}
    if len(shapes) != 1:
        raise ValueError(f"all LPs must share a padded shape, got {shapes}")
    return lanes.stack(lps)


def stack_states(states: Sequence):
    """Stack equal-shaped dense ``PDASState``s, ``PDASDDState``s or
    ``AffineState``s (the JAX ``jax.tree.map(jnp.stack)`` over states)."""
    return lanes.stack(states)


def stack_sparse_states(states: Sequence):
    """Stack same-pattern sparse pdas / pdas_dd states (of
    ``make_pdas_sparse`` on one A, or of one engine): every tensor, the
    ELL / block-ELL operands too, gains a leading lane axis.  The static
    fields (shapes, ELL widths, which block-ELL forms exist) must agree, as
    the JAX package asserts of the pytree structure; a mismatch raises
    ``ValueError``."""
    return lanes.stack(states)


def batched_pdas(states, config: Optional[PDASConfig] = None,
                 engine=None) -> SolveResult:
    """The pdas loop over stacked states, each lane as its own solve
    (status, count, best iterate); one SolveResult whose tensors have the
    lane axis first.  ``engine`` (the tile engine shared by every lane)
    runs a stacked sparse batch (:func:`stack_sparse_states`) through the
    fully sparse pipeline, one assembly and one panel loop per iteration
    for all lanes: every lane must share the engine's A (see the module
    docstring)."""
    return _pdas_lanes(states, config or PDASConfig(), engine)


def batched_pdas_dd(states, config: Optional[PDASConfig] = None,
                    engine=None) -> SolveResult:
    """The double-word finisher over stacked states, each lane as its own
    solve, dense or (``engine``) same-A sparse; ``config.entry_repair_tol``
    repairs each lane's entry iterate independently."""
    return _pdas_dd_lanes(states, config or PDASConfig(), engine)


def batched_affine(states, config: Optional[AffineConfig] = None
                   ) -> SolveResult:
    """Primal affine scaling over stacked dense ``AffineState``s, each lane
    as its own solve (the JAX ``jax.vmap`` of the affine loop): per lane the
    repair and the optimize step are both computed every iteration and
    selected (see ``solvers.affine``)."""
    return _affine_lanes(states, config or AffineConfig())


def batched_pdas_slabbed(states, config: Optional[PDASConfig] = None,
                         slab_iters: int = 16, mesh=None) -> SolveResult:
    """The batched pdas loop in slabs of ``slab_iters`` iterations, finished
    lanes compacted out between slabs (the JAX package's
    ``batched_pdas_slabbed``, whose docstring has the rationale and its
    measurements): a lane that stops no longer runs beside the batch's
    slowest.

    Each slab restarts the loop's carry from the lanes' iterates (the
    repair flag, the divergence counter and the best-iterate window reset),
    so the stall window counts within a slab and is clamped to
    ``slab_iters - 2`` unless it is beyond ``max_iters`` (disabled).  The
    active lanes are bucketed to the next power of two, padded by repeating
    lane 0, and gathered on the device along the lane axis; the host reads
    the statuses and counts once per slab; finished lanes' results stay on
    the device and come to the host in one copy at the end.  ``iterations``
    is each lane's sum over its slabs.  The result's tensors are on the
    host.  ``record_trace`` / ``record_iterates`` are refused; ``mesh``
    raises."""
    if mesh is not None:
        raise NotImplementedError("batched_pdas_slabbed(mesh=...) " + _MESH)
    cfg = config or PDASConfig()
    if cfg.record_trace or cfg.record_iterates:
        raise ValueError("slabbed batching does not support trace recording")
    return _slabbed(states, cfg, slab_iters)


@highest_precision
def _slabbed(states, cfg: PDASConfig, slab_iters: int) -> SolveResult:
    B = states.x.shape[0]
    device = states.x.device
    active = np.arange(B)
    cur = states
    done = []  # (original lane ids, that slab's result for them), on the device
    spent = np.zeros(B, np.int64)
    budget = cfg.max_iters
    while active.size and budget > 0:
        k = min(slab_iters, budget)
        stall = cfg.stall_exit_iters
        if stall <= cfg.max_iters:
            stall = max(2, min(stall, k - 2))
        slab_cfg = dataclasses.replace(cfg, max_iters=k, stall_exit_iters=stall)
        bucket = 1 << int(active.size - 1).bit_length()
        sel = torch.as_tensor(np.concatenate(
            [np.arange(active.size), np.zeros(bucket - active.size, np.int64)]),
            device=device)
        dev = _take(cur, sel)
        res = _pdas_lanes(dev, slab_cfg)
        # The slab's one host read: statuses and counts.
        status, its = torch.stack([res.status, res.iterations]).cpu().numpy()
        status, its = status[: active.size], its[: active.size]
        spent[active] += its
        budget -= k
        # A lane at its budget runs on; every other status is final.
        if budget <= 0:
            fin, still = np.arange(active.size), np.zeros(0, np.int64)
        else:
            fin = np.flatnonzero(status != Status.MAX_ITERS)
            still = np.flatnonzero(status == Status.MAX_ITERS)
        if fin.size:
            done.append((active[fin], _take(res, torch.as_tensor(fin, device=device))))
        if still.size == 0:
            break
        still_d = torch.as_tensor(still, device=device)
        cur = dataclasses.replace(
            _take(dev, still_d), x=res.x[still_d], y=res.extra["y"][still_d],
            w=res.extra["w"][still_d], z=res.extra["z"][still_d])
        active = active[still]

    # One copy of every finished lane to the host, then the lanes in order.
    leaves, build = lanes.flatten([part for _, part in done])
    host = build([t.cpu() for t in leaves])
    order = np.argsort(np.concatenate([ids for ids, _ in done]), kind="stable")
    flat = [lanes.flatten(part) for part in host]
    merged = flat[0][1]([torch.cat(ts)[torch.as_tensor(order)]
                         for ts in zip(*(f[0] for f in flat))])
    return dataclasses.replace(
        merged, iterations=torch.as_tensor(spent.astype(np.int32)))


def _take(obj, idx: torch.Tensor):
    """The lanes ``idx`` of a stacked object, gathered on its device."""
    leaves, build = lanes.flatten(obj)
    return build([t[idx] for t in leaves])


def shard_batched_pdas(states, mesh):
    raise NotImplementedError("shard_batched_pdas " + _MESH)


@highest_precision
def batched_normal_solves(engine, E, ET, D: torch.Tensor, G: torch.Tensor,
                          mesh=None, refine_steps: int = 1,
                          dbound: float = 0.0, krylov_steps: int = 0):
    """Same-pattern fully sparse normal solves, one per lane of the scale
    vectors: y_i solves (A·diag(D_i))(A·diag(D_i))ᵀ y_i = G_i, every lane on
    the one engine (``E`` / ``ET`` the ELL forms of its A, shared).  The
    serving primitive for scenario sweeps and re-solves: one analysis, one
    schedule, and per lane only the values; on the card one assembly
    launch and one tile-kernel launch per panel for all lanes.  Returns
    (Y, ok) with the lane axis first.  ``mesh`` raises."""
    if mesh is not None:
        raise NotImplementedError("batched_normal_solves(mesh=...) " + _MESH)

    def one(d, g):
        return engine.solve_normal_ell(
            E, ET, d, g, refine_steps=refine_steps, dbound=dbound,
            krylov_steps=krylov_steps, per_lane=True)

    return lanes.vmap(one, D, G)
