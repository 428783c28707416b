"""Batched LP solves: many independent LPs in one lane-batched loop.

Counterpart of the batch half of ``cholesky_is_magic_tpu/parallel``: stacked
equal-padded dense LPs and states (:func:`stack_device_lps`,
:func:`stack_states`) and same-A sparse states (:func:`stack_sparse_states`);
the batched pdas / pdas_dd loops, dense or on one shared tile engine
(:func:`batched_pdas`, :func:`batched_pdas_dd`, ``engine=``); the slabbed
loop (:func:`batched_pdas_slabbed`); batched affine scaling
(:func:`batched_affine`); and batched sparse normal solves
(:func:`batched_normal_solves`).  The mesh-sharded modes (``lp_mesh``, the
column sharding, ``shard_batched_pdas``, every ``mesh=``) are not ported:
they raise ``NotImplementedError`` naming the ROADMAP item that covers them.
"""

from cholesky_is_magic_tpu_torch.parallel.batched import (
    batched_affine,
    batched_normal_solves,
    batched_pdas,
    batched_pdas_dd,
    batched_pdas_slabbed,
    shard_batched_pdas,
    stack_device_lps,
    stack_sparse_states,
    stack_states,
)

__all__ = [
    "batched_affine",
    "batched_normal_solves",
    "batched_pdas",
    "batched_pdas_dd",
    "batched_pdas_slabbed",
    "shard_batched_pdas",
    "stack_device_lps",
    "stack_sparse_states",
    "stack_states",
]
