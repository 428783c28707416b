"""Batched LP solves: many independent dense LPs in one lane-batched loop.

Counterpart of the batch half of ``cholesky_is_magic_tpu/parallel``: stacked
equal-padded LPs and states (:func:`stack_device_lps`, :func:`stack_states`)
and the batched pdas / pdas_dd loops (:func:`batched_pdas`,
:func:`batched_pdas_dd`).  The mesh-sharded modes (``lp_mesh``, the column
sharding, ``shard_batched_pdas``), the sparse-engine batch, the slabbed
driver and ``batched_affine`` are not ported: their functions raise
``NotImplementedError`` naming the ROADMAP item that covers them.
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
