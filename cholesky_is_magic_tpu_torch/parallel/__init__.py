"""Multi-LP and multi-device modes: lane-batched LPs, the dp-sharded batch
and the column-sharded (tp) normal equations.

Counterpart of ``cholesky_is_magic_tpu/parallel``:

- **the batch**: stacked equal-padded dense LPs and states
  (:func:`stack_device_lps`, :func:`stack_states`) and same-A sparse states
  (:func:`stack_sparse_states`); the batched pdas / pdas_dd loops, dense,
  on a dense-A engine of the lanes' shared pattern, or on one shared tile
  engine (:func:`batched_pdas`, :func:`batched_pdas_dd`, ``engine=``); the
  slabbed loop (:func:`batched_pdas_slabbed`); batched affine scaling
  (:func:`batched_affine`); and batched sparse normal solves
  (:func:`batched_normal_solves`);
- **dp**: the batch's lanes split over the 'dp' axis of a
  ``torch.distributed`` ('dp', 'tp') DeviceMesh (:func:`lp_mesh`,
  :func:`shard_batched_pdas`, every batched mode's ``mesh=``), no
  communication inside a solve and one all-gather of the results;
- **tp**: one LP's A held by columns over 'tp' (:func:`shard_lp_columns`),
  each rank's partial Gram matrix summed by one all-reduce per
  factorization (:func:`sharded_solve_normal`,
  :func:`sharded_prepare_normal`, :func:`sharded_kkt_operator`, and the
  solvers' ``mesh=``).

The mesh modes are SPMD: every rank of the process group makes the same
call (NCCL on the card, gloo on the CPU).
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
from cholesky_is_magic_tpu_torch.parallel.mesh import lp_mesh
from cholesky_is_magic_tpu_torch.parallel.sharded import (
    ShardedLP,
    shard_lp_columns,
    sharded_kkt_operator,
    sharded_prepare_normal,
    sharded_solve_normal,
)

__all__ = [
    "ShardedLP",
    "batched_affine",
    "batched_normal_solves",
    "batched_pdas",
    "batched_pdas_dd",
    "batched_pdas_slabbed",
    "lp_mesh",
    "shard_batched_pdas",
    "shard_lp_columns",
    "sharded_kkt_operator",
    "sharded_prepare_normal",
    "sharded_solve_normal",
    "stack_device_lps",
    "stack_sparse_states",
    "stack_states",
]
