"""Sparse Cholesky: host symbolic analysis + the tile engine on the device.

Counterpart of ``cholesky_is_magic_tpu/sparse``:

- :mod:`.symbolic` and :mod:`.native` are copies of the JAX package's host
  modules (NumPy/SciPy, and the ctypes bridge to ``native/symbolic.cpp``,
  built by ``make -C native`` at first use): ordering, elimination tree,
  supernodes and the static tile plan (:class:`FactorPlan`);
- :mod:`.tiled` is the panel-wave tile engine (:class:`.tiled.TiledCholesky`)
  with its fully sparse pair-schedule assembly, whose hand-written CUDA
  kernels are launched by :mod:`.tiled_cuda` and ``ops.chol_cuda``, and its
  dense-A entry point :func:`.tiled.engine_for`;
- :mod:`.factor` is the blocked-sparse factorization on the padded dense
  square (:class:`.factor.BlockSparseCholesky`), its diagonal tiles by
  ``ops.chol.cholesky`` (the potrf kernel on the card).
"""

from cholesky_is_magic_tpu_torch.sparse.symbolic import (
    FactorPlan,
    amd_order,
    analyze,
    column_counts,
    elimination_tree,
    postorder,
    supernodes,
)
from cholesky_is_magic_tpu_torch.sparse.factor import BlockSparseCholesky
from cholesky_is_magic_tpu_torch.sparse.tiled import engine_for

__all__ = [
    "FactorPlan",
    "analyze",
    "amd_order",
    "elimination_tree",
    "postorder",
    "column_counts",
    "supernodes",
    "BlockSparseCholesky",
    "engine_for",
]
