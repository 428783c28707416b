"""cholesky-is-magic on PyTorch and CUDA: primal affine scaling and the
pdas -> pdas_dd solve, dense and fully sparse, with the host presolve and
crossover, the matrix-free family (APPROX and the ALM outer loops), and the
batch mode (many LPs in one lane-batched loop).

The PyTorch port of :mod:`cholesky_is_magic_tpu`, written for an NVIDIA H100
(``sm_90a``).  The JAX package stays the reference this port is held
against; the module paths mirror it, so each counterpart is easy to find:

- :mod:`.ingest`  — MPS reader, standard form and presolve (NumPy copies), the padded
  dense operand set :class:`~.ingest.device.DeviceLP`, the matrix-free
  :class:`~.ingest.device.SparseLP` and the fully sparse
  :class:`~.ingest.device.SparseKKTLP`;
- :mod:`.ops`     — double-word arithmetic, ELL / block-ELL products, the
  dense normal equations, the blocked Cholesky, Krylov refinement, and
  the wrappers of the hand-written CUDA kernels (``csrc/``);
- :mod:`.sparse`  — host symbolic analysis and the tile engine;
- :mod:`.kkt`     — the block-eliminated KKT Newton step;
- :mod:`.solvers` — primal affine scaling, pdas and its double-word pdas_dd
  finisher, crossover (a certified vertex polish), APPROX and the ALM /
  AALM / ADCD outer loops;
- :mod:`.parallel` — batched pdas / pdas_dd over stacked dense LPs or
  same-A sparse states on one tile engine, the slabbed loop, batched
  affine scaling and batched sparse normal solves;
- :mod:`.api`     — ``solve(problem, "affine" | "pdas" | "pdas_dd" | "alm" |
  "aalm" | "selfdual", sparse=..., presolve=..., crossover=...,
  device=...)`` and ``solve_batch(problems, slab_iters=...)`` /
  ``embed_batch(problems)``.

The package imports ``torch`` and never ``jax``.  Importing it needs no
CUDA toolkit: the kernels are built at their first CUDA call.
"""

from cholesky_is_magic_tpu_torch.ingest.mps import MPSData, read_mps, read_mps_file
from cholesky_is_magic_tpu_torch.ingest.standard_form import (
    StandardForm,
    rescale_sf,
    to_standard_form,
)


def solve(problem, solver="pdas", **kwargs):
    """Solve an LP end to end (lazy re-export of :func:`.api.solve`)."""
    from cholesky_is_magic_tpu_torch.api import solve as _solve

    return _solve(problem, solver, **kwargs)


def solve_batch(problems, **kwargs):
    """Solve a batch of LPs in one batched pdas loop (lazy re-export of
    :func:`.api.solve_batch`)."""
    from cholesky_is_magic_tpu_torch.api import solve_batch as _solve_batch

    return _solve_batch(problems, **kwargs)


def embed_batch(problems, **kwargs):
    """Embed a batch of LPs once for repeated solves (lazy re-export of
    :func:`.api.embed_batch`)."""
    from cholesky_is_magic_tpu_torch.api import embed_batch as _embed_batch

    return _embed_batch(problems, **kwargs)


__version__ = "0.1.0"

__all__ = [
    "MPSData",
    "read_mps",
    "read_mps_file",
    "StandardForm",
    "to_standard_form",
    "rescale_sf",
    "solve",
    "solve_batch",
    "embed_batch",
]
