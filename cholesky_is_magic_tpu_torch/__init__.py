"""cholesky-is-magic on PyTorch and CUDA: the dense pdas -> pdas_dd slice.

The PyTorch port of :mod:`cholesky_is_magic_tpu`, written for an NVIDIA H100
(``sm_90a``).  The JAX package stays the reference this port is held
against; the module paths mirror it, so each counterpart is easy to find:

- :mod:`.ingest`  — MPS reader, standard form (NumPy copies) and the padded
  dense operand set :class:`~.ingest.device.DeviceLP`;
- :mod:`.ops`     — double-word arithmetic, the hand-written CUDA
  double-word matvec kernels (``csrc/dd_matvec.cu``), the dense
  normal-equations factor/solve and Krylov refinement;
- :mod:`.kkt`     — the block-eliminated KKT Newton step;
- :mod:`.solvers` — dense pdas and its double-word pdas_dd finisher;
- :mod:`.api`     — ``solve(problem, "pdas" | "pdas_dd", device=...)``.

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


__version__ = "0.1.0"

__all__ = [
    "MPSData",
    "read_mps",
    "read_mps_file",
    "StandardForm",
    "to_standard_form",
    "rescale_sf",
    "solve",
]
