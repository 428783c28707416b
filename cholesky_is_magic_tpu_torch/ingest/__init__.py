"""Host-side problem ingest: MPS files -> standard form -> device operands.

``mps``, ``standard_form`` and ``presolve`` are NumPy-only copies of the
JAX package's modules; ``device`` builds the padded dense tensors and the
matrix-free sparse operands (``to_sparse_lp``) the solvers consume.
"""

from cholesky_is_magic_tpu_torch.ingest.device import (
    DeviceLP,
    SparseLP,
    to_device_lp,
    to_sparse_lp,
)
from cholesky_is_magic_tpu_torch.ingest.mps import MPSData, read_mps, read_mps_file
from cholesky_is_magic_tpu_torch.ingest.presolve import Presolve, presolve
from cholesky_is_magic_tpu_torch.ingest.standard_form import (
    StandardForm,
    extract_solution,
    rescale_sf,
    scale_constraints,
    to_standard_form,
)

__all__ = [
    "MPSData",
    "read_mps",
    "read_mps_file",
    "StandardForm",
    "to_standard_form",
    "rescale_sf",
    "scale_constraints",
    "extract_solution",
    "Presolve",
    "presolve",
    "DeviceLP",
    "to_device_lp",
    "SparseLP",
    "to_sparse_lp",
]
