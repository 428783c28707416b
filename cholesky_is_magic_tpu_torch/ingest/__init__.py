"""Host-side problem ingest: MPS files -> standard form -> device operands.

``mps`` and ``standard_form`` are NumPy-only copies of the JAX package's
modules; ``device`` builds the padded dense tensors the solvers consume.
"""

from cholesky_is_magic_tpu_torch.ingest.device import DeviceLP, to_device_lp
from cholesky_is_magic_tpu_torch.ingest.mps import MPSData, read_mps, read_mps_file
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
    "DeviceLP",
    "to_device_lp",
]
