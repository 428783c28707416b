"""Carry operands, iterates and results between NumPy and the port.

The JAX package's objects, handed over as NumPy arrays (any object whose
fields ``np.asarray`` accepts), become the port's tensors on a chosen device
and dtype, so that both packages can start from bit-identical state; the
port's results come back as NumPy.  Nothing here imports jax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cholesky_is_magic_tpu_torch.ingest.device import DeviceLP
from cholesky_is_magic_tpu_torch.ops.dd import DD
from cholesky_is_magic_tpu_torch.solvers.pdas import PDASState
from cholesky_is_magic_tpu_torch.solvers.pdas_dd import PDASDDState

_FLOAT_FIELDS = ("A", "c", "b", "l", "u")


def tensor_from_numpy(v, *, device="cpu", dtype=None) -> torch.Tensor:
    """One array -> tensor on ``device``; ``dtype`` None keeps the array's."""
    t = torch.from_numpy(np.array(v, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def device_lp_from_numpy(lp, *, device="cpu", dtype=None) -> DeviceLP:
    """A DeviceLP from an object with the fields A, c, b, l, u, row_mask,
    col_mask, row_type, m, n; ``dtype`` applies to the float fields."""
    fields = {
        f: tensor_from_numpy(getattr(lp, f), device=device,
                             dtype=dtype if f in _FLOAT_FIELDS else None)
        for f in _FLOAT_FIELDS + ("row_mask", "col_mask", "row_type")
    }
    return DeviceLP(**fields, m=int(lp.m), n=int(lp.n))


def pdas_state_from_numpy(st, *, device="cpu", dtype=None) -> PDASState:
    """A PDASState from an object with fields x, y, w, z and lp."""
    put = lambda v: tensor_from_numpy(v, device=device, dtype=dtype)
    return PDASState(
        x=put(st.x), y=put(st.y), w=put(st.w), z=put(st.z),
        lp=device_lp_from_numpy(st.lp, device=device, dtype=dtype),
    )


def pdas_dd_state_from_numpy(st, *, device="cpu", dtype=None) -> PDASDDState:
    """A PDASDDState from an object with fields x, y, w, z (each with
    ``hi`` and ``lo``) and lp."""
    put = lambda d: DD(tensor_from_numpy(d.hi, device=device, dtype=dtype),
                       tensor_from_numpy(d.lo, device=device, dtype=dtype))
    return PDASDDState(
        x=put(st.x), y=put(st.y), w=put(st.w), z=put(st.z),
        lp=device_lp_from_numpy(st.lp, device=device, dtype=dtype),
    )


def to_numpy(obj):
    """Tensors (inside dataclasses, tuples, lists and dicts) -> NumPy."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, DD):
        return DD(to_numpy(obj.hi), to_numpy(obj.lo))
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_numpy(v) for v in obj)
    return obj
