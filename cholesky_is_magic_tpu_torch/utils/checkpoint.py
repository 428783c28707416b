"""Checkpoint / resume for solver states.

Counterpart of ``cholesky_is_magic_tpu/utils/checkpoint.py``.  The
reference has no on-disk checkpointing but is designed for warm starts
(SURVEY.md §5 "Checkpoint/resume").  Every solver state of the port is a
dataclass of tensors (and plain fields), which :func:`.lanes.flatten`
splits into its tensors: :func:`save` writes those with ``torch.save``,
:func:`load` puts them back into a freshly built template of the same
state, on the template's devices and dtypes, to warm-start any solver
(``make_pdas(lp, warm=load(path, make_pdas(lp)))``).
"""

from __future__ import annotations

import os
from typing import Any

import torch

from cholesky_is_magic_tpu_torch.utils import lanes

_FILE = "state.pt"


def save(path: str, state: Any) -> None:
    """Write a solver state to the directory ``path`` (created; an older
    checkpoint there is replaced).  The tensors are copied to the host."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    leaves, _ = lanes.flatten(state)
    tmp = os.path.join(path, f".{_FILE}.{os.getpid()}")
    torch.save([t.detach().to("cpu", copy=True) for t in leaves], tmp)
    os.replace(tmp, os.path.join(path, _FILE))


def load(path: str, template: Any) -> Any:
    """Restore a state saved by :func:`save`.

    ``template`` is a matching state (e.g. a freshly built state for the
    same LP): it gives the structure, the non-tensor fields and each
    tensor's device and dtype; its tensor values are ignored.  A saved
    tensor whose shape differs from the template's raises ``ValueError``.
    """
    saved = torch.load(os.path.join(os.path.abspath(path), _FILE),
                       weights_only=True)
    leaves, rebuild = lanes.flatten(template)
    if len(saved) != len(leaves):
        raise ValueError(f"checkpoint holds {len(saved)} tensors, the template "
                         f"{len(leaves)}")
    for k, (s, t) in enumerate(zip(saved, leaves)):
        if s.shape != t.shape:
            raise ValueError(f"checkpoint tensor {k} has shape {tuple(s.shape)}, "
                             f"the template {tuple(t.shape)}")
    return rebuild([s.to(device=t.device, dtype=t.dtype)
                    for s, t in zip(saved, leaves)])
