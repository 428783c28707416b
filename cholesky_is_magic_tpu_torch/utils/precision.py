"""Matmul-precision guard: no TF32 anywhere in a solve.

The CUDA form of the bf16 trap in ``docs/DEVNOTES.md`` "Numerics": an
interior-point normal matrix assembled with a reduced-precision matmul
converges to visibly wrong objectives.  On the H100 the reduced format is
TF32 (about three decimal digits).  PyTorch leaves it off for matmuls by
default but on for cuDNN, and any library in the process may switch it on,
so every solver entry point runs under :func:`highest_precision`, which sets
all three switches and asserts them.
"""

from __future__ import annotations

import functools

import torch


def set_highest_precision() -> None:
    """Full-f32 matmuls and convolutions: TF32 off, precision "highest"."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def assert_highest_precision() -> None:
    """Raise if anything has switched TF32 back on."""
    if (
        torch.backends.cuda.matmul.allow_tf32
        or torch.backends.cudnn.allow_tf32
        or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError(
            "TF32 is enabled: the solvers need full-f32 matmuls "
            "(torch.backends.cuda.matmul.allow_tf32, "
            "torch.backends.cudnn.allow_tf32, "
            "torch.get_float32_matmul_precision())"
        )


def highest_precision(fn):
    """Decorator: set the full-f32 switches, assert them, then call ``fn``."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        set_highest_precision()
        assert_highest_precision()
        return fn(*args, **kwargs)

    return wrapper
