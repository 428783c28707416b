"""Standard form -> padded dense device operands.

Counterpart of ``cholesky_is_magic_tpu/ingest/device.py`` (``round_up``,
``DeviceLP``, ``to_device_lp``), dense only.  Every LP is embedded into a
(M, N) box rounded up to ``pad_multiple`` with boolean validity masks, and
the padding is inert exactly as in the JAX package:

- padded columns: A[:, j] = 0, c[j] = 0, bounds [-1, 1] — their slacks are
  1 and the solvers mask their directions to 0;
- padded rows: A[i, :] = 0, b[i] = 0 — the normal matrix gets +1 on those
  diagonal entries (``row_boost``), so the Cholesky stays positive definite
  and the corresponding dy is exactly 0.

PyTorch needs no static shapes, but the padded box is kept so that the port
and the reference run on identical operands.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cholesky_is_magic_tpu_torch.ingest.standard_form import StandardForm


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class DeviceLP:
    """Padded dense LP operands.

    ``m``/``n`` are the *true* constraint/variable counts; tensor shapes are
    the padded (M, N).
    """

    A: torch.Tensor  # (M, N)
    c: torch.Tensor  # (N,)
    b: torch.Tensor  # (M,)
    l: torch.Tensor  # (N,)
    u: torch.Tensor  # (N,)
    row_mask: torch.Tensor  # (M,) bool, True = real row
    col_mask: torch.Tensor  # (N,) bool, True = real column
    row_type: torch.Tensor  # (M,) int8, StandardForm.ROW_EQ/LE/GE (0 when padded)
    m: int
    n: int

    @property
    def shape(self) -> tuple[int, int]:
        return self.A.shape[-2], self.A.shape[-1]


def to_device_lp(
    sf: StandardForm,
    *,
    pad_multiple: int = 128,
    dtype: torch.dtype = torch.float32,
    device="cpu",
    big: float = 1e30,
    shape: tuple[int, int] | None = None,
) -> DeviceLP:
    """Embed a StandardForm into a padded DeviceLP on ``device``.

    Infinite bounds are encoded as +/-``big`` so that the tensors never hold
    actual infinities (inf - inf would poison masked arithmetic).  The
    operands are assembled in f64 on the host and rounded once to ``dtype``,
    as the JAX package does, so both packages see bit-identical data.
    ``shape`` forces an explicit padded (M, N).
    """
    m, n = sf.ncons, sf.nvars
    if shape is not None:
        M, N = shape
        if M < m or N < n:
            raise ValueError(f"shape {shape} smaller than problem ({m}, {n})")
    else:
        M = round_up(max(m, 1), pad_multiple)
        N = round_up(max(n, 1), pad_multiple)

    A = np.zeros((M, N), dtype=np.float64)
    np.add.at(A, (sf.a_rows, sf.a_cols), sf.a_vals)
    c = np.zeros(N)
    c[:n] = sf.c
    b = np.zeros(M)
    b[:m] = sf.b
    l = np.full(N, -1.0)
    u = np.full(N, 1.0)
    l[:n] = np.clip(sf.l, -big, big)
    u[:n] = np.clip(sf.u, -big, big)
    row_mask = np.zeros(M, dtype=bool)
    row_mask[:m] = True
    col_mask = np.zeros(N, dtype=bool)
    col_mask[:n] = True
    row_type = np.zeros(M, dtype=np.int8)
    row_type[:m] = sf.row_type

    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    put = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return DeviceLP(
        A=put(A.astype(np_dtype)),
        c=put(c.astype(np_dtype)),
        b=put(b.astype(np_dtype)),
        l=put(l.astype(np_dtype)),
        u=put(u.astype(np_dtype)),
        row_mask=put(row_mask),
        col_mask=put(col_mask),
        row_type=put(row_type),
        m=m,
        n=n,
    )
