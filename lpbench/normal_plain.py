"""The plain normal equations: N = A·D²·Aᵀ + diag(boost) formed densely,
its Cholesky factor and its solves, in plain PyTorch and float64
throughout (so no product takes TF32), for holding the program's tile
engine to at a configuration's own size.

It imports nothing of the program, and lives beside ``reference/``
rather than in it: the check that decides ``correct`` there is NumPy and
loads no part of PyTorch.  A comes as its COO triplets (the
matrix the program factors, rows already scaled); ``d`` and ``boost`` are
what the program was handed, widened to float64.  N is formed from the
products of each column's pairs of entries, added into a dense m x m
array, so that no dense m x n operand is built (QAP15: N 320 MB, A·D 1.4
GB).  ``perm`` (new <- old, of length p >= m) puts N in another order,
rows m .. p-1 being unit rows, as a tile engine's padded slot order
holds them; the factor of the permuted N is unique, so a factor computed
in that order can be held to it.

- :func:`normal_matrix`: N (or its permuted, padded form);
- :func:`factor`: its lower Cholesky factor;
- :func:`solve`: N⁻¹ g from the factor;
- :func:`backward_error`: ‖L Lᵀ − N‖_F / ‖N‖_F of a factor computed
  elsewhere, and :func:`residual_error`: ‖N y − g‖₂ / (‖N‖_F ‖y‖₂ + ‖g‖₂)
  of a solution computed elsewhere, both in float64.
"""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


def _pairs(rows, cols, vals):
    """(p, q, a_pk a_qk, k) of every ordered pair of entries that share a
    column k."""
    order = np.argsort(cols, kind="stable")
    r, c, v = rows[order], cols[order], vals[order]
    start = np.searchsorted(c, c, side="left")
    length = np.searchsorted(c, c, side="right") - start
    first = np.repeat(np.arange(len(c)), length)
    offset = np.arange(len(first)) - np.repeat(np.cumsum(length) - length, length)
    second = start[first] + offset
    return r[first], r[second], v[first] * v[second], c[first]


def normal_matrix(rows, cols, vals, m: int, d, boost=None, perm=None,
                  device="cpu") -> torch.Tensor:
    """N = A·D²·Aᵀ + diag(boost) in float64 on ``device``; with ``perm``
    (new <- old, length p >= m) the p x p matrix N_ext[perm][:, perm],
    N_ext being N with p − m unit rows and columns appended."""
    p, q, w, k = _pairs(np.asarray(rows, np.int64), np.asarray(cols, np.int64),
                        np.asarray(vals, np.float64))
    dd = torch.as_tensor(d, dtype=F64, device=device)
    size = m if perm is None else len(perm)
    N = torch.zeros((size, size), dtype=F64, device=device)
    idx = (torch.as_tensor(p, device=device), torch.as_tensor(q, device=device))
    k = torch.as_tensor(k, device=device)
    N.index_put_(idx, torch.as_tensor(w, dtype=F64, device=device) * dd[k] ** 2,
                 accumulate=True)
    diag = torch.zeros(size, dtype=F64, device=device)
    if boost is not None:
        diag[:m] = torch.as_tensor(boost, dtype=F64, device=device)
    diag[m:] = 1.0
    N += torch.diag(diag)
    if perm is not None:
        pt = torch.as_tensor(np.asarray(perm, np.int64), device=device)
        N = N[pt][:, pt]
    return N


def factor(N: torch.Tensor) -> torch.Tensor:
    """The lower Cholesky factor of N (float64)."""
    return torch.linalg.cholesky(N)


def solve(L: torch.Tensor, g) -> torch.Tensor:
    """N⁻¹ g from N's factor L, for g of shape (m,)."""
    g = torch.as_tensor(g, dtype=F64, device=L.device)
    return torch.cholesky_solve(g[:, None], L)[:, 0]


def backward_error(N: torch.Tensor, L) -> float:
    """‖L Lᵀ − N‖_F / ‖N‖_F for a lower factor L computed elsewhere (any
    float dtype; widened to float64, its upper triangle ignored)."""
    L = torch.tril(torch.as_tensor(L, device=N.device).to(F64))
    return float(torch.linalg.norm(L @ L.T - N) / torch.linalg.norm(N))


def residual_error(N: torch.Tensor, y, g) -> float:
    """‖N y − g‖₂ / (‖N‖_F ‖y‖₂ + ‖g‖₂) of a solution y computed elsewhere."""
    y = torch.as_tensor(y, device=N.device).to(F64)
    g = torch.as_tensor(g, device=N.device).to(F64)
    return float(torch.linalg.norm(N @ y - g)
                 / (torch.linalg.norm(N) * torch.linalg.norm(y) + torch.linalg.norm(g)))
