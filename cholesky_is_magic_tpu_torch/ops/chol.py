"""Blocked Cholesky: the plain versions and the dispatchers.

Counterpart of ``cholesky_is_magic_tpu/ops/pallas_chol.py``.  The JAX module
holds a statically recursive right-looking factorization in plain jnp
(:func:`blocked_cholesky`, with its leaf factor and TRSM) and a Pallas TPU
kernel (``_potrf_kernel``) that runs the right-looking loop over 128-column
panels with the matrix resident in VMEM.  Here:

- :func:`blocked_cholesky`, :func:`_chol_leaf` and :func:`_rsolve_lower_T`
  are the plain PyTorch versions, operation for operation;
- :func:`cholesky` dispatches: a float32 CUDA tensor runs the hand-written
  blocked potrf (:func:`.chol_cuda.potrf`, the port of ``_potrf_kernel``),
  a CPU tensor or another dtype on the card :func:`blocked_cholesky` —
  exactly what the JAX ``cholesky()`` runs off the TPU or on a non-f32
  operand (``ops/pallas_chol.py:255-260``);
- :func:`factor_tile_` factors one (b, b) diagonal tile of the sparse tile
  engine and inverts its factor (the tile engine's panel step,
  ``sparse/tiled.py:357-358`` of the JAX package): on a float32 CUDA tensor
  the hand-written tile kernel (:func:`.chol_cuda.potrf_tile_`, b <= 128),
  with wider tiles split 2 x 2 around it (:func:`_factor_tile_split_`); on
  a CPU tensor, or another dtype on the card, :func:`_factor_tile_plain` at
  any b.

The route is chosen from the operands (``cuda_build.takes_kernel``) before
any launch; it is not a fallback.

All of them give NaN on a non-positive-definite input, which the callers'
finiteness checks report as a failed factorization.
"""

from __future__ import annotations

import torch

from cholesky_is_magic_tpu_torch.ops import chol_cuda
from cholesky_is_magic_tpu_torch.ops.cuda_build import takes_kernel

# Below this size, factor with the sequential masked update instead of
# recursing further (the JAX package's LEAF).
LEAF = 32


def _chol_leaf(A: torch.Tensor) -> torch.Tensor:
    """Unblocked lower Cholesky of a small block by masked rank-1 updates;
    columns are collected and stacked."""
    b = A.shape[0]
    idx = torch.arange(b, device=A.device)
    r, c = idx[:, None], idx[None, :]
    cols = []
    for j in range(b):
        col = A[:, j] * torch.rsqrt(A[j, j])  # includes the diagonal sqrt
        col = torch.where(idx >= j, col, 0.0)
        cols.append(col)
        A = torch.where((r > j) & (c > j), A - col[:, None] * col[None, :], A)
    return torch.stack(cols, dim=1)


def _rsolve_lower_T(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve X · Lᵀ = B for X (L lower-triangular), statically recursive:
    the TRSM of the blocked factorization."""
    b = L.shape[0]
    if b <= LEAF:
        cols = []
        for j in range(b):
            acc = B[:, j]
            for k in range(j):
                acc = acc - cols[k] * L[j, k]
            cols.append(acc / L[j, j])
        return torch.stack(cols, dim=1)
    h = b // 2
    L11, L21, L22 = L[:h, :h], L[h:, :h], L[h:, h:]
    X1 = _rsolve_lower_T(L11, B[:, :h])
    X2 = _rsolve_lower_T(L22, B[:, h:] - X1 @ L21.T)
    return torch.cat([X1, X2], dim=1)


def blocked_cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor by static half-splitting (plain PyTorch)."""
    b = A.shape[0]
    if b <= LEAF:
        return _chol_leaf(A)
    h = b // 2
    L11 = blocked_cholesky(A[:h, :h])
    L21 = _rsolve_lower_T(L11, A[h:, :h])
    L22 = blocked_cholesky(A[h:, h:] - L21 @ L21.T)
    top = torch.cat([L11, torch.zeros((h, b - h), dtype=A.dtype,
                                      device=A.device)], dim=1)
    return torch.cat([top, torch.cat([L21, L22], dim=1)], dim=0)


def cholesky(N: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN on a non-PD input.

    A float32 CUDA tensor runs the hand-written blocked potrf at any n: it
    works from global memory, so the JAX package's VMEM gate (n > 1536 falls
    back to the library Cholesky there) does not carry over.  A CPU tensor,
    or another dtype on the card, runs :func:`blocked_cholesky`, as the JAX
    ``cholesky()`` does off the TPU or on a non-f32 matrix.
    """
    if takes_kernel(N.device, N.dtype):
        return chol_cuda.potrf(N)
    return blocked_cholesky(N)


def _factor_tile_plain(T: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, L⁻¹) of one tile: ``cholesky_ex`` on its lower triangle plus a
    triangular solve against I, both all-NaN on a non-PD tile (as
    ``jnp.linalg.cholesky`` and the JAX tile engine give)."""
    L, info = torch.linalg.cholesky_ex(T)
    L = torch.where(info == 0, L, float("nan"))
    eye = torch.eye(T.shape[-1], dtype=T.dtype, device=T.device)
    return L, torch.linalg.solve_triangular(L, eye, upper=False)


def _factor_tile_split_(T: torch.Tensor, inv: torch.Tensor, leaf_) -> None:
    """In place, as :func:`factor_tile_`, for a tile of any width: a 2 × 2
    split at ``chol_cuda.BLOCK`` (the widest tile the card's tile kernel
    takes), recursing on the trailing block while it is wider;
    ``leaf_(T, inv)`` factors a block of at most that width in place (the
    tile kernel on the card).  The inverse's lower-left block is the JAX
    ``_tri_inv`` formula (``sparse/tiled.py:46-67``).  Only the lower
    triangle of T is read, the upper triangles come back exactly zero, and
    the whole L and L⁻¹ are NaN when either leaf meets a non-positive pivot
    (a device-side fill, no host sync)."""
    b, h = T.shape[-1], chol_cuda.BLOCK
    if b <= h:
        leaf_(T, inv)
        return
    T21, T22 = T[h:, :h], T[h:, h:]
    X11, X22 = inv[:h, :h], inv[h:, h:]
    leaf_(T[:h, :h], X11)
    L21 = T21 @ X11.T
    T21.copy_(L21)
    T22.addmm_(L21, L21.T, alpha=-1)  # only its lower triangle is read next
    _factor_tile_split_(T22, X22, leaf_)
    inv[h:, :h].copy_(X22 @ (L21 @ X11)).neg_()
    T[:h, h:].zero_()
    inv[:h, h:].zero_()
    bad = torch.isnan(T[0, 0]) | torch.isnan(T[h, h])
    T.masked_fill_(bad, float("nan"))
    inv.masked_fill_(bad, float("nan"))


def factor_tile_(T: torch.Tensor, inv: torch.Tensor) -> None:
    """In place: T <- the lower factor of the (b, b) tile T (its lower
    triangle is read), inv <- that factor's inverse; upper triangles exactly
    zero, everything NaN on a non-PD tile.  On float32 CUDA tensors the tile
    kernel factors tiles of at most ``chol_cuda.BLOCK`` and
    :func:`_factor_tile_split_` splits wider ones around it; on the CPU, or
    in another dtype on the card, :func:`_factor_tile_plain`."""
    if takes_kernel(T.device, T.dtype, inv.dtype):
        _factor_tile_split_(T, inv, chol_cuda.potrf_tile_)
        return
    L, Li = _factor_tile_plain(T)
    T.copy_(L)
    inv.copy_(Li)
