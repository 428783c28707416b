"""Double-word ("double-double" style) arithmetic on tensors.

Counterpart of ``cholesky_is_magic_tpu/ops/dd.py``, line for line: each value
is an unevaluated sum ``hi + lo`` of two working-precision floats, giving
~2x the mantissa bits (Dekker/Knuth error-free transformations).  The
working type on the card is f32; the CPU tests run the same code in f64 and
f32 against the JAX package and demand bit equality.

The Dekker split (``two_prod``) relies on ``a*b - p`` NOT being fused into
one FMA.  Eager PyTorch launches every operation as its own kernel and
never fuses, so the split is exact.  Keep ``torch.compile`` away from this
module: a fusing compiler may contract the split and break it.

``dd_matvec`` / ``dd_rmatvec`` are the hot primitives (every refinement
residual and the pdas_dd right-hand sides).  For a CUDA tensor they launch
the hand-written kernels of :mod:`.dd_cuda`; for a CPU tensor they run
``_dd_matvec_plain``, the torch form of the JAX package's
``_dd_matvec_xla``.  There is no fallback between the two.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class DD(NamedTuple):
    """An unevaluated sum hi + lo with |lo| <= ulp(hi)/2."""

    hi: torch.Tensor
    lo: torch.Tensor

    def to_working(self) -> torch.Tensor:
        return self.hi + self.lo


def _split_constant(dtype) -> float:
    # 2^ceil(p/2) + 1 where p = mantissa bits: f32 -> 4097, f64 -> 2^27+1.
    if dtype == torch.float64:
        return float(2**27 + 1)
    if dtype == torch.float32:
        return float(2**12 + 1)
    raise ValueError(f"unsupported double-word base dtype {dtype}")


def two_sum(a: torch.Tensor, b: torch.Tensor) -> DD:
    """Error-free a + b (Knuth two-sum, 6 flops, no branch)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return DD(s, err)


def fast_two_sum(a: torch.Tensor, b: torch.Tensor) -> DD:
    """Error-free a + b assuming |a| >= |b| (Dekker, 3 flops)."""
    s = a + b
    err = b - (s - a)
    return DD(s, err)


def _split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    c = _split_constant(a.dtype) * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a: torch.Tensor, b: torch.Tensor) -> DD:
    """Error-free a * b via Dekker splitting (no FMA needed)."""
    p = a * b
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return DD(p, err)


def dd_add(x: DD, y: DD) -> DD:
    """Double-word + double-word (accurate variant, ~20 flops)."""
    s = two_sum(x.hi, y.hi)
    t = two_sum(x.lo, y.lo)
    c = s.lo + t.hi
    v = fast_two_sum(s.hi, c)
    w = t.lo + v.lo
    return fast_two_sum(v.hi, w)


def dd_add_w(x: DD, y) -> DD:
    """Double-word + working-precision scalar/tensor."""
    s = two_sum(x.hi, y)
    v = s.lo + x.lo
    return fast_two_sum(s.hi, v)


def dd_neg(x: DD) -> DD:
    return DD(-x.hi, -x.lo)


def dd_sub(x: DD, y: DD) -> DD:
    return dd_add(x, dd_neg(y))


def dd_mul(x: DD, y: DD) -> DD:
    """Double-word * double-word (~eps^2 relative error)."""
    p = two_prod(x.hi, y.hi)
    lo = p.lo + (x.hi * y.lo + x.lo * y.hi)
    return fast_two_sum(p.hi, lo)


def dd_scale(x: DD, s: torch.Tensor) -> DD:
    """Double-word * working-precision scalar/tensor."""
    p = two_prod(x.hi, s)
    lo = p.lo + x.lo * s
    return fast_two_sum(p.hi, lo)


def dd_from(hi: torch.Tensor) -> DD:
    return DD(hi, torch.zeros_like(hi))


def dd_div(x: DD, y: DD) -> DD:
    """Double-word / double-word via one Newton correction (~eps^2)."""
    q1 = x.hi / y.hi
    r = dd_add_w(dd_neg(dd_scale(y, q1)), x.hi)  # x.hi - q1*y, exactly
    r = dd_add_w(r, x.lo)
    q2 = r.to_working() / y.hi
    return fast_two_sum(q1, q2)


def dd_matvec_dd(A: torch.Tensor, x: DD) -> DD:
    """Compensated A @ (x.hi + x.lo): exact-product dd matvec on the hi
    part plus a working-precision matvec on the (already eps-small) lo
    part — overall ~eps^2 accurate."""
    main = dd_matvec(A, x.hi)
    return dd_add_w(main, A @ x.lo)


def dd_where(c: torch.Tensor, x: DD, y: DD) -> DD:
    """Elementwise select between double-words."""
    return DD(torch.where(c, x.hi, y.hi), torch.where(c, x.lo, y.lo))


def dd_less(x: DD, y: DD) -> torch.Tensor:
    """Lexicographic x < y (valid for normalized |lo| <= ulp(hi)/2)."""
    return (x.hi < y.hi) | ((x.hi == y.hi) & (x.lo < y.lo))


def dd_clip(x: DD, l: torch.Tensor, u: torch.Tensor) -> DD:
    """clip(x, l, u) with working-precision bounds: exact DD(l, 0)/DD(u, 0)
    at the clamps, lexicographic compares so a value an eps below the bound
    (hi == l, lo < 0) still clamps."""
    zl = torch.zeros_like(l)
    below = dd_less(x, DD(l, zl))
    above = dd_less(DD(u, zl), x)
    return dd_where(below, DD(l, zl), dd_where(above, DD(u, zl), x))


def dd_min(x: DD, axis: int = -1) -> DD:
    """Minimum of a double-word tensor along ``axis`` (pairwise tree with
    lexicographic compares; +inf-padded to a power of two)."""
    hi = torch.movedim(x.hi, axis, -1)
    lo = torch.movedim(x.lo, axis, -1)
    n = hi.shape[-1]
    p = 1 << max(0, (n - 1)).bit_length()
    if p > n:
        hi = torch.nn.functional.pad(hi, (0, p - n), value=float("inf"))
        lo = torch.nn.functional.pad(lo, (0, p - n), value=0.0)
    cur = DD(hi, lo)
    while cur.hi.shape[-1] > 1:
        a = DD(cur.hi[..., 0::2], cur.lo[..., 0::2])
        b = DD(cur.hi[..., 1::2], cur.lo[..., 1::2])
        cur = dd_where(dd_less(a, b), a, b)
    return DD(cur.hi[..., 0], cur.lo[..., 0])


def dd_sum(x: DD, axis: int = -1) -> DD:
    """Compensated reduction of a double-word tensor along ``axis``.

    Binary-tree reduction with dd_add at each level over contiguous
    power-of-two blocks (the binary digits of n), combined left to right —
    the same order as the JAX package, which bit equality depends on.
    """
    hi = torch.movedim(x.hi, axis, -1)
    lo = torch.movedim(x.lo, axis, -1)

    def pow2_tree(hi, lo):  # length is a power of two
        n = hi.shape[-1]
        while n > 1:
            hi, lo = dd_add(
                DD(hi[..., 0::2], lo[..., 0::2]),
                DD(hi[..., 1::2], lo[..., 1::2]),
            )
            n //= 2
        return DD(hi[..., 0], lo[..., 0])

    n = hi.shape[-1]
    total = None
    off = 0
    while n > 0:
        p = 1 << (n.bit_length() - 1)
        part = pow2_tree(hi[..., off : off + p], lo[..., off : off + p])
        total = part if total is None else dd_add(total, part)
        off += p
        n -= p
    return total


def dd_dot(a: torch.Tensor, b: torch.Tensor) -> DD:
    """Compensated dot product (Ogita-Rump dot2): exact products, dd sum."""
    p = two_prod(a, b)
    return dd_sum(p, axis=-1)


def _dd_matvec_plain(A: torch.Tensor, x: torch.Tensor) -> DD:
    """The plain form of the compensated matvec (the JAX package's
    ``_dd_matvec_xla``): error-free elementwise products + tree dd-sum.
    The reference the CUDA kernels are held against; the CPU path."""
    p = two_prod(A, x[None, :])
    return dd_sum(p, axis=-1)


def dd_matvec(A: torch.Tensor, x: torch.Tensor) -> DD:
    """Compensated A @ x: error-free products, eps^2-class total.

    A CUDA tensor goes to the hand-written kernel (:func:`.dd_cuda.dd_mv`,
    which raises on what it cannot take); a CPU tensor to the plain form.
    """
    if A.is_cuda:
        from cholesky_is_magic_tpu_torch.ops import dd_cuda

        return DD(*dd_cuda.dd_mv(A, x))
    return _dd_matvec_plain(A, x)


def dd_rmatvec(A: torch.Tensor, x: torch.Tensor) -> DD:
    """Compensated Aᵀ @ x.  The CUDA kernel reads A in its natural
    row-major layout (no transpose copy); the plain form runs on A.T."""
    if A.is_cuda:
        from cholesky_is_magic_tpu_torch.ops import dd_cuda

        return DD(*dd_cuda.dd_rmv(A, x))
    return _dd_matvec_plain(A.T, x)


def dd_rmatvec_dd(A: torch.Tensor, x: DD) -> DD:
    """Compensated Aᵀ @ (x.hi + x.lo): dd rmatvec on the hi part plus a
    working-precision product on the (already eps-small) lo part."""
    main = dd_rmatvec(A, x.hi)
    return dd_add_w(main, A.T @ x.lo)


def dd_residual(b: torch.Tensor, A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """b - A @ x with the matvec in double-word precision, rounded back to
    working precision (the standard iterative-refinement residual)."""
    ax = dd_matvec(A, x)
    r = dd_add_w(dd_neg(ax), b)
    return r.to_working()
