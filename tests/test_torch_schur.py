"""The trailing update of the blocked Cholesky, S -= P·Pᵀ on the lower
triangle, in the Schur kernel's own summation order
(``chol_cuda.schur_fma_plain``: one chain of fused multiply-adds per entry, k
ascending, one float32 subtraction), on the CPU.

The card test holds the kernel against ``schur_fma_plain`` bit for bit, so
here that function is held against exact rational arithmetic rounded to
float32 once per fused multiply-add (``fractions.Fraction``), on inputs where
adding in float64 and rounding again gives another float32, and against the
update as the JAX package computes it (``S - P @ P.T`` in float32) within
2b·eps32·Σ|terms|.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cholesky_is_magic_tpu_torch.ops import chol_cuda

EPS32 = float(np.finfo(np.float32).eps)


def _round_f32(x: Fraction) -> np.float32:
    """The float32 nearest to the rational x, ties to the even mantissa."""
    y = np.float32(float(x))
    cands = [np.nextafter(y, np.float32(-np.inf)), y, np.nextafter(y, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(c.view(np.uint32)) & 1))


def _fma_exact(a, c, acc) -> np.float32:
    return _round_f32(Fraction(float(a)) * Fraction(float(c)) + Fraction(float(acc)))


def _fma32(a, c, acc):
    """``chol_cuda._fma32`` on float32 arrays, as float32."""
    as64 = lambda v: torch.from_numpy(np.asarray(v, np.float32)).double()  # noqa: E731
    return chol_cuda._fma32(as64(a), as64(c), as64(acc)).float().numpy()


# acc + a·c = 1 + 2^-23 + 2^-24 - 2^-70: just below the midpoint of two
# float32 neighbours.  float64 rounds it onto the midpoint, and the second
# rounding then goes to the even neighbour above; one rounding stays below.
BITES = (np.float32(2.0**-12 * (1 + 2.0**-23)), np.float32(2.0**-12 * (1 - 2.0**-23)),
         np.float32(1 + 2.0**-23))


def test_fma32_rounds_once_where_two_roundings_differ():
    a, c, acc = BITES
    twice = np.float32(np.float64(a) * np.float64(c) + np.float64(acc))
    once = _fma_exact(a, c, acc)
    assert once == np.float32(1 + 2.0**-23) and twice == np.float32(1 + 2.0**-22)
    assert _fma32(a, c, acc) == once
    assert _fma32(-a, c, -acc) == -once  # the mirrored case rounds the other way


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fma32_matches_exact_arithmetic(seed):
    """Random float32 triples over 12 decades, and triples whose sum cancels
    to a few bits: equal to the exact value rounded once."""
    rng = np.random.default_rng(seed)
    n = 300
    a = (rng.normal(size=n) * 10.0 ** rng.uniform(-6, 6, n)).astype(np.float32)
    c = (rng.normal(size=n) * 10.0 ** rng.uniform(-6, 6, n)).astype(np.float32)
    acc = (rng.normal(size=n) * 10.0 ** rng.uniform(-6, 6, n)).astype(np.float32)
    acc[: n // 3] = -(a[: n // 3] * c[: n // 3])  # cancels up to the product's error
    got = _fma32(a, c, acc)
    want = np.array([_fma_exact(*v) for v in zip(a, c, acc)], np.float32)
    np.testing.assert_array_equal(got, want)


def _operands(t, b, seed):
    rng = np.random.default_rng(seed)
    P = rng.normal(size=(t, b)).astype(np.float32)
    S = (P.astype(np.float64) @ P.T.astype(np.float64)
         + rng.normal(size=(t, t))).astype(np.float32)
    S[np.triu_indices(t, 1)] = np.nan  # never read, never written
    return S, P


@pytest.mark.parametrize("t,b,cols", [(5, 7, None), (6, 3, 2), (4, 9, 4)])
def test_schur_fma_plain_is_the_exact_chain(t, b, cols):
    S, P = _operands(t, b, t * b)
    got = chol_cuda.schur_fma_plain(torch.from_numpy(S), torch.from_numpy(P), cols).numpy()
    want = S.copy()
    for i in range(t):
        for j in range(min(i + 1, t if cols is None else cols)):
            acc = np.float32(0.0)
            for k in range(b):
                acc = _fma_exact(P[i, k], P[j, k], acc)
            want[i, j] = _round_f32(Fraction(float(S[i, j])) - Fraction(float(acc)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("t,b,cols", [(1, 16, None), (33, 33, None), (70, 100, None),
                                      (70, 128, 40), (130, 128, 128)])
def test_schur_fma_plain_matches_the_jax_update(t, b, cols):
    """Within 2b·eps32·Σ|terms| of the float32 update in JAX and of the
    port's plain version; the upper triangle and the columns from ``cols`` on
    untouched."""
    S, P = _operands(t, b, t + b)
    got = chol_cuda.schur_fma_plain(torch.from_numpy(S), torch.from_numpy(P), cols).numpy()
    low = np.nan_to_num(S, nan=0.0)
    with jax.default_matmul_precision("highest"):
        jx = np.asarray(jnp.asarray(low) - jnp.asarray(P) @ jnp.asarray(P).T)
    plain = torch.tril(torch.from_numpy(low) - torch.from_numpy(P) @ torch.from_numpy(P).T)
    mag = np.abs(low) + np.abs(P) @ np.abs(P).T
    r, c = np.indices((t, t))
    owned = (c <= r) & (c < (t if cols is None else cols))
    for other in (jx, plain.numpy()):
        assert np.all(np.abs(got - other)[owned] <= 2 * b * EPS32 * mag[owned])
    np.testing.assert_array_equal(got[~owned], S[~owned])


@pytest.mark.parametrize("t,cols", [(40, 16), (70, 64), (9, 9)])
def test_schur_split_update_equals_whole(t, cols):
    """The panel loop's two launches, the leading ``cols`` columns and then
    the block beyond them, leave what one whole update leaves."""
    S, P = _operands(t, 20, t)
    St, Pt = torch.from_numpy(S), torch.from_numpy(P)
    whole = chol_cuda.schur_fma_plain(St, Pt)
    split = chol_cuda.schur_fma_plain(St, Pt, cols)
    if cols < t:
        split[cols:, cols:] = chol_cuda.schur_fma_plain(split[cols:, cols:], Pt[cols:])
    np.testing.assert_array_equal(split.numpy(), whole.numpy())


def test_schur_wrapper_refuses_cpu_tensors():
    S, P = torch.eye(4), torch.ones(4, 2)
    before = dict(chol_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        chol_cuda.potrf_schur_(S, P)
    assert chol_cuda.LAUNCHES == before
