"""The double-word block-ELL kernel on the card (``csrc/bell_dd.cu``,
``ops/bell_cuda.py``), bit for bit against the plain form it replaces
(``ops.bell._dd_matvec_plain``): a staircase of the port's generator (A and
Aᵀ), single and under ``torch.func.vmap`` over 64 lanes with one shared
``BellMatrix`` and with stacked copies, kb from 1 to 4, ragged rows and
columns, a NaN and an Inf in x, ``dd_matvec_dd``, the launch counts and what
the wrapper refuses.

Every test here needs an NVIDIA card and skips without one.  The file
imports no jax; run it on the card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_bell.py -m cuda
"""

import numpy as np
import pytest
import torch

from cholesky_is_magic_tpu_torch.ops import bell, bell_cuda
from cholesky_is_magic_tpu_torch.ops import dd as ddm

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _bits_equal(a: ddm.DD, b: ddm.DD) -> bool:
    """hi and lo equal bit for bit (the sign of a zero too), NaNs in the
    same places."""
    def same(u, v):
        u0, v0 = torch.nan_to_num(u), torch.nan_to_num(v)
        return (torch.equal(torch.isnan(u), torch.isnan(v)) and torch.equal(u0, v0)
                and torch.equal(torch.signbit(u0), torch.signbit(v0)))

    return same(a.hi, b.hi) and same(a.lo, b.lo)


def _staircase(dev, m=300):
    """A and Aᵀ of the generator's staircase (with its slack block) as
    BellMatrix, float32 on ``dev``."""
    from cholesky_is_magic_tpu_torch.utils.testing import constructed_optimum_lp

    sf, _ = constructed_optimum_lp(m=m, seed=3, width=4)
    shape = (sf.ncons, sf.nvars)
    kw = dict(dtype=torch.float32, max_dense_frac=100.0, device=dev)
    EB = bell.from_coo(sf.a_rows, sf.a_cols, sf.a_vals, shape, **kw)
    ETB = bell.from_coo(sf.a_cols, sf.a_rows, sf.a_vals, shape[::-1], **kw)
    return EB, ETB


def _with_kb(rng, m, n, kb, dev):
    """A random (m, n) BellMatrix with kb tiles in every other block-row
    (fewer, so padded, in the rest) and values over many binades."""
    ncb = -(-n // 128)
    rows, cols = [], []
    for br in range(-(-m // 8)):
        want = kb if br % 2 == 0 else int(rng.integers(1, kb + 1))
        for tile in rng.choice(ncb, size=want, replace=False):
            for r in range(8 * br, min(m, 8 * br + 8)):
                c = tile * 128 + rng.integers(0, min(128, n - tile * 128), size=3)
                rows += [r] * len(c)
                cols += list(c)
    vals = rng.normal(size=len(rows)) * np.exp(3 * rng.normal(size=len(rows)))
    B = bell.from_coo(np.array(rows), np.array(cols), vals, (m, n), dtype=torch.float32,
                      max_dense_frac=100.0, device=dev)
    assert B.kb == kb
    return B


def _x(rng, n, dev, lanes=None):
    shape = (n,) if lanes is None else (lanes, n)
    v = rng.normal(size=shape) * np.exp(3 * rng.normal(size=shape))
    return torch.from_numpy(v.astype(np.float32)).to(dev)


def test_staircase_single_and_vmapped_lanes(dev):
    """A and Aᵀ of the staircase: the kernel (one launch per call, one per
    vmapped call over 64 lanes sharing the BellMatrix) equals the plain
    form lane by lane, and so does ``dd_matvec_dd``."""
    rng = np.random.default_rng(0)
    for B in _staircase(dev):
        x = _x(rng, B.n_cols, dev)
        before = dict(bell_cuda.LAUNCHES)
        got = bell.dd_matvec(B, x)
        assert bell_cuda.LAUNCHES["bell_mv"] == before["bell_mv"] + 1
        assert _bits_equal(got, bell._dd_matvec_plain(B, x))
        X = _x(rng, B.n_cols, dev, lanes=64)
        vm = torch.func.vmap(lambda v: bell.dd_matvec(B, v))(X)
        assert bell_cuda.LAUNCHES["bell_mv_batched"] == before["bell_mv_batched"] + 1
        plain = torch.func.vmap(lambda v: bell._dd_matvec_plain(B, v))(X)
        assert _bits_equal(vm, plain)
        for k in (0, 17, 63):
            assert _bits_equal(ddm.DD(vm.hi[k], vm.lo[k]), bell._dd_matvec_plain(B, X[k]))
        lo = _x(rng, B.n_cols, dev) * 1e-8
        want = ddm.dd_add_w(bell._dd_matvec_plain(B, x), bell.matvec(B, lo))
        assert _bits_equal(bell.dd_matvec_dd(B, ddm.DD(x, lo)), want)


@pytest.mark.parametrize("kb", [1, 2, 3, 4])
@pytest.mark.parametrize("m,n", [(8, 520), (61, 1000), (203, 389)])
def test_every_kb_on_ragged_shapes(dev, kb, m, n):
    """kb 1 to 4, rows not a multiple of 8 and columns not of 128: single,
    and 5 lanes of stacked copies of the matrix (lane strides not 0)."""
    rng = np.random.default_rng(kb * 1000 + m)
    B = _with_kb(rng, m, n, kb, dev)
    x = _x(rng, n, dev)
    assert _bits_equal(bell.dd_matvec(B, x), bell._dd_matvec_plain(B, x))
    X = _x(rng, n, dev, lanes=5)
    vm = torch.func.vmap(lambda b, c, v: bell.dd_matvec(
        bell.BellMatrix(b, c, B.n_rows, B.n_cols, B.nnz), v))(
            torch.stack([B.blocks] * 5), torch.stack([B.bcols] * 5), X)
    for k in range(5):
        assert _bits_equal(ddm.DD(vm.hi[k], vm.lo[k]), bell._dd_matvec_plain(B, X[k]))


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_a_nan_or_inf_in_x_spreads_as_in_the_plain_form(dev, bad):
    """Padded tiles read columns 0..127 of x: a NaN or Inf there reaches
    every block-row with a padded tile, as in the plain form."""
    rng = np.random.default_rng(7)
    B = _with_kb(rng, 61, 1000, 3, dev)
    x = _x(rng, 1000, dev)
    x[5] = bad
    x[700] = bad
    got, want = bell.dd_matvec(B, x), bell._dd_matvec_plain(B, x)
    assert torch.isnan(want.hi).any() or torch.isinf(want.hi).any()
    assert _bits_equal(got, want)
    X = x.expand(3, -1).clone()
    X[1, 5] = 0.0
    vm = torch.func.vmap(lambda v: bell.dd_matvec(B, v))(X)
    for k in range(3):
        assert _bits_equal(ddm.DD(vm.hi[k], vm.lo[k]), bell._dd_matvec_plain(B, X[k]))


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    rng = np.random.default_rng(1)
    B = _with_kb(rng, 20, 300, 2, dev)
    x = _x(rng, 300, dev)
    with pytest.raises(TypeError):
        bell_cuda.dd_mv(B.blocks.double(), B.bcols, x.double(), B.n_rows)
    with pytest.raises(TypeError):
        bell_cuda.dd_mv(B.blocks, B.bcols.int(), x, B.n_rows)
    with pytest.raises(ValueError, match="rows"):
        bell_cuda.dd_mv(B.blocks, B.bcols, x, B.n_rows + 8)
    with pytest.raises(ValueError, match="CUDA"):
        bell_cuda.dd_mv(B.blocks.cpu(), B.bcols.cpu(), x.cpu(), B.n_rows)
    with pytest.raises(ValueError, match="row-major"):
        bell_cuda.dd_mv(B.blocks.mT.contiguous().mT, B.bcols, x, B.n_rows)
    # A view starting off a 16-byte boundary is copied, not refused.
    flat = torch.zeros(B.blocks.numel() + 1, device=dev)
    view = flat[1:].view_as(B.blocks).copy_(B.blocks)
    got = bell_cuda.dd_mv(view, B.bcols, x, B.n_rows)
    assert _bits_equal(ddm.DD(*got), bell._dd_matvec_plain(B, x))


def test_float64_on_the_card_launches_nothing(dev):
    rng = np.random.default_rng(2)
    B = _with_kb(rng, 20, 300, 2, dev)
    B64 = bell.BellMatrix(B.blocks.double(), B.bcols, B.n_rows, B.n_cols, B.nnz)
    before = dict(bell_cuda.LAUNCHES)
    got = bell.dd_matvec(B64, _x(rng, 300, dev).double())
    assert got.hi.dtype == torch.float64 and bell_cuda.LAUNCHES == before
