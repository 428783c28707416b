"""The hand-written CUDA double-word kernels on the card.

Every test here needs an NVIDIA card and skips without one.  The file
imports no jax, so it also runs on a machine without it; the repository's
tests/conftest.py imports jax, so run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import os

import numpy as np
import pytest
import torch

from cholesky_is_magic_tpu_torch.ops import dd as ddm
from cholesky_is_magic_tpu_torch.ops import dd_cuda

pytestmark = pytest.mark.cuda

EPS32 = float(np.finfo(np.float32).eps)
AFIRO = os.path.join(os.path.dirname(__file__), "fixtures", "afiro.mps")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _f64(d):
    return d.hi.double().cpu().numpy() + d.lo.double().cpu().numpy()


def _inputs(rng, m, n, dev):
    A = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.normal(size=m).astype(np.float32)).to(dev)
    return A, x, y


def test_kernels_match_f64_truth(dev):
    """test_dd_pallas.py::test_tpu_exact's contract, on the H100."""
    A, x, y = _inputs(np.random.default_rng(3), 512, 1024, dev)
    A64 = A.double().cpu().numpy()
    np.testing.assert_allclose(_f64(ddm.dd_matvec(A, x)),
                               A64 @ x.double().cpu().numpy(),
                               rtol=1e-11, atol=1e-11)
    np.testing.assert_allclose(_f64(ddm.dd_rmatvec(A, y)),
                               A64.T @ y.double().cpu().numpy(),
                               rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("m,n", [(1, 1), (7, 300), (300, 7), (129, 257),
                                 (1441, 5093)])
def test_kernels_match_plain_on_ragged_shapes(dev, m, n):
    """Not bit-equal (the summation order differs): within 64·eps32² of
    Σ|a_ij x_j| per output."""
    A, x, y = _inputs(np.random.default_rng(m + n), m, n, dev)
    for got, plain, scale in (
        (ddm.dd_matvec(A, x), ddm._dd_matvec_plain(A, x), A.abs() @ x.abs()),
        (ddm.dd_rmatvec(A, y), ddm._dd_matvec_plain(A.T, y),
         A.abs().T @ y.abs()),
    ):
        err = np.abs(_f64(got) - _f64(plain))
        assert np.all(err <= 64 * EPS32**2 * scale.double().cpu().numpy())


def test_each_call_counts_one_launch(dev):
    A, x, y = _inputs(np.random.default_rng(0), 64, 96, dev)
    before = dict(dd_cuda.LAUNCHES)
    ddm.dd_matvec(A, x)
    ddm.dd_rmatvec(A, y)
    ddm.dd_rmatvec(A, y)
    assert dd_cuda.LAUNCHES["mv"] == before["mv"] + 1
    assert dd_cuda.LAUNCHES["rmv"] == before["rmv"] + 2


def test_wrapper_refuses_what_the_kernels_do_not_take(dev):
    A, x, _y = _inputs(np.random.default_rng(1), 16, 32, dev)
    with pytest.raises(TypeError):
        ddm.dd_matvec(A.double(), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        ddm.dd_matvec(A[:, ::2], x[::2])
    with pytest.raises(ValueError, match="shapes"):
        ddm.dd_matvec(A, x[:5])
    with pytest.raises(ValueError, match="CUDA"):
        dd_cuda.dd_mv(A, x.cpu())


def test_solve_afiro_on_the_card(dev):
    import cholesky_is_magic_tpu_torch as cimt

    rep = cimt.solve(AFIRO, "pdas_dd", device="cuda")
    assert rep.summary["gap"] <= 1e-8
    assert abs(rep.objective + 464.75314285714285) <= 1e-7 * 464.75314285714285
