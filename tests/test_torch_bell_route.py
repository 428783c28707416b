"""Which block-ELL double-word products go to the hand-written kernel
(``ops/bell_cuda.py``), on the CPU.

- CPU operands of either dtype take the plain form (``_dd_matvec_plain``),
  single and under ``torch.func.vmap``, and never reach a wrapper of the
  kernel; so ``tests/test_torch_sparse_ops.py``'s parity with the JAX
  package covers the CPU path unchanged.
- ``from_coo`` and the NumPy path of ``convert`` count the nonzeros
  (duplicates summed) into ``BellMatrix.nnz``, a host int the lanes keep
  and do not compare.
- The operator's vmap rule: one batched launch per vmapped call, an
  unbatched operand at lane stride 0, and each lane the plain form's,
  with the launch itself replaced by the plain form.
"""

import numpy as np
import pytest
import torch

from cholesky_is_magic_tpu_torch.ops import bell, bell_cuda
from cholesky_is_magic_tpu_torch.ops import dd as ddm
from cholesky_is_magic_tpu_torch.utils import lanes

torch.set_num_threads(1)


def _matrix(dtype, m=21, n=300, seed=0):
    rng = np.random.default_rng(seed)
    nnz = 120
    rows, cols = rng.integers(0, m, nnz), rng.integers(0, n, nnz)
    vals = rng.normal(size=nnz)
    B = bell.from_coo(rows, cols, vals, (m, n), dtype=dtype, max_dense_frac=100.0,
                      device="cpu")
    return B, rows, cols, rng


def _same(a: ddm.DD, b: ddm.DD) -> bool:
    return torch.equal(a.hi, b.hi) and torch.equal(a.lo, b.lo)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_operands_take_the_plain_form(dtype, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CPU tensor reached the block-ELL kernel's wrapper")

    for name in ("bell_dd_mv_op", "dd_mv", "dd_mv_batched"):
        monkeypatch.setattr(bell_cuda, name, boom)
    B, _, _, rng = _matrix(dtype)
    x = torch.tensor(rng.normal(size=B.n_cols), dtype=dtype)
    got = bell.dd_matvec(B, x)
    assert got.hi.dtype == dtype and got.hi.shape == (B.n_rows,)
    assert _same(got, bell._dd_matvec_plain(B, x))
    X = torch.tensor(rng.normal(size=(3, B.n_cols)), dtype=dtype)
    vm = torch.func.vmap(lambda v: bell.dd_matvec(B, v))(X)
    for k in range(3):
        assert _same(ddm.DD(vm.hi[k], vm.lo[k]), bell._dd_matvec_plain(B, X[k]))
    lo = x * 1e-9
    assert _same(bell.dd_matvec_dd(B, ddm.DD(x, lo)),
                 ddm.dd_add_w(bell._dd_matvec_plain(B, x), bell.matvec(B, lo)))


def test_from_coo_counts_the_stored_nonzeros():
    B, rows, cols, _ = _matrix(torch.float32)
    assert B.nnz == len({(r, c) for r, c in zip(rows.tolist(), cols.tolist())})
    assert B.nnz == int(torch.count_nonzero(B.blocks))
    dup = bell.from_coo(np.array([3, 3, 0]), np.array([7, 7, 130]),
                        np.array([1.5, 2.5, -1.0]), (8, 256), max_dense_frac=100.0,
                        device="cpu")
    assert dup.nnz == 2
    plain = bell.BellMatrix(B.blocks, B.bcols, B.n_rows, B.n_cols)
    assert plain.nnz == 0
    stacked = lanes.stack([B, B])
    assert stacked.nnz == B.nnz and lanes.lane(stacked, 1).nnz == B.nnz
    # An explicit zero is stored but is no nonzero.
    zero = bell.from_coo(np.array([3, 0]), np.array([7, 130]), np.array([0.0, -1.0]),
                         (8, 256), max_dense_frac=100.0, device="cpu")
    assert zero.nnz == 1


def test_the_numpy_path_counts_them_too_and_lanes_stack_whatever_their_counts():
    """A BellMatrix carried over from NumPy (``convert``) counts the same
    nonzeros as ``from_coo``; lanes of one pattern stack whatever their
    counts (a lane may hold a zero where another does not), keeping the
    first lane's."""
    import types

    from cholesky_is_magic_tpu_torch.convert import _bell_from_numpy

    B, *_ = _matrix(torch.float32)
    host = types.SimpleNamespace(blocks=B.blocks.numpy(), bcols=B.bcols.numpy(),
                                 n_rows=B.n_rows, n_cols=B.n_cols)
    C = _bell_from_numpy(host, device="cpu", dtype=torch.float32)
    assert C.nnz == B.nnz > 0
    k = torch.nonzero(B.blocks)[0]
    blocks = B.blocks.clone()
    blocks[tuple(k)] = 0.0
    D = _bell_from_numpy(types.SimpleNamespace(**{**vars(host), "blocks": blocks.numpy()}),
                         device="cpu", dtype=torch.float32)
    assert D.nnz == B.nnz - 1
    stacked = lanes.stack([C, D])
    assert stacked.nnz == C.nnz
    assert torch.equal(lanes.lane(stacked, 1).blocks, blocks)
    with pytest.raises(ValueError, match="differ outside their tensors"):
        lanes.stack([B, bell.BellMatrix(B.blocks, B.bcols, B.n_rows, B.n_cols + 1)])


@pytest.mark.parametrize("batched_matrix", [False, True])
def test_the_vmap_rule_launches_once_for_all_lanes(batched_matrix, monkeypatch):
    """Under vmap the operator makes one batched call with the lanes first:
    a shared BellMatrix at lane stride 0, stacked copies at their own; the
    plain form stands in for the launch, lane by lane."""
    calls = []

    def plain_batched(blocks, bcols, x, n_rows, nnz=0):
        calls.append((blocks.shape, blocks.stride(0), bcols.stride(0), x.stride(0), nnz))
        outs = [bell._dd_matvec_plain(bell.BellMatrix(blocks[k], bcols[k], n_rows,
                                                      x.shape[1]), x[k])
                for k in range(x.shape[0])]
        return torch.stack([o.hi for o in outs]), torch.stack([o.lo for o in outs])

    monkeypatch.setattr(bell_cuda, "dd_mv_batched", plain_batched)
    B, _, _, rng = _matrix(torch.float32, m=37, n=700, seed=4)
    X = torch.tensor(rng.normal(size=(5, B.n_cols)), dtype=torch.float32)
    if batched_matrix:
        blocks = torch.stack([B.blocks] * 5)
        bcols = torch.stack([B.bcols] * 5)
        vm = torch.func.vmap(lambda b, c, v: bell_cuda.bell_dd_mv_op(
            b, c, v, B.n_rows, B.nnz))(blocks, bcols, X)
    else:
        vm = torch.func.vmap(lambda v: bell_cuda.bell_dd_mv_op(
            B.blocks, B.bcols, v, B.n_rows, B.nnz))(X)
    assert len(calls) == 1
    shape, s_blocks, s_bcols, s_x, nnz = calls[0]
    assert shape == (5, *B.blocks.shape) and nnz == B.nnz and s_x == B.n_cols
    if batched_matrix:
        assert (s_blocks, s_bcols) == (B.blocks.numel(), B.bcols.numel())
    else:
        assert (s_blocks, s_bcols) == (0, 0)
    for k in range(5):
        assert _same(ddm.DD(vm[0][k], vm[1][k]), bell._dd_matvec_plain(B, X[k]))


def test_lane_layouts_the_kernel_takes():
    t = torch.zeros(4, 3, 2, 8, 128)
    assert bell_cuda._lane_contiguous(t)
    assert bell_cuda._lane_contiguous(t[:1].expand(4, -1, -1, -1, -1))
    assert bell_cuda._lane_contiguous(torch.zeros(4, 2, 2, 8, 128)[:, :1])
    assert not bell_cuda._lane_contiguous(t.mT)
    assert not bell_cuda._lane_contiguous(torch.zeros(4, 3, 2, 8, 128)[:, :, :1])
    assert not bell_cuda._lane_contiguous(torch.zeros(3, 4, 2, 8, 128).movedim(1, 0))
