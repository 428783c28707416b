"""Where the port runs, and how its kernels are launched, on the CPU.

Every public function of the port that takes ``device`` defaults to the
card (``solve_batch`` and ``embed_batch`` too); without one, a call that
leaves ``device`` unset raises instead of solving on the CPU.  The panel kernel's launch helper (16-byte
alignment) gives the expected answers.
"""

import importlib
import inspect
import os

import numpy as np
import pytest
import torch

import cholesky_is_magic_tpu_torch as cimt
from cholesky_is_magic_tpu_torch import api, convert
from cholesky_is_magic_tpu_torch.ingest import device as t_device
from cholesky_is_magic_tpu_torch.ops import bell, chol_cuda, sparse_ops
from cholesky_is_magic_tpu_torch.sparse import tiled

# The modules (the package re-exports functions of the same names).
affine = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.affine")
pdas = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas")
pdas_dd = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas_dd")

AFIRO = os.path.join(os.path.dirname(__file__), "fixtures", "afiro.mps")

DEVICE_FUNCTIONS = [
    api.solve, t_device.to_device_lp, pdas.make_pdas_sparse,
    affine.make_affine_state_sparse,
    pdas_dd.make_pdas_dd_sparse, tiled.engine_for_sparse, tiled.TiledCholesky,
    sparse_ops.from_coo, sparse_ops.from_dense, bell.from_coo,
    convert.tensor_from_numpy, convert.device_lp_from_numpy,
    convert.pdas_state_from_numpy, convert.pdas_dd_state_from_numpy,
    t_device.to_sparse_lp, convert.sparse_lp_from_numpy,
    convert.approx_problem_from_numpy, convert.alm_state_from_numpy,
    api.solve_batch, api.embed_batch,
]


def _needs_no_card():
    if torch.cuda.is_available():
        pytest.skip("checks what happens on a machine without a card")


@pytest.mark.parametrize("fn", DEVICE_FUNCTIONS, ids=lambda f: f.__qualname__)
def test_device_defaults_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_solve_without_a_card_raises_unless_asked_for_the_cpu():
    _needs_no_card()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cimt.solve(AFIRO, "pdas_dd")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cimt.solve(AFIRO, "pdas_dd", sparse=True, block=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cimt.solve(AFIRO, "affine", presolve=True)
    for solver in ("alm", "aalm", "selfdual"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cimt.solve(AFIRO, solver)
    rep = cimt.solve(AFIRO, "pdas_dd", device="cpu", dtype=torch.float64,
                     pad_multiple=16)
    assert rep.status == "optimal"


def _coo(m=2, n=3):
    rows, cols = np.nonzero(np.ones((m, n)))
    return rows, cols, np.ones(m * n), (m, n)


@pytest.mark.parametrize("call", [
    lambda: t_device.to_device_lp(cimt.to_standard_form(cimt.read_mps_file(AFIRO))),
    lambda: pdas.make_pdas_sparse(cimt.to_standard_form(cimt.read_mps_file(AFIRO)),
                                  block=16),
    lambda: affine.make_affine_state_sparse(
        cimt.to_standard_form(cimt.read_mps_file(AFIRO)), block=16),
    lambda: tiled.engine_for_sparse(np.eye(4), block=2),
    lambda: sparse_ops.from_coo(*_coo()),
    lambda: sparse_ops.from_dense(np.eye(3)),
    lambda: bell.from_coo(*_coo(8, 128)),
    lambda: convert.tensor_from_numpy(np.ones(3)),
    lambda: t_device.to_sparse_lp(cimt.to_standard_form(cimt.read_mps_file(AFIRO))),
    lambda: cimt.solve_batch([AFIRO]),
    lambda: cimt.embed_batch([AFIRO]),
], ids=["to_device_lp", "make_pdas_sparse", "make_affine_state_sparse",
        "engine_for_sparse",
        "ell_from_coo", "ell_from_dense", "bell_from_coo", "tensor_from_numpy",
        "to_sparse_lp", "solve_batch", "embed_batch"])
def test_device_unset_without_a_card_raises(call):
    _needs_no_card()
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        call()


@pytest.mark.parametrize("ptr,ld,want", [
    (0x1000, 128, True), (0x1000, 1536, True), (0x1010, 4, True), (0x2000, 5120, True),
    (0x1000, 1441, False),  # lda % 4 != 0
    (0x1000, 5093, False),
    (0x1004, 128, False),   # a 4-byte storage offset
    (0x1008, 1536, False),
    (0x100c, 4, False),
])
def test_aligned16_follows_the_pointer_and_the_row_stride(ptr, ld, want):
    """The panel kernel's 16-byte copies need every row on a boundary."""
    assert chol_cuda.aligned16(ptr, ld) is want


def test_aligned16_on_views():
    A = torch.zeros(8, 16)
    base = A.data_ptr()
    # Rows of a view: the panel of a 16-wide matrix starts on a boundary
    # wherever the buffer does; one column in, it does not.
    assert chol_cuda.aligned16(A[2:, :4].data_ptr(), A.stride(0)) == (base % 16 == 0)
    assert not chol_cuda.aligned16(A[2:, 1:].data_ptr(), A.stride(0))
    B = torch.zeros(8, 1441)
    assert not chol_cuda.aligned16(B.data_ptr(), B.stride(0))


def test_panel_rows_per_cta_is_one_the_kernel_takes():
    assert chol_cuda.PANEL_ROWS_PER_CTA in chol_cuda.PANEL_ROWS
    P = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="rows_per_cta"):
        chol_cuda._potrf_panel(P, torch.eye(2), P.T.contiguous(), 12)
