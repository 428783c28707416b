"""The block-ELL dd kernel's roofline share on fabricated runs: the bound
counts the stored nonzeros, not the padded tiles; a shared matrix is read
once; each recorded launch pairs with one kernel event of that name and no
other kernel's; a launch of an uncounted matrix reads nothing; the
wrappers it records are the program's."""

import types

import pytest
import torch

from lpbench import hooks, roofline, trace
from lpbench.drive import HERE, load

BELL = load(HERE, "metrics", "bell_dd_mv_roofline")

# pds-10's A (16558 x 65321 with its slack block, 154511 nonzeros) and Aᵀ.
M, N, NNZ = 16558, 65321, 154511


def test_the_bound_counts_nonzeros_not_tiles():
    # Aᵀ·y on 64 lanes, each lane its own copy of the matrix.
    b = BELL.bound(64, N, M, NNZ, shared=False)
    assert b["bytes"] == 8 * NNZ * 64 + 4 * 64 * M + 8 * 64 * N
    assert b["flops"] == roofline.DD_FLOPS_PER_ELEMENT * 64 * NNZ
    assert b["by"] == "bytes"
    # 8166 block-rows of 2 padded tiles hold 16.7M elements: the bound
    # reads a hundredth of them.
    assert b["bytes"] < 4 * 8166 * 2 * 1024 * 64 / 20
    shared = BELL.bound(64, N, M, NNZ, shared=True)
    assert b["bytes"] - shared["bytes"] == 8 * NNZ * 63
    assert BELL.bound(1, M, N, NNZ, shared=True)["ms"] == pytest.approx(
        (8 * NNZ + 4 * N + 8 * M) / roofline.PEAK_BYTES_PER_S * 1e3)


def _args(lanes, n_rows, n_cols, nnz, lane_stride):
    blocks = torch.zeros(1, 1, 1, 8, 128).expand(lanes, 1, 1, 8, 128) if lane_stride == 0 \
        else torch.zeros(lanes, 1, 1, 8, 128)
    return (blocks, torch.zeros(lanes, 1, 1, dtype=torch.int64), torch.zeros(lanes, n_cols),
            n_rows, nnz)


def test_the_launch_records_read_the_wrappers_arguments():
    shared = BELL._batched(_args(64, 8, 300, 77, 0), {})
    own = BELL._batched(_args(64, 8, 300, 77, 1), {})
    assert shared == BELL.bound(64, 8, 300, 77, True)
    assert own == BELL.bound(64, 8, 300, 77, False)
    blocks, bcols, x, n_rows, nnz = _args(1, 8, 300, 77, 1)
    assert BELL._single((blocks[0], bcols[0], x[0], n_rows), {"nnz": nnz}) == \
        BELL.bound(1, 8, 300, 77, True)


def test_the_targets_are_the_programs_wrappers():
    assert set(BELL.LAUNCHES) == {f"{BELL.MODULE}:dd_mv_batched", f"{BELL.MODULE}:dd_mv"}
    for target in BELL.LAUNCHES:
        owner, name = hooks._resolve(target)
        assert callable(getattr(owner, name))


def _run(kernels, bounds):
    tr = trace.Trace(window_s=1.0, busy_s=0.5, kernels=kernels, idle_by_host={},
                     device_by_name={})
    launches = {f"{BELL.MODULE}:dd_mv_batched": bounds}
    return types.SimpleNamespace(trace=tr, launches=launches, say=lambda line: None)


def test_each_launch_pairs_with_one_event_of_its_kernel():
    b = BELL.bound(64, N, M, NNZ, shared=False)
    name = "(anonymous namespace)::bell_dd_mv_kernel(float const*, long long const*, float const*)"
    others = [("dd_mv_kernel(float const*)", 0.001), ("void dd_mv_short_kernel<4, 2>()", 0.001)]
    run = _run([(name, 2e-3), *others, (name, 2e-3)], [b, b])
    assert BELL.read(run) == pytest.approx(100.0 * b["ms"] / 2.0)
    assert BELL.read(_run([(name, 2e-3), *others], [b, b])) is None
    assert BELL.read(_run(others, [])) is None
    # The dd A·x kernels' pattern does not take this kernel's events.
    DD_MV = load(HERE, "metrics", "dd_mv_roofline")
    assert trace.Trace(1.0, 0.5, [(name, 1e-3)], {}, {}).kernel_s(DD_MV.KERNELS)[0] == 0


def test_an_uncounted_matrix_reads_nothing():
    """A BellMatrix built without its count (``nnz`` 0) gives its launch no
    bound, and the share is not read rather than read without the matrix."""
    blocks, bcols, x, n_rows, _ = _args(64, 8, 300, 0, 1)
    assert BELL._batched((blocks, bcols, x, n_rows, 0), {}) is None
    assert BELL._single((blocks[0], bcols[0], x[0], n_rows), {}) is None
    b = BELL.bound(64, N, M, NNZ, shared=False)
    name = "(anonymous namespace)::bell_dd_mv_kernel(float const*, long long const*, float const*)"
    said = []
    run = _run([(name, 2e-3), (name, 2e-3)], [b, None])
    run.say = said.append
    assert BELL.read(run) is None
    assert said and "nonzeros" in said[0]
