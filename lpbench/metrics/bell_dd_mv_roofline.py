"""The double-word block-ELL kernel's share of its roofline (``csrc/bell_dd.cu``
``bell_dd_mv_kernel``): each launch's bound over the profiler's device
time, in the traced call.

The bound is the product's work on the matrix's stored nonzeros
(``BellMatrix.nnz``, handed to the wrappers as a plain int), whatever
format computes it: a value and a 32-bit index a nonzero (8 bytes), read
once for all lanes where they share the matrix (lane stride 0) and once a
lane where each holds its own copy; each lane's x read (4 bytes a column)
and its (hi, lo) written (8 bytes a row); ``DD_FLOPS_PER_ELEMENT`` a
nonzero a lane.  The zeros of the kernel's padded (8, 128) tiles count
nothing, so no later format can read above 100%.

The share follows how the lanes hold the matrix, which the wrappers see
and the work does not: a fleet whose lanes each hold a copy of A (as
``parallel.stack_sparse_states`` stacks them) is bound by reading every
copy, a fleet that shares one A (lane stride 0) by reading it once.  At
``pds-10.fleet64``'s 64 lanes the shared bound is about a third of the
copies' (0.0116 against 0.0346 ms for Aᵀ), so sharing A reads about a
third of the share even where the kernel gets faster: compare the share
only between runs of one layout, and the kernel's time across them.

A program without the kernel's wrappers has no launch to record, and a
launch of a matrix whose nonzeros were not counted (``nnz`` 0) has no
bound: the metric then reads nothing.
"""

import pathlib

from lpbench import roofline

KERNELS = r"\bbell_dd_mv_kernel\b"
MODULE = "cholesky_is_magic_tpu_torch.ops.bell_cuda"
SOURCE = pathlib.Path(__file__).resolve().parents[2].joinpath(*MODULE.split(".")).with_suffix(".py")


def bound(lanes: int, n_rows: int, n_cols: int, nnz: int, shared: bool) -> dict:
    """The least time of ``lanes`` double-word products of an (n_rows,
    n_cols) matrix of ``nnz`` nonzeros, ``shared`` by the lanes or not."""
    return roofline.bound(8 * nnz * (1 if shared else lanes) + 4 * lanes * n_cols
                          + 8 * lanes * n_rows,
                          roofline.DD_FLOPS_PER_ELEMENT * lanes * nnz)


def _nnz(args, kwargs) -> int:
    return args[4] if len(args) > 4 else kwargs.get("nnz", 0)


def _batched(args, kwargs):
    """The launch's bound, or None where its nonzeros were not counted."""
    blocks, _, x, n_rows = args[:4]
    nnz = _nnz(args, kwargs)
    return bound(x.shape[0], n_rows, x.shape[1], nnz, blocks.stride(0) == 0) if nnz else None


def _single(args, kwargs):
    """The launch's bound, or None where its nonzeros were not counted."""
    _, _, x, n_rows = args[:4]
    nnz = _nnz(args, kwargs)
    return bound(1, n_rows, x.shape[0], nnz, True) if nnz else None


LAUNCHES = ({f"{MODULE}:dd_mv_batched": _batched, f"{MODULE}:dd_mv": _single}
            if SOURCE.is_file() else {})


def read(run):
    if any(d is None for t in LAUNCHES for d in run.launches.get(t, [])):
        run.say(f"[roofline] {KERNELS}: a launch without its nonzeros' count; share not read")
        return None
    return roofline.traced_share(run, KERNELS, LAUNCHES)
