"""The tile engine's triangular-solve kernel's share of its roofline
(``csrc/tile_solve.cu``: ``tile_solve_fwd_kernel`` and
``tile_solve_bwd_kernel``, one launch a pass): each launch's bound over the
profiler's device time, in the traced call.

The bound of a pass is the least any implementation reads: every
off-diagonal tile of L once (b² floats) and the lower half of every inverse
diagonal tile (b(b+1)/2 floats), a lane (once for all lanes where they share
them, lane stride 0), each lane's right-hand side read and its result
written (B·b floats each); 2b² operations a tile and b(b+1) an inverse
tile a lane.  What a kernel reads again (the vectors of earlier panel
steps, the upper triangle's stray entries) counts nothing, so the share
cannot pass 100%.

A program without the kernel's launch wrapper (``tile_solve_pass``) has no
launch to record, and the metric then reads nothing.
"""

import pathlib

from lpbench import roofline

KERNELS = r"\btile_solve_(fwd|bwd)_kernel\b"
MODULE = "cholesky_is_magic_tpu_torch.sparse.tiled_cuda"
TARGET = "tile_solve_pass"
SOURCE = pathlib.Path(__file__).resolve().parents[2].joinpath(*MODULE.split(".")).with_suffix(".py")


def bound(lanes: int, b: int, B: int, tiles: int, shared_l: bool = False,
          shared_inv: bool = False) -> dict:
    """The least time of one pass over ``lanes`` lanes of an engine with
    ``B`` panels of b-wide tiles and ``tiles`` off-diagonal tiles, L or the
    inverse tiles shared by the lanes or not."""
    per_l = 4 * tiles * b * b
    per_inv = 4 * B * (b * (b + 1) // 2)
    nbytes = (per_l * (1 if shared_l else lanes) + per_inv * (1 if shared_inv else lanes)
              + 2 * 4 * lanes * B * b)
    return roofline.bound(nbytes, lanes * (2 * tiles * b * b + B * b * (b + 1)))


def _describe(args, kwargs):
    """The bound of one launch from its operands: L (lanes, NT+1, b, b),
    the inverses (lanes, B, b, b), the right-hand sides and the pass's
    tables (their ``tiles``)."""
    L, invd, _, tables = args[:4]
    lanes = L.shape[0]
    return bound(lanes, L.shape[-1], invd.shape[1], tables.tiles,
                 lanes > 1 and L.stride(0) == 0, lanes > 1 and invd.stride(0) == 0)


LAUNCHES = ({f"{MODULE}:{TARGET}": _describe}
            if SOURCE.is_file() and f"def {TARGET}(" in SOURCE.read_text() else {})


def read(run):
    return roofline.traced_share(run, KERNELS, LAUNCHES)
