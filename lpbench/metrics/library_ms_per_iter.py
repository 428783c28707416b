"""Device ms per batched-loop iteration in the libraries' kernels (cuBLAS,
cuSOLVER, CUTLASS, MAGMA: the dense normal equations' products and factors,
the tile engine's panel matmuls and solves), by kernel name, from the
traced call.  The port's own kernels are left out by name whatever they
are called (``potrf_tile_kernel`` would match ``potrf``): every
``__global__`` function of its ``csrc/``."""

import pathlib
import re

LIBRARY = re.compile(r"gemm|gemv|trsm|trsv|syrk|potrf|potrs|getrf|cublas|cusolver"
                     r"|cutlass|xmma|nvjet|magma|splitkreduce", re.IGNORECASE)
CSRC = pathlib.Path(__file__).resolve().parents[2] / "cholesky_is_magic_tpu_torch" / "csrc"
GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def own_kernels(csrc: pathlib.Path = CSRC) -> set:
    """The names of the port's hand-written kernels."""
    names = set()
    for path in sorted(csrc.glob("*.cu*")):
        names.update(GLOBAL.findall(path.read_text()))
    return names


def is_library(kernel: str, own: set) -> bool:
    """Whether a profiler kernel name is a library's, not one of ``own``."""
    return (LIBRARY.search(kernel) is not None
            and not own & set(re.findall(r"\w+", kernel)))


def library_s(kernels: list, own: set) -> tuple[int, float]:
    """(launches, device seconds) of the library kernels among ``kernels``
    ((name, seconds) pairs)."""
    hits = [d for name, d in kernels if is_library(name, own)]
    return len(hits), float(sum(hits))


def read(run):
    if run.trace is None or run.traced_iterations <= 0:
        return None
    launches, seconds = library_s(run.trace.kernels, own_kernels())
    if launches == 0:
        return None
    return 1e3 * seconds / run.traced_iterations
