"""Build, load and launch the hand-written Hopper double-word matvec kernels.

The kernels (``csrc/dd_matvec.cu``, CUDA C++ for ``sm_90a``) replace the
Pallas TPU kernels of ``cholesky_is_magic_tpu/ops/dd_pallas.py``:

- :func:`dd_mv`  (``cim_dd_mv_f32``)  replaces ``_mv_kernel``, launched there
  by ``_dd_mv_partials``: A·x in double-word, one block per row, the row's
  sum finished inside the kernel;
- :func:`dd_rmv` (``cim_dd_rmv_f32``) replaces ``_rmv_kernel``, launched
  there by ``_dd_rmv_partials``: Aᵀ·x in double-word, reading row-major A
  without a transpose copy; row slabs write (slabs, n) partials that a
  second small kernel combines with ``dd_add``.

What bounds them on the H100: every 4-byte element of A costs ~10 flops
(error-free product + compensated accumulation), far below the card's
flop-to-byte balance, so both are bound by device-memory bandwidth; their
design reads A exactly once with coalesced loads (see the .cu file).

The plain version of both is ``ops.dd._dd_matvec_plain`` (on ``A.T`` for
Aᵀ·x).  The results agree with it to a few f32-eps² of Σ|aᵢⱼxⱼ| per row,
not bit for bit: the summation order differs.

The library is built at first use with ``nvcc`` into
``build/cim_torch_kernels/`` at the repository root, named by a hash of the
sources and flags, so an edited source rebuilds; it is loaded with
``ctypes``.  Importing this module needs no CUDA toolkit.  ``LAUNCHES``
counts the wrapper calls that launched a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

LAUNCHES = {"mv": 0, "rmv": 0}

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cim_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)
RMV_THREADS = 256  # kRmvThreads in the .cu file

_lib = None


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """The library's path, keyed by a hash of the sources and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcim_dd_{h.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    """nvcc from ``CUDA_HOME``, ``/usr/local/cuda/bin`` or ``PATH``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for cand in candidates:
        if cand.is_file() and os.access(cand, os.X_OK):
            return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the double-word CUDA kernels are built from "
        f"{CSRC_DIR} at first use and need the CUDA toolkit"
    )


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.
    nvcc's output (``-Xptxas=-v``: registers, spills) is kept beside it
    in a ``.log`` file."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.cim_dd_mv_f32.argtypes = [p, p, p, p, i, i, ll, p]
        lib.cim_dd_mv_f32.restype = i
        lib.cim_dd_rmv_f32.argtypes = [p, p, p, p, p, p, i, i, ll, i, i, p]
        lib.cim_dd_rmv_f32.restype = i
        _lib = lib
    return _lib


def _check(A: torch.Tensor, x: torch.Tensor, k: int, name: str) -> None:
    if not (A.is_cuda and x.is_cuda):
        raise ValueError(f"{name} takes CUDA tensors")
    if A.device != x.device:
        raise ValueError(f"{name}: A on {A.device}, x on {x.device}")
    if A.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 (got {A.dtype}, {x.dtype})")
    if A.dim() != 2 or x.dim() != 1 or x.shape[0] != A.shape[k]:
        raise ValueError(
            f"{name}: shapes {tuple(A.shape)} and {tuple(x.shape)} do not match"
        )
    if not (A.is_contiguous() and x.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def rmv_slabs(m: int, n: int, sms: int) -> tuple[int, int]:
    """(slabs, rows_per_slab) for Aᵀ·x: enough row slabs that the grid has
    ~4 blocks per SM, each slab at least 32 rows, at most 65535 slabs."""
    col_blocks = -(-n // RMV_THREADS)
    want = max(1, -(-4 * sms // col_blocks))
    slabs = max(1, min(want, -(-m // 32), 65535))
    rows = -(-m // slabs)
    return -(-m // rows), rows


def dd_mv(A: torch.Tensor, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A·x in double-word on the card: (hi, lo), each (m,) f32."""
    _check(A, x, 1, "dd_mv")
    m, n = A.shape
    hi = torch.empty(m, dtype=torch.float32, device=A.device)
    lo = torch.empty(m, dtype=torch.float32, device=A.device)
    if m == 0:
        return hi, lo
    lib = _load()
    stream = torch.cuda.current_stream(A.device).cuda_stream
    LAUNCHES["mv"] += 1
    _raise_on(lib.cim_dd_mv_f32(A.data_ptr(), x.data_ptr(), hi.data_ptr(),
                                lo.data_ptr(), m, n, A.stride(0), stream),
              "dd_mv")
    return hi, lo


def dd_rmv(A: torch.Tensor, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Aᵀ·x in double-word on the card, reading A row-major: (hi, lo),
    each (n,) f32."""
    _check(A, x, 0, "dd_rmv")
    m, n = A.shape
    if m == 0 or n == 0:
        zero = torch.zeros(n, dtype=torch.float32, device=A.device)
        return zero, zero.clone()
    sms = torch.cuda.get_device_properties(A.device).multi_processor_count
    slabs, rows = rmv_slabs(m, n, sms)
    hi = torch.empty(n, dtype=torch.float32, device=A.device)
    lo = torch.empty(n, dtype=torch.float32, device=A.device)
    part = torch.empty((2, slabs, n), dtype=torch.float32, device=A.device)
    lib = _load()
    stream = torch.cuda.current_stream(A.device).cuda_stream
    LAUNCHES["rmv"] += 1
    _raise_on(lib.cim_dd_rmv_f32(A.data_ptr(), x.data_ptr(), hi.data_ptr(),
                                 lo.data_ptr(), part[0].data_ptr(),
                                 part[1].data_ptr(), m, n, A.stride(0),
                                 slabs, rows, stream),
              "dd_rmv")
    return hi, lo
