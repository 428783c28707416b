"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled with ``nvcc`` for ``sm_90a`` at the
first CUDA call, one ``nvcc -c`` per source, all started together, and the
objects are linked into one shared library with a plain C interface, loaded
with ``ctypes``.  The library lives in ``build/cim_torch_kernels/`` at the
repository root, named by a hash of the sources and flags, so an edited
source rebuilds.  nvcc's ``-Xptxas=-v`` output (registers, shared memory,
spills) is kept in a ``.log`` file beside it.  Importing this module needs
no CUDA toolkit.

``--fmad=false`` keeps nvcc from contracting the double-word kernels'
error-free transformations; kernels that want a fused multiply-add say so
with an explicit ``__fmaf_rn``.

The wrappers (:mod:`.dd_cuda`, :mod:`.chol_cuda`,
:mod:`..sparse.tiled_cuda`) call :func:`load` with the ctypes signatures of
their own entry points.  The dispatchers in front of them ask
:func:`takes_kernel` which operands go to a kernel at all.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cim_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC",
)

_lib = None
_declared: set[str] = set()


def takes_kernel(device: torch.device, *dtypes: torch.dtype) -> bool:
    """Whether operands on ``device`` of these dtypes go to a hand-written
    kernel: a CUDA device and float32 throughout, as the kernels are written.
    Anything else takes the plain PyTorch form on its own device, as the JAX
    package sends non-f32 operands to its XLA form
    (``ops/dd_pallas.py`` ``_tiles``).  The dispatchers ask this before any
    launch; it is a route chosen from the operands, never a fallback."""
    return device.type == "cuda" and all(dt == torch.float32 for dt in dtypes)


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """The library's path, keyed by a hash of the sources and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcim_kernels_{h.hexdigest()[:16]}.so"


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
        "PATH): the CUDA kernels are built from "
        f"{CSRC_DIR} at first use and need the CUDA toolkit"
    )


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            for src, obj in zip(sources(), objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outputs = [p.communicate()[0] for p in procs]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    log = [" ".join(c) + "\n" + o for c, o in zip(cmds, outputs)]
    failed = [(c, o) for c, o, p in zip(cmds, outputs, procs) if p.returncode]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode:
            failed.append((link, proc.stdout + proc.stderr))
    out.with_suffix(".log").write_text("".join(log))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        cmd, text = failed[0]
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{text}")
    os.replace(tmp, out)
    return out


def load(signatures: dict | None = None) -> ctypes.CDLL:
    """The built library.  ``signatures`` maps entry points to their ctypes
    argument types (pointers and the stream as ``c_void_p``); each is
    declared once, returning ``c_int``."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    for name, argtypes in (signatures or {}).items():
        if name not in _declared:
            fn = getattr(_lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _declared.add(name)
    return _lib


def raise_on(err: int, name: str) -> None:
    """Raise if a C entry point reported a launch error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
