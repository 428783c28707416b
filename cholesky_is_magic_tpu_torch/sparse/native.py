"""ctypes bridge to the native symbolic kernels (native/symbolic.cpp).

A copy of the JAX package's ``sparse/native.py`` for the port (importing
that one would load JAX through its package): it loads the same ``native/libcimsymbolic.so``
at the repository root, running ``make -C native`` first, so the library
is built at first use.  Everything degrades to the pure-Python
implementations in sparse.symbolic when the library is missing and cannot
be built (no compiler, read-only checkout, ...).  Host code only.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np
import scipy.sparse as sp

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libcimsymbolic.so")

_lib = None
_load_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    # Always invoke make: a no-op when the .so is current, a rebuild when
    # symbolic.cpp changed (an exists-check would keep loading a stale lib).
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR, "-s"],
            check=True,
            capture_output=True,
            timeout=120,
        )
    except Exception:
        pass  # read-only checkout / no compiler: try the existing .so
    if not os.path.exists(_LIB_PATH):
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        _load_failed = True
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_ubyte)
    lib.cim_etree.argtypes = [ctypes.c_int64, i64p, i64p, i64p]
    lib.cim_postorder.argtypes = [ctypes.c_int64, i64p, i64p]
    lib.cim_colcounts.argtypes = [
        ctypes.c_int64, i64p, i64p, i64p, i64p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
    ]
    lib.cim_amd.argtypes = [ctypes.c_int64, i64p, i64p, i64p]
    lib.cim_amd.restype = ctypes.c_int64
    lib.cim_block_mask.argtypes = [
        ctypes.c_int64, i64p, i64p, i64p, ctypes.c_int64, u8p,
    ]
    if hasattr(lib, "cim_block_mask_slots"):  # older .so may lack it
        lib.cim_block_mask_slots.argtypes = [
            ctypes.c_int64, i64p, i64p, i64p, ctypes.c_int64, i64p,
            ctypes.c_int64, u8p,
        ]
    if hasattr(lib, "cim_pair_schedule"):  # older .so may lack it
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.cim_pair_schedule.argtypes = [
            ctypes.c_int64, i64p, i64p, f64p, i64p, ctypes.c_int64, i64p,
            ctypes.c_int64, f64p, i64p, i64p,
        ]
        lib.cim_pair_schedule.restype = ctypes.c_int64
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _csc_arrays(N: sp.spmatrix):
    C = sp.csc_matrix(N)
    C.sort_indices()
    indptr = np.ascontiguousarray(C.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(C.indices, dtype=np.int64)
    return C.shape[0], indptr, indices


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def amd_order(N: sp.spmatrix) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    n, indptr, indices = _csc_arrays(N)
    perm = np.empty(n, dtype=np.int64)
    rc = lib.cim_amd(n, _ptr(indptr), _ptr(indices), _ptr(perm))
    return perm if rc == 0 else None


def elimination_tree(N: sp.spmatrix) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    n, indptr, indices = _csc_arrays(N)
    parent = np.empty(n, dtype=np.int64)
    lib.cim_etree(n, _ptr(indptr), _ptr(indices), _ptr(parent))
    return parent


def postorder(parent: np.ndarray) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    parent = np.ascontiguousarray(parent, dtype=np.int64)
    post = np.empty(len(parent), dtype=np.int64)
    lib.cim_postorder(len(parent), _ptr(parent), _ptr(post))
    return post


def column_counts(N: sp.spmatrix, parent: np.ndarray):
    lib = _load()
    if lib is None:
        return None
    n, indptr, indices = _csc_arrays(N)
    parent = np.ascontiguousarray(parent, dtype=np.int64)
    counts = np.empty(n, dtype=np.int64)
    nnz = ctypes.c_int64()
    flops = ctypes.c_double()
    lib.cim_colcounts(
        n, _ptr(indptr), _ptr(indices), _ptr(parent), _ptr(counts),
        ctypes.byref(nnz), ctypes.byref(flops),
    )
    return counts, int(nnz.value), float(flops.value)


def block_mask_slots(
    N: sp.spmatrix, parent: np.ndarray, block: int, slots: np.ndarray, B: int
):
    lib = _load()
    if lib is None or not hasattr(lib, "cim_block_mask_slots"):
        return None
    n, indptr, indices = _csc_arrays(N)
    parent = np.ascontiguousarray(parent, dtype=np.int64)
    slots = np.ascontiguousarray(slots, dtype=np.int64)
    mask = np.zeros((B, B), dtype=np.uint8)
    lib.cim_block_mask_slots(
        n, _ptr(indptr), _ptr(indices), _ptr(parent), block, _ptr(slots), B,
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    return mask.astype(bool)


def pair_schedule(
    A_csc: sp.csc_matrix,
    slot_of: np.ndarray,
    b: int,
    tilemap: np.ndarray,
):
    """Assembly pair schedule (see cim_pair_schedule / TiledCholesky.
    build_ell_assembly).  Returns (ws, ks, dst) unsorted, or None when the
    native library is unavailable.  Raises if a pair lands outside the
    resident tile set (mirrors the Python path's assertion)."""
    lib = _load()
    if lib is None or not hasattr(lib, "cim_pair_schedule"):
        return None
    C = sp.csc_matrix(A_csc)
    C.sort_indices()
    indptr = np.ascontiguousarray(C.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(C.indices, dtype=np.int64)
    data = np.ascontiguousarray(C.data, dtype=np.float64)
    slot_of = np.ascontiguousarray(slot_of, dtype=np.int64)
    tilemap = np.ascontiguousarray(tilemap, dtype=np.int64)
    B = tilemap.shape[0]
    nnz_k = np.diff(indptr)
    cap = int(2 * (nnz_k * (nnz_k + 1) // 2).sum())
    cap = max(cap, 1)
    ws = np.empty(cap, dtype=np.float64)
    ks = np.empty(cap, dtype=np.int64)
    dst = np.empty(cap, dtype=np.int64)
    cnt = lib.cim_pair_schedule(
        C.shape[1], _ptr(indptr), _ptr(indices),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _ptr(slot_of), b, _ptr(tilemap), B,
        ws.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _ptr(ks), _ptr(dst),
    )
    if cnt < 0:
        raise AssertionError("N entry outside the resident tile set")
    return ws[:cnt], ks[:cnt], dst[:cnt]


def block_mask(N: sp.spmatrix, parent: np.ndarray, block: int):
    lib = _load()
    if lib is None:
        return None
    n, indptr, indices = _csc_arrays(N)
    parent = np.ascontiguousarray(parent, dtype=np.int64)
    B = (n + block - 1) // block
    mask = np.zeros((B, B), dtype=np.uint8)
    lib.cim_block_mask(
        n, _ptr(indptr), _ptr(indices), _ptr(parent), block,
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    return mask.astype(bool)
