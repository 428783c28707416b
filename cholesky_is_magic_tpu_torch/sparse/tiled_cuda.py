"""Launch the hand-written Hopper pair-schedule assembly kernel.

The kernel (``csrc/assemble_pairs.cu``, CUDA C++ for ``sm_90a``) replaces
the Pallas TPU kernel ``benchmarks/explore_prefetch_assembly.py`` ``kernel``
(launched there by ``pallas_onehot_k``): the kernel form of the tile
engine's ``assemble_pairs``, which builds the resident (b, b) tiles of
P·A·D²·Aᵀ·Pᵀ from the sorted pair schedule.  One thread sums one run of
pairs that share a destination, in schedule order, so the result is
deterministic; a grid-stride pass writes the zeros and the boosted
diagonal first.  What bounds it on the H100: the bytes of the pair arrays,
read once (see the .cu file).

The plain version is ``sparse.tiled.TiledCholesky._assemble_pairs_plain``
(``index_add_`` of w·d²[k], then the boost).  ``LAUNCHES`` counts the
kernel launches.
"""

from __future__ import annotations

from ctypes import c_int as _I
from ctypes import c_longlong as _LL
from ctypes import c_void_p as _P

import torch

from cholesky_is_magic_tpu_torch.ops import cuda_build

LAUNCHES = {"assemble_pairs": 0}

_SIGNATURES = {
    "cim_assemble_pairs_f32": [_P, _LL, _I, _P, _P, _P, _LL, _P, _P, _P, _P,
                               _P, _LL, _P],
}


def assemble_pairs(eng, d: torch.Tensor, row_boost: torch.Tensor) -> torch.Tensor:
    """The (NT+1, b, b) resident tiles of the engine ``eng``'s normal
    matrix for the column scaling ``d`` (f32, on the card) and the boost
    ``row_boost`` of the first len(row_boost) permuted rows (the other
    slots get 1)."""
    if not (d.is_cuda and eng.asm_w.is_cuda and row_boost.is_cuda):
        raise ValueError("assemble_pairs takes CUDA tensors")
    if d.dtype != torch.float32 or eng.asm_w.dtype != torch.float32:
        raise TypeError(f"assemble_pairs takes float32 (got {d.dtype}, "
                        f"{eng.asm_w.dtype})")
    if d.dim() != 1 or not d.is_contiguous():
        raise ValueError("assemble_pairs: d must be a contiguous vector")
    rb = row_boost.to(torch.float32).contiguous()
    b, NT = eng.b, eng.NT
    tiles = torch.empty((NT + 1, b, b), dtype=torch.float32, device=d.device)
    lib = cuda_build.load(_SIGNATURES)
    LAUNCHES["assemble_pairs"] += 1
    cuda_build.raise_on(
        lib.cim_assemble_pairs_f32(
            tiles.data_ptr(), tiles.numel(), b, eng.diag_panel.data_ptr(),
            eng.pperm.data_ptr(), rb.data_ptr(), rb.shape[0],
            eng.asm_w.data_ptr(), eng.asm_k.data_ptr(), d.data_ptr(),
            eng.asm_run_start.data_ptr(), eng.asm_run_dst.data_ptr(),
            eng.asm_run_dst.shape[0],
            torch.cuda.current_stream(d.device).cuda_stream),
        "assemble_pairs")
    return tiles
