"""The ('dp', 'tp') device mesh over the ranks of a process group.

Counterpart of ``cholesky_is_magic_tpu/parallel/mesh.py``.  The JAX package
lays its devices out as a ``jax.sharding.Mesh`` and runs one program over
it; here every rank of a ``torch.distributed`` process group runs the same
solver call (SPMD), and the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose two dims name the
process subgroups the collectives run on: 'tp' (a column-sharded LP's
all-reduces and all-gathers) and 'dp' (a batch's lanes).
"""

from __future__ import annotations

from typing import Optional


def lp_mesh(dp: Optional[int] = None, tp: Optional[int] = None,
            device_type: str = "cuda"):
    """A ('dp', 'tp') ``DeviceMesh`` over the ranks of the default process
    group, on ``device_type`` ("cuda" with NCCL, "cpu" with gloo).

    dp shards independent LPs (the batch), tp shards an LP's columns (the
    wide axis of A).  With only one factor given, the other takes all
    remaining ranks; with neither, everything goes to dp.  Every rank must
    make the same call (the mesh's subgroups are made collectively).  The
    process group is the caller's: this starts none and raises
    ``RuntimeError`` when none is initialized."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "lp_mesh needs an initialized torch.distributed process group "
            "(torch.distributed.init_process_group)")
    n = dist.get_world_size()
    if dp is None and tp is None:
        dp, tp = n, 1
    elif dp is None:
        if n % tp:
            raise ValueError(f"tp={tp} does not divide {n} ranks")
        dp = n // tp
    elif tp is None:
        if n % dp:
            raise ValueError(f"dp={dp} does not divide {n} ranks")
        tp = n // dp
    if dp * tp != n:
        raise ValueError(f"mesh {dp}x{tp} != {n} ranks")
    return init_device_mesh(device_type, (dp, tp), mesh_dim_names=("dp", "tp"))
