"""Sparse affine scaling on the card, with the tile factor (K1) and the
assembly (K4) by their kernels and by their plain versions.

    python -m cholesky_is_magic_tpu_torch.tools.affine_route_witness [--f64]

(``--m 2048 8192 16384`` and ``--runs 2`` by default.)

Solves ``constructed_optimum_lp(m, seed=0)`` by ``solve(..., "affine",
sparse=True, block=128, device="cuda", dtype=torch.float32)``
(``chip_smoke.py``'s phase 11) four ways: both kernels; K1 by its plain
version (``ops.chol``'s route forced plain); K4 by its plain version
(``sparse.tiled``'s route forced plain); both plain.  Both kernels and both
plain run ``--runs`` times.  With ``--f64`` it solves once more in float64
(the plain forms on the card).  Prints each run's iterations, repair steps
(iterations that start with ||b - A·x|| > 1e-6·m), objective error against
the optimum known by construction, both kernels' launches, wall-clock and
the objective error by iteration, then the card's name and power limit.
The f32 end game alternates optimize and repair steps until an optimize
step reads g·c > 0 in rounding noise, so this shows whether the kernels
set its count.  Needs one CUDA card and nvcc; imports no jax.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import time

import torch

import cholesky_is_magic_tpu_torch as cimt
from cholesky_is_magic_tpu_torch.ops import chol, chol_cuda
from cholesky_is_magic_tpu_torch.sparse import tiled, tiled_cuda
from cholesky_is_magic_tpu_torch.utils.precision import set_highest_precision
from cholesky_is_magic_tpu_torch.utils.testing import constructed_optimum_lp


@contextlib.contextmanager
def plain(k1: bool, k4: bool):
    """The tile factor's and the assembly's routes forced to their plain
    versions where asked."""
    saved = chol.takes_kernel, tiled.takes_kernel
    if k1:
        chol.takes_kernel = lambda *a: False
    if k4:
        tiled.takes_kernel = lambda *a: False
    try:
        yield
    finally:
        chol.takes_kernel, tiled.takes_kernel = saved


def _solve(sf, ref, m, dtype):
    for counts in (chol_cuda.LAUNCHES, tiled_cuda.LAUNCHES):
        for k in counts:
            counts[k] = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    rep = cimt.solve(sf, "affine", sparse=True, block=128, device="cuda",
                     dtype=dtype, record_trace=True)
    torch.cuda.synchronize()
    took = time.perf_counter() - t
    k = rep.summary["iterations"]
    trace = {key: v[:k].double().cpu() for key, v in rep.result.extra["trace"].items()}
    repairs = int((trace["residual"] > 1e-6 * m).sum())
    err = abs(rep.objective - ref) / abs(ref)
    launches = (chol_cuda.LAUNCHES["potrf_tile"], tiled_cuda.LAUNCHES["assemble_pairs"])
    by_iter = " ".join(f"{abs(o - ref) / abs(ref):.1e}" for o in trace["objective"].tolist())
    return (f"{rep.status}, {k} iterations, {repairs} repair steps, objective error "
            f"{err:.3e}, launches K1 {launches[0]} K4 {launches[1]}, {took:.2f} s\n"
            f"    objective error by iteration: {by_iter}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, nargs="+", default=[2048, 8192, 16384])
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--f64", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    set_highest_precision()
    ways = [("both kernels", False, False, args.runs), ("K1 plain", True, False, 1),
            ("K4 plain", False, True, 1), ("both plain", True, True, args.runs)]
    for m in args.m:
        sf, info = constructed_optimum_lp(m=m, seed=0)
        for name, k1, k4, runs in ways:
            for run in range(runs):
                with plain(k1, k4):
                    line = _solve(sf, info["objective"], m, torch.float32)
                print(f"[affine m={m}] f32 {name}, run {run}: {line}", flush=True)
        if args.f64:
            line = _solve(sf, info["objective"], m, torch.float64)
            print(f"[affine m={m}] f64: {line}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[affine] card, power limit: {smi.stdout.strip()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
