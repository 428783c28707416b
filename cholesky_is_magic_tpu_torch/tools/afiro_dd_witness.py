"""Dense afiro in f32 on the card, with the double-word products by the
kernels and by their plain versions.

    python -m cholesky_is_magic_tpu_torch.tools.afiro_dd_witness [--runs 2]

Solves ``tests/fixtures/afiro.mps`` by ``solve(..., "pdas_dd",
device="cuda", dtype=torch.float32)`` (``chip_smoke.py``'s phase 4) three
ways, each ``--runs`` times: both dd kernels (``dd_cuda.dd_mv`` and
``dd_rmv``); dd A·x by its plain version (``ops.dd._dd_matvec_plain``) and
Aᵀ·x by its kernel; both by the plain version.  Prints each run's phase-1
and phase-2 iterations, gap and objective error against the published
optimum, then the card's name and power limit.  The f32 phase 1 of
unscaled afiro is sensitive to the last bits of its products, so this
shows which iteration counts the kernels' summation order gives and which
the plain one does.  Needs one CUDA card and nvcc; imports no jax.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
from pathlib import Path

import torch

import cholesky_is_magic_tpu_torch as cimt
from cholesky_is_magic_tpu_torch.ops import dd, dd_cuda

AFIRO = Path(__file__).resolve().parents[2] / "tests" / "fixtures" / "afiro.mps"
AFIRO_OPTIMUM = -464.75314285714285


@contextlib.contextmanager
def plain(mv: bool, rmv: bool):
    """dd_cuda's wrappers replaced by the plain version where asked."""
    saved = dd_cuda.dd_mv, dd_cuda.dd_rmv
    if mv:
        dd_cuda.dd_mv = lambda A, x: tuple(dd._dd_matvec_plain(A, x))
    if rmv:
        dd_cuda.dd_rmv = lambda A, x: tuple(dd._dd_matvec_plain(A.T, x))
    try:
        yield
    finally:
        dd_cuda.dd_mv, dd_cuda.dd_rmv = saved


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    ways = {"both kernels": (False, False), "A·x plain, Aᵀ·x kernel": (True, False),
            "both plain": (True, True)}
    for name, (mv, rmv) in ways.items():
        for run in range(args.runs):
            with plain(mv, rmv):
                rep = cimt.solve(str(AFIRO), "pdas_dd", device="cuda", dtype=torch.float32)
            err = abs(rep.objective - AFIRO_OPTIMUM) / abs(AFIRO_OPTIMUM)
            print(f"[afiro] {name}, run {run}: status {rep.status}, iterations "
                  f"{rep.summary['phase1_iterations']} + {rep.summary['iterations']},"
                  f" gap {rep.summary['gap']:.3e}, objective error {err:.3e}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[afiro] card, power limit: {smi.stdout.strip()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
