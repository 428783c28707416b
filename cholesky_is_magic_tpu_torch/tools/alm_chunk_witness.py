"""The inner APPROX loop on the card, its chunks replayed as a CUDA graph and
run eagerly, in turns.

    python -m cholesky_is_magic_tpu_torch.tools.alm_chunk_witness [--iters 320]

On the pilot-scale constructed LP (dense, 1536 x 5120 padded, f32) and the
m = 16384 one (``to_sparse_lp``, block-ELL), runs ``--iters`` inner
iterations (accuracy 0, so none stops early) of the f32 driver
(``solvers.approx._approx_jit``) and of the double-word one
(``_approx_dd``) on each LP's ALM subproblem, four times each in the order
eager, graph, graph, eager (``approx._GRAPHS``).  Prints each run's host-clock
ms per inner iteration (after ``torch.cuda.synchronize()``), the dd kernels'
launches, whether the graph's iterate, projected gradient and count equal
the eager loop's bit for bit, then the card's name and power limit, and a
last line of JSON.  Needs one CUDA card and nvcc; imports no jax.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import time

import torch

from cholesky_is_magic_tpu_torch.ingest.device import to_device_lp, to_sparse_lp
from cholesky_is_magic_tpu_torch.ops import dd as ddm
from cholesky_is_magic_tpu_torch.ops import dd_cuda
from cholesky_is_magic_tpu_torch.utils.precision import set_highest_precision
from cholesky_is_magic_tpu_torch.utils.testing import constructed_optimum_lp

# The module (the solvers package re-exports a function of its name).
am = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.approx")


def _runner(lp, dd: bool, iters: int):
    """A zero-argument run of ``iters`` inner iterations from x = 0 at
    lam = 0 (mu 10 for f32, 100 for dd); returns (z, pg, iterations)."""
    lam = torch.zeros_like(lp.b)
    mu = 100.0 if dd else 10.0
    prob = am.make_alm_subproblem(lp, lam, mu)
    zero = torch.zeros((), dtype=lp.c.dtype, device=lp.c.device)
    x0 = torch.zeros_like(lp.c)
    if dd:
        mu_t = torch.tensor(mu, dtype=lp.c.dtype, device=lp.c.device)

        def run():
            z, pg, it, _r, _ran = am._approx_dd(lp, prob, lam, mu_t, ddm.dd_from(x0),
                                                zero, iters)
            return torch.stack([z.hi, z.lo]), pg, it
    else:
        def run():
            res = am._approx_jit(prob, am.project_box(prob, x0), zero, iters)
            return res.x, res.pg, res.iterations
    return run


def _timed(run, graphs: bool):
    am._GRAPHS = graphs
    before = dict(dd_cuda.LAUNCHES)
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    took = time.perf_counter() - t
    return out, took, {k: v - before[k] for k, v in dd_cuda.LAUNCHES.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=320)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    set_highest_precision()
    psf, _ = constructed_optimum_lp("pilot", seed=0)
    ssf, _ = constructed_optimum_lp(m=16384, seed=0)
    lps = {"pilot dense": to_device_lp(psf, dtype=torch.float32, device="cuda"),
           "m = 16384 block-ELL": to_sparse_lp(ssf, dtype=torch.float32, device="cuda")}
    rows = []
    for name, lp in lps.items():
        for dd in (False, True):
            run = _runner(lp, dd, args.iters)
            run()  # warm-up: the kernels' build, cuBLAS, the allocator
            out = {}
            for turn, graphs in enumerate((False, True, True, False)):
                res, took, launches = _timed(run, graphs)
                ms = 1e3 * took / args.iters
                tag = "graph" if graphs else "eager"
                out.setdefault(tag, []).append((res, ms, launches))
                print(f"[{name} {'dd' if dd else 'f32'}] run {turn} {tag}: "
                      f"{ms:.4f} ms per inner iteration, launches {launches}",
                      flush=True)
            (e, _, el), (g, _, gl) = out["eager"][0], out["graph"][0]
            same = (torch.equal(e[0], g[0]) and torch.equal(e[1], g[1])
                    and int(e[2]) == int(g[2]) == args.iters)
            print(f"[{name} {'dd' if dd else 'f32'}] graph bit-equal to eager: {same};"
                  f" launches equal: {el == gl}", flush=True)
            rows.append(dict(lp=name, inner="dd" if dd else "f32",
                             eager_ms=[r[1] for r in out["eager"]],
                             graph_ms=[r[1] for r in out["graph"]],
                             bit_equal=same, launches=gl))
    am._GRAPHS = True
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    print(json.dumps({"iters": args.iters, "card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
