"""The command line: solve an MPS file with any of the solver families.

Counterpart of ``cholesky_is_magic_tpu/__main__.py``: every flag keeps its
name, default and meaning, and ``--device`` (default ``cuda``) says where
to solve.  A thin shell over :func:`cholesky_is_magic_tpu_torch.api.solve`:

    python -m cholesky_is_magic_tpu_torch problem.mps --solver pdas_dd
    python -m cholesky_is_magic_tpu_torch problem.mps --solver pdas_dd --sparse --block 128
    python -m cholesky_is_magic_tpu_torch problem.mps --solver alm --f64 --device cpu
    python -m cholesky_is_magic_tpu_torch problem.mps --report   # symbolic stats
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cholesky_is_magic_tpu_torch")
    ap.add_argument("mps", help="path to an MPS file")
    ap.add_argument(
        "--solver",
        choices=["affine", "pdas", "pdas_dd", "alm", "aalm", "selfdual"],
        default="pdas",
        help="pdas_dd = two-phase tight-gap flow: pdas to feasibility at "
             "its 1e-4 gap, then the double-word finisher to 1e-8+",
    )
    ap.add_argument("--f64", action="store_true", help="solve in float64")
    ap.add_argument("--sparse", action="store_true",
                    help="fully sparse pipeline (ELL operands + pair-schedule "
                         "tile engine; affine/pdas/pdas_dd) — no dense A on device")
    ap.add_argument("--block", type=int, default=128,
                    help="tile width for the sparse engine")
    ap.add_argument("--rescale", action="store_true", help="row-equilibrate (rescale-sf)")
    ap.add_argument("--presolve", action="store_true",
                    help="host-side safe reductions before padding "
                         "(fixed/singleton/empty elimination, ingest.presolve)")
    ap.add_argument("--max-iters", type=int, default=500)
    ap.add_argument("--refine-steps", type=int, default=1)
    ap.add_argument("--krylov-steps", type=int, default=0,
                    help="PCG refinement steps (ill-conditioned end-games)")
    ap.add_argument("--krylov-gate-gap", type=float, default=0.0,
                    help="with --krylov-steps: run cheap Richardson "
                         "refinement until the gap drops below this, then "
                         "switch to PCG (speed/accuracy knob)")
    ap.add_argument("--mehrotra", action="store_true",
                    help="predictor-corrector steps (pdas/pdas_dd): ~half "
                         "the iterations for one extra solve per iteration")
    ap.add_argument("--crossover", action="store_true",
                    help="polish the final iterate to a certified "
                         "vertex-exact solution (one extra factorization; "
                         "pdas/pdas_dd)")
    ap.add_argument("--entry-repair-tol", type=float, default=0.0,
                    help="pdas_dd: min-norm-repair the finisher entry "
                         "toward Ax=b when its relative infeasibility "
                         "exceeds this (recommended 1e-6 at scale; 0 off)")
    ap.add_argument("--pad", type=int, default=128, help="padding multiple")
    ap.add_argument("--report", action="store_true", help="print the symbolic factorization report")
    ap.add_argument("--trace", action="store_true",
                    help="print per-iteration trace lines (the reference's stdout trace)")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument("--device", default="cuda",
                    help="where to solve: the card (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    import cholesky_is_magic_tpu_torch as cimt
    from cholesky_is_magic_tpu_torch.api import _check_device, solve

    _check_device(args.device, "cholesky_is_magic_tpu_torch")
    dtype = torch.float64 if args.f64 else torch.float32
    on_card = torch.device(args.device).type == "cuda"

    sf = cimt.to_standard_form(cimt.read_mps_file(args.mps))

    if args.report:
        import scipy.sparse as sp

        from cholesky_is_magic_tpu_torch.sparse import analyze
        from cholesky_is_magic_tpu_torch.utils import diag

        A = sp.csc_matrix(
            (sf.a_vals, (sf.a_rows, sf.a_cols)), shape=(sf.ncons, sf.nvars)
        )
        print(diag.factor_report(analyze(A, block=args.pad)))

    def print_trace(series: dict, iters: int) -> None:
        """The reference's per-iteration stdout lines (e.g.
        one-pdas-iteration :336-338), replayed from the recorded buffers."""
        host = {k: v.cpu().numpy() for k, v in series.items()}
        # Sorted, as the JAX package's buffers come out of jit.
        keys = sorted(k for k, v in host.items() if v.ndim == 1)
        for i in range(iters):
            cells = "  ".join(f"{k}={float(host[k][i]):.6g}" for k in keys)
            print(f"iter {i:4d}  {cells}")

    def wall_seconds() -> float:
        if on_card:
            torch.cuda.synchronize()
        return round(time.time() - t0, 3)

    t0 = time.time()
    report = solve(
        sf,
        solver=args.solver,
        device=args.device,
        sparse=args.sparse,
        dtype=dtype,
        rescale=args.rescale,
        pad_multiple=args.pad,
        block=args.block,
        max_iters=args.max_iters,
        refine_steps=args.refine_steps,
        krylov_steps=args.krylov_steps,
        krylov_gate_gap=args.krylov_gate_gap,
        mehrotra=args.mehrotra,
        crossover=args.crossover,
        entry_repair_tol=args.entry_repair_tol,
        record_trace=args.trace,
        presolve=args.presolve,
    )
    res = report.result
    if res is None:  # presolve decided infeasible/unbounded/solved
        out = dict(report.summary)
        out["solver"] = args.solver
        out["wall_seconds"] = wall_seconds()
        print(json.dumps(out) if args.json else
              "\n".join(f"{k:>16}: {v}" for k, v in out.items()))
        return 0
    if args.trace:
        if args.solver in ("alm", "aalm"):
            print_trace(res.trace, int(res.outer_iterations))
        else:
            print_trace(res.extra["trace"], int(res.iterations))

    out = dict(report.summary)
    if "objective" in out and sf.obj_sign != 1.0:
        # OBJSENSE MAX: "objective" above is the minimized standard-form
        # value (c negated); report the true maximized objective too.
        out["original_objective"] = sf.obj_sign * out["objective"]
    out["wall_seconds"] = wall_seconds()
    out["solver"] = args.solver

    if args.json:
        print(json.dumps(out))
    else:
        for k, v in out.items():
            print(f"{k:>16}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
