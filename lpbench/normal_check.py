#!/usr/bin/env python3
"""The tile engine's factor and solves at a cell's full size on the card,
held against the plain float64 normal equations
(:mod:`lpbench.normal_plain`), for the column scalings of lane 0's
own iterates:

    python3 lpbench/normal_check.py --workload qap15.fleet32 --seed <n> --iters 2,0

For each iteration count k (0: the whole solve), lane 0 of the cell's fleet
is solved alone on the cell's engine for k iterations (a lane of the batched
call takes the same iterates; the traced call runs 2) and the d and row
boost of its last factorization are kept.  On those the engine assembles,
factors (``TiledCholesky.factorize``: K4, then K1, TRSM and the Schur
updates per panel) and solves, raw and with the phase's refinement, and the
plain N is formed, in the engine's slot order for the factor.  One JSON line
per k: the numbers, each beside its tolerance, and whether all are within.

Tolerances (u = 6.0e-8, float32's unit roundoff):

- the factor's backward error ‖L Lᵀ − N‖_F / ‖N‖_F: 1e-5.  A Cholesky
  factor is backward stable; the error grows at most like sqrt(p)·u in
  practice (p = 6656 slots at QAP15: 4.9e-6), and reads one to two u at
  p <= 384 on the CPU (``tests/test_torch_qap_relaxation.py``);
- a solve's residual error ‖N y − g‖₂ / (‖N‖_F ‖y‖₂ + ‖g‖₂): 1e-6, the
  factor's tolerance less the sqrt(p) (triangular solves are backward
  stable and read under u on the CPU);
- a solve's forward error against the plain solve: cond₂(N) times 1e-6.

Beside them, ``factor_backward_tf32``: the engine's factor rounded to TF32,
the next precision below float32, whose backward error (about 2^-11) the
factor's tolerance refuses.

It needs the card; ``check_one`` runs on a CPU driver too, at a small size.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FACTOR_TOL, SOLVE_TOL = 1e-5, 1e-6


def _captured(drv, engine, st0, iters: int):
    """(d, row boost) of lane 0's last factorization after ``iters``
    iterations alone on ``engine`` (0: the whole solve), and its result."""
    from lpbench.program import mod, pdas_config

    tiled = mod("sparse.tiled")
    seen = []
    original = tiled.TiledCholesky.prepare_normal_ell

    def keep(self, E, ET, d, m, row_boost=None, **kw):
        seen.append((d.detach().clone(), None if row_boost is None
                     else row_boost.detach().clone()))
        return original(self, E, ET, d, m, row_boost=row_boost, **kw)

    tiled.TiledCholesky.prepare_normal_ell = keep
    try:
        res = mod("solvers.pdas").pdas(st0, pdas_config(drv.phases[0], iters or None),
                                      engine=engine)
    finally:
        tiled.TiledCholesky.prepare_normal_ell = original
    return seen[-1], res


def _dense(eng, L):
    import torch

    b = eng.b
    out = torch.zeros((eng.B * b, eng.B * b), dtype=L.dtype, device=L.device)
    for t, (i, j) in enumerate(eng.tiles):
        out[i * b:(i + 1) * b, j * b:(j + 1) * b] = L[t]
    return out


def check_one(drv, engine, st0, iters: int, seed: int) -> dict:
    import numpy as np
    import torch

    from lpbench import normal_plain as plain
    from lpbench.program import mod, sync
    from lpbench.readings import round_to_tf32

    (d, boost), res = _captured(drv, engine, st0, iters)
    lp = st0.lp
    m = lp.m
    boost = torch.zeros(m, dtype=d.dtype, device=d.device) if boost is None else boost
    f = drv.fleet
    vals, _ = mod("ingest.standard_form").scale_constraints(
        f.rows.astype(np.int32), f.vals, f.b[0])
    t = time.perf_counter()
    tiles = engine.assemble_pairs(d, boost)
    L, invd, ok = engine.factorize(tiles)
    sync(drv.device)
    t_factor = time.perf_counter() - t
    d64, boost64 = d.double().cpu().numpy(), boost.double().cpu().numpy()
    N_slot = plain.normal_matrix(f.rows, f.cols, vals, m, d64, boost64,
                                 perm=engine.pperm.cpu().numpy(), device=d.device)
    L_dense = _dense(engine, L)
    out = {"iters": iters, "lane0_iterations": int(res.iterations), "ok": bool(ok),
           "d_min": float(d.min()), "d_max": float(d.max()), "factor_s": t_factor,
           "factor_backward": plain.backward_error(N_slot, L_dense),
           "factor_backward_tf32": plain.backward_error(
               N_slot, round_to_tf32(L_dense.cpu().numpy()))}
    del N_slot
    N = plain.normal_matrix(f.rows, f.cols, vals, m, d64, boost64, device=d.device)
    ev = torch.linalg.eigvalsh(N)
    cond = float(ev[-1] / ev[0])
    g = torch.as_tensor(np.random.default_rng(seed).standard_normal(m),
                        dtype=d.dtype, device=d.device)
    want = plain.solve(plain.factor(N), g.double())
    out["cond"] = cond
    for steps in (0, drv.phases[0].get("config", {}).get("refine_steps", 2)):
        y, _ = engine.solve_normal_ell(lp.E, lp.ET, d, g, row_boost=boost,
                                       refine_steps=steps, EB=lp.EB, ETB=lp.ETB)
        out[f"solve{steps}_residual"] = plain.residual_error(N, y, g)
        out[f"solve{steps}_forward"] = float(torch.linalg.norm(y.double() - want)
                                             / torch.linalg.norm(want))
    within = out["ok"] and out["factor_backward"] <= FACTOR_TOL and all(
        out[k] <= SOLVE_TOL for k in out if k.endswith("_residual")) and all(
        out[k] <= cond * SOLVE_TOL for k in out if k.endswith("_forward"))
    out.update(tolerances={"factor_backward": FACTOR_TOL, "residual": SOLVE_TOL,
                           "forward": f"cond * {SOLVE_TOL}"}, within=bool(within))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--iters", default="2,0", help="iteration counts, 0 the whole solve")
    args = ap.parse_args()

    from lpbench.drive import Driver
    from lpbench.harness import HERE, card_line, load_json
    from lpbench.program import mod, standard_forms

    spec = load_json(HERE.parent / "BENCHMARK.json")
    cell = {w["name"]: w for w in spec["workloads"]}[args.workload]
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = dict(load_json(HERE / "traffic" / f"{cell['traffic']}.json"), lanes=1)
    if traffic["entry"] != "sparse_fleet":
        raise SystemExit("normal_check: a cell of the tile engine (entry sparse_fleet)")
    print(f"[device] nvidia-smi name, power limit: {card_line()}", file=sys.stderr)
    drv = Driver(config, traffic, args.seed, "cuda")
    st0, engine = mod("solvers.pdas").make_pdas_sparse(
        standard_forms(drv.fleet)[0], block=traffic["block"], dtype=drv.dtype,
        device="cuda")
    for k in [int(v) for v in args.iters.split(",")]:
        print(json.dumps(check_one(drv, engine, st0, k, args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
