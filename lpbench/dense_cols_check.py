#!/usr/bin/env python3
"""The tile engine with dense columns set apart, at a cell's full size on the
card, held against the plain float64 normal equations
(:mod:`lpbench.normal_plain`) formed whole, dense columns included, for the
column scalings of lane 0's own iterates:

    python3 lpbench/dense_cols_check.py --workload lands.saa64 --seed <n> --iters 2,0

As ``lpbench/normal_check.py`` does, lane 0 of the cell's fleet is solved
alone on the cell's engine for k iterations (0: the whole solve) and the d
and row boost of its last factorization are kept.  On those the engine
assembles and factors N_s (A's other columns) and forms its dense columns'
part (``TiledCholesky.factorize(..., d=d)``), then solves raw and with the
phase's refinement; the plain N_s is formed in the engine's slot order for
the factor, and the plain whole N for the solves.  One JSON line per k.

Tolerances (u = 6.0e-8, float32's unit roundoff), with their reasons:

- N_s's factor, backward error ‖L Lᵀ − N_s‖_F / ‖N_s‖_F: 1e-5, as
  ``normal_check.py`` holds a factor (a Cholesky factor is backward stable;
  the error grows at most like sqrt(p)·u in practice, 1.1e-5 at p = 35072
  slots, and reads one to two u on the CPU, ``tests/test_torch_dense_cols.py``);
- a refined solve's residual error against the whole N, ‖N y − g‖₂ / (‖N‖_F
  ‖y‖₂ + ‖g‖₂): 1e-6, the factor's tolerance less the sqrt(p) (the
  corrections' triangular solves and the k × k factor are backward stable,
  and the refinement runs against the whole operator);
- the raw solve's residual error: reported beside it, not compared (the
  refinement is what the solver hands on);
- a solve's forward error against the plain solve: cond₂(N) times 1e-6,
  cond₂ from 100 steps of power iteration on N and on N⁻¹ (the plain
  factor's solves), which reach the extreme eigenvalues from inside, so the
  estimate is low and the tolerance tighter than with the true cond₂.

Beside them, ``factor_backward_tf32``: N_s's factor rounded to TF32, the next
precision below float32, whose backward error (about 2^-11) the factor's
tolerance refuses.

It needs the card; ``check_one`` runs on the CPU too, at a small size.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from lpbench.normal_check import FACTOR_TOL, SOLVE_TOL, _captured, _dense  # noqa: E402

POWER_STEPS = 100


def cond_estimate(N, L, steps: int = POWER_STEPS, seed: int = 0) -> float:
    """cond₂ of the SPD N from power iteration on N and on N⁻¹ (by its factor
    L), each from a seeded start: a low estimate (see the module
    docstring)."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(seed)
    v = torch.randn(N.shape[0], generator=gen, dtype=N.dtype).to(N.device)
    w = v.clone()
    big = small = 0.0
    for _ in range(steps):
        v = N @ v
        big = float(torch.linalg.norm(v))
        v = v / big
        w = torch.cholesky_solve(w[:, None], L)[:, 0]
        small = float(torch.linalg.norm(w))
        w = w / small
    return big * small


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
    dense = engine.plan.dense_cols
    keep = ~np.isin(f.cols, dense)
    t = time.perf_counter()
    tiles = engine.assemble_pairs(d, boost)
    L, invd, ok, *_ = engine.factorize(tiles, d=d)
    sync(drv.device)
    t_factor = time.perf_counter() - t
    d64, boost64 = d.double().cpu().numpy(), boost.double().cpu().numpy()
    delta = d64[dense] ** 2
    out = {"iters": iters, "lane0_iterations": int(res.iterations), "ok": bool(ok),
           "dense_cols": dense.tolist(), "delta_min": float(delta.min()) if len(dense) else None,
           "delta_max": float(delta.max()) if len(dense) else None,
           "d_min": float(d.min()), "d_max": float(d.max()), "factor_s": t_factor,
           "panels": engine.B, "tiles": engine.NT, "schur_products": engine._schur_products}
    Ns_slot = plain.normal_matrix(f.rows[keep], f.cols[keep], vals[keep], m, d64, boost64,
                                  perm=engine.pperm.cpu().numpy(), device=d.device)
    L_dense = _dense(engine, L)
    out["factor_backward"] = plain.backward_error(Ns_slot, L_dense)
    out["factor_backward_tf32"] = plain.backward_error(
        Ns_slot, round_to_tf32(L_dense.cpu().numpy()))
    del Ns_slot, L_dense
    N = plain.normal_matrix(f.rows, f.cols, vals, m, d64, boost64, device=d.device)
    L_plain = plain.factor(N)
    out["cond"] = cond_estimate(N, L_plain, seed=seed)
    g = torch.as_tensor(np.random.default_rng(seed).standard_normal(m),
                        dtype=d.dtype, device=d.device)
    want = plain.solve(L_plain, g.double())
    refine = drv.phases[0].get("config", {}).get("refine_steps", 2)
    for steps in (0, refine):
        y, _ = engine.solve_normal_ell(lp.E, lp.ET, d, g, row_boost=boost,
                                       refine_steps=steps, EB=lp.EB, ETB=lp.ETB)
        out[f"solve{steps}_residual"] = plain.residual_error(N, y, g)
        out[f"solve{steps}_forward"] = float(torch.linalg.norm(y.double() - want)
                                             / torch.linalg.norm(want))
    cond = out["cond"]
    within = (out["ok"] and out["factor_backward"] <= FACTOR_TOL
              and out[f"solve{refine}_residual"] <= SOLVE_TOL
              and all(out[k] <= cond * SOLVE_TOL for k in out if k.endswith("_forward")))
    out.update(tolerances={"factor_backward": FACTOR_TOL, f"solve{refine}_residual": SOLVE_TOL,
                           "forward": f"cond * {SOLVE_TOL}"}, within=bool(within),
               tf32_refused=bool(out["factor_backward_tf32"] > FACTOR_TOL))
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
    if not traffic["entry"].startswith("sparse_fleet"):
        raise SystemExit("dense_cols_check: a cell of the tile engine (entry sparse_fleet*)")
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
