#!/usr/bin/env python3
"""The readings the limits of ``limits/<workload>.json`` are set from: the
check's numbers for one call of a cell at its own size, on each of many
seeds, for the program as the cell runs it and for a control that has to
come out not correct.

    python3 lpbench/readings.py --workload pilot.batch128 --seeds 1-12
    python3 lpbench/readings.py --workload pilot.batch128 --seeds 101-103 --control f32
    python3 lpbench/readings.py --workload pds-10.fleet64 --seeds 101-103 --control round:tf32

Controls:
- ``f32``: the program with its own lower-precision path switched on:
  every double-word phase (``pdas_dd``) run as the float32 ``pdas`` with
  the same settings, handed over the same way;
- ``round:tf32``: the reference put in the program's place: each lane's
  exact optimum (x*, the scaled y*, z*, w*) rounded to TF32, its
  objective c'x in float32.

``--lanes-from-seed``: each seed draws the lanes too (the configuration's
``lane_seed`` replaced by the seed), so the readings span lanes as well as
orders; A stays the configuration's.

One JSON line per seed on standard output.  The benchmark's runs do not
run this; it needs the card, as the cell does.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402


def seeds_of(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi) + 1)) if hi else [int(lo)]
    return out


def round_to_tf32(v: np.ndarray) -> np.ndarray:
    """Round float64 values to TF32 (float32 with 10 mantissa bits; to
    nearest, ties to even), back in float64."""
    bits = np.asarray(v, np.float64).astype(np.float32).view(np.uint32).astype(np.uint64)
    drop = np.uint64(13)
    half = np.uint64(1 << 12)
    odd = (bits >> drop) & np.uint64(1)
    bits = ((bits + half - np.uint64(1) + odd) >> drop) << drop
    return bits.astype(np.uint32).view(np.float32).astype(np.float64)


def rounded_optimum(fleet, ops) -> list:
    """Each lane's exact optimum, in the program's returned form (y in the
    program's scaled rows), rounded to TF32."""
    out = []
    for k in range(fleet.lanes):
        x = round_to_tf32(fleet.x[k])
        out.append({"x": x, "x_lo": None,
                    "y": round_to_tf32(fleet.y[k] / ops.scale),
                    "z": round_to_tf32(fleet.z[k]),
                    "w": round_to_tf32(fleet.w[k]),
                    "objective": float(np.float32(fleet.c[k]) @ x.astype(np.float32))})
    return out


def control_config(config: dict, control: str) -> dict:
    """The configuration a control runs: for ``"f32"`` every double-word
    phase as the float32 ``pdas``; otherwise the configuration as it is."""
    out = json.loads(json.dumps(config))
    if control == "f32":
        for phase in out["phases"].values():
            if phase["solver"] == "pdas_dd":
                phase["solver"] = "pdas"
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 1-12 or 5,9,2147483700")
    ap.add_argument("--control", default="none", choices=("none", "f32", "round:tf32"))
    ap.add_argument("--lanes-from-seed", action="store_true")
    args = ap.parse_args()

    from lpbench.drive import Driver
    from lpbench.harness import HERE, load_json
    from lpbench.reference import check

    spec = load_json(HERE.parent / "BENCHMARK.json")
    cell = {w["name"]: w for w in spec["workloads"]}[args.workload]
    config = control_config(load_json(HERE / "configs" / f"{cell['config']}.json"),
                            args.control)
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    for seed in seeds_of(args.seeds):
        t = time.perf_counter()
        if args.lanes_from_seed:
            config = dict(config, lane_seed=seed)
        drv = Driver(config, traffic, seed, "cuda")
        if args.control == "round:tf32":
            ops = check.program_operands(drv.fleet, drv.path, config.get("dtype", "float32"))
            iterates = rounded_optimum(drv.fleet, ops)
            info = {}
        else:
            drv.setup()
            call = drv.call()
            drv.release()
            drv.to_host(call)
            iterates = drv.iterates(call)
            last = call.results[-1]
            info = {"call_s": call.seconds,
                    "stopped": drv.stopped(call),
                    "statuses": np.bincount(last["status"], minlength=6).tolist(),
                    "loop_iterations": Driver.loop_iterations(call),
                    "reported_gap_max": float(np.max(last["gap"]))}
        numbers = check.worst(drv.fleet, drv.path, [iterates], config.get("dtype", "float32"))
        print(json.dumps({"workload": args.workload, "control": args.control, "seed": seed,
                          "lane_seed": config["lane_seed"],
                          "numbers": numbers, **info,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
