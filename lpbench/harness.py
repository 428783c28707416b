"""One run of one cell: set-up, the measured (or traced) window, the check
against the plain reference, and the result's line.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own under this directory, found by the name
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the LP (generator and sizes, the matrix
  seed), its dtype and the solver settings of each phase;
- ``traffic/<traffic>.json``: the entry that hands the lanes to the
  program and its parameters, lanes per call, the phases a call runs, the
  loop (see :mod:`lpbench.drive`);
- ``entries/<entry>.py``: the program's set-up and one call of a kind of
  traffic; ``gen/<generator>.py``: a generator of fleets;
- ``limits/<workload>.json``: the numbers of the check that decide
  ``correct`` for that cell, each with its limit (see
  :mod:`lpbench.reference.check`);
- ``metrics/<metric>.py``: ``read(run)`` gives the metric from a
  :class:`Run` (None where it finds nothing to read); optional ``SPANS``
  (``{label: target}``: timed with a synchronize around them, in the
  traced run's span call), ``SETUP_SPANS`` (the same, in set-up) and
  ``LAUNCHES`` (``{target: describe}``: each call's shapes, recorded in
  the traced call).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

from lpbench import hooks
from lpbench.drive import Driver, load
from lpbench.reference import check

HERE = Path(__file__).resolve().parent
TRACE_ITERS = 2  # iterations a phase in the traced call
FORBIDDEN = ("jax", "jaxlib", "flax", "cholesky_is_magic_tpu")


@dataclasses.dataclass
class Run:
    """What a metric reader sees of one run."""

    cell: dict
    config: dict
    traffic: dict
    lanes: int
    setup_s: float
    setup_spans: dict  # label -> (seconds, calls), taken in set-up
    window_s: float
    calls: list  # drive.Call of the window (trace 0) or the traced call (trace 1)
    stopped: int  # lanes of those calls that met their stop
    loop_iterations: list  # per call: the batched loops' iterations
    trace: object = None  # trace.Trace of the traced call (trace 1)
    traced_iterations: int = 0  # the batched loops' iterations in the traced call
    launches: dict = dataclasses.field(default_factory=dict)  # target -> [describe]
    spans: dict = dataclasses.field(default_factory=dict)  # label -> (seconds, calls)
    span_iterations: int = 0  # the batched loops' iterations in the span call
    log: list = dataclasses.field(default_factory=list)  # lines for standard error

    def say(self, line: str) -> None:
        self.log.append(line)


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell_metrics(spec: dict, cell: dict, kind: str) -> list:
    """The metric entries of ``kind`` (``end_to_end`` / ``per_layer``) this
    cell reports: those with no ``workloads`` key and those that list it."""
    return [m for m in spec[kind] if cell["name"] in m.get("workloads", [cell["name"]])]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def _sync_fn(device: str):
    import torch

    if str(device).startswith("cuda"):
        return torch.cuda.synchronize
    return lambda: None


def run_cell(spec: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, root: Path = HERE) -> dict:
    """The result's line of one run (a dict), with the check's numbers and
    limits under ``checks``; ``root`` is the directory holding configs,
    traffic, limits and metrics."""
    import torch

    from lpbench import trace as tracing

    config = load_json(root / "configs" / f"{cell['config']}.json")
    traffic = load_json(root / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(root / "limits" / f"{cell['name']}.json")["limits"]
    kind = "per_layer" if trace else "end_to_end"
    entries = cell_metrics(spec, cell, kind)
    # Set-up spans are taken in every run, so set-up does the same work in
    # both kinds of run; the others only where this run reports them.
    readers = {m["name"]: load(root, "metrics", m["name"])
               for m in cell_metrics(spec, cell, "per_layer") + entries}
    setup_spans = {}
    for m in cell_metrics(spec, cell, "per_layer"):
        setup_spans.update(getattr(readers[m["name"]], "SETUP_SPANS", {}))
    sync = _sync_fn(device)
    on_card = str(device).startswith("cuda")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    log = []

    # -- set-up: inputs, the program's state, one warm call ---------------
    drv = Driver(config, traffic, seed, device, root)
    acc_setup = {}
    with hooks.patched(hooks.span_wrappers(setup_spans, acc_setup, sync)):
        drv.setup()
    warm = drv.call(cap=1)
    log.append(f"[setup] warm call (one iteration a phase) {warm.seconds:.4f} s")
    del warm
    sync()
    t_window = time.perf_counter()
    setup_s = t_window - t_start

    # -- the window ---------------------------------------------------------
    # The measured run: calls back to back for ``seconds``; the last call
    # finishes and counts.  The traced run: one call of TRACE_ITERS
    # iterations a phase under the profiler (a whole call of the dense cell
    # makes millions of launches, more than the profiler reads back in a
    # run's time), then one whole call, with the span wrappers where a
    # metric asks for spans, which the check and the counters read.
    launches, spans, span_iterations, tr, traced_iterations = {}, {}, 0, None, 0
    if not trace:
        calls = []
        while True:
            calls.append(drv.call())
            if time.perf_counter() - t_window >= seconds:
                break
        window_s = time.perf_counter() - t_window
    else:
        wanted, span_targets = {}, {}
        for m in entries:
            wanted.update(getattr(readers[m["name"]], "LAUNCHES", {}))
            span_targets.update(getattr(readers[m["name"]], "SPANS", {}))
        with hooks.patched(hooks.launch_wrappers(wanted, launches)):
            traced_call, tr = tracing.traced(lambda: drv.call(cap=TRACE_ITERS), device)
        drv.to_host(traced_call)
        traced_iterations = Driver.loop_iterations(traced_call)
        window_s = tr.window_s
        with hooks.patched(hooks.span_wrappers(span_targets, spans, sync)):
            calls = [drv.call()]
        drv.to_host(calls[0])
        if span_targets:
            span_iterations = Driver.loop_iterations(calls[0])
    memory_peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    drv.release()
    if on_card:
        torch.cuda.empty_cache()
    for c in calls:
        drv.to_host(c)
    for k, c in enumerate(calls):
        log.append(f"[window] call {k}: {c.seconds:.4f} s, loop iterations"
                   f" {Driver.loop_iterations(c)}, lanes stopped {drv.stopped(c)}/{drv.lanes}")

    # -- the check: every lane of every call --------------------------------
    t = time.perf_counter()
    numbers = check.worst(drv.fleet, drv.path, [drv.iterates(c) for c in calls],
                          config.get("dtype", "float32"))
    correct = check.verdict(numbers, limits)
    log.append(f"[check] {len(calls)} calls x {drv.lanes} lanes against the exact"
               f" optimum in {time.perf_counter() - t:.3f} s; other numbers: "
               + ", ".join(f"{k} {v:.6e}" for k, v in numbers.items() if k not in limits))

    run = Run(cell=cell, config=config, traffic=traffic, lanes=drv.lanes,
              setup_s=setup_s, setup_spans=acc_setup, window_s=window_s, calls=calls,
              stopped=sum(drv.stopped(c) for c in calls),
              loop_iterations=[Driver.loop_iterations(c) for c in calls],
              trace=tr, traced_iterations=traced_iterations, launches=launches,
              spans=spans, span_iterations=span_iterations, log=log)
    metrics = {}
    for m in entries:
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    attempted = drv.lanes * len(calls)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": memory_peak}
    line = {"correct": bool(correct), "attempted": attempted,
            "failed": attempted - run.stopped, "metrics": metrics, "device": dev}
    if trace:
        counts = {}
        for name, _ in tr.kernels:
            counts[name] = counts.get(name, 0) + 1
        log.append("[trace] kernel launches by name: " + "; ".join(
            f"{short_name(n, 90)} {c}" for n, c in sorted(counts.items(),
                                                           key=lambda kv: -kv[1])[:8]))
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        line["breakdown"] = {
            "device_ops": [[short_name(n), s] for n, s in sorted(
                tr.device_by_name.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[n, s] for n, s in sorted(tr.idle_by_host.items(),
                                                    key=lambda kv: -kv[1])[:10]],
        }
    line["checks"] = {k: {"value": numbers[k], "limit": lim} for k, lim in limits.items()}
    return {"line": line, "log": run.log}


def short_name(kernel: str, width: int = 160) -> str:
    """A kernel's name cut to ``width`` characters (templated names run to
    thousands)."""
    return kernel if len(kernel) <= width else kernel[:width - 3] + "..."


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"not read ({err})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"


def main(argv: list, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="lpbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_json(HERE.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); this machine has"
              f" {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    print(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__},"
          f" CUDA {torch.version.cuda}; nvidia-smi name, power limit: {card_line()};"
          f" allow_tf32 (matmul) {torch.backends.cuda.matmul.allow_tf32}", file=sys.stderr)
    out = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the port's benchmark may import neither JAX nor"
              " the JAX package", file=sys.stderr)
        return 4
    for line in out["log"]:
        print(line, file=sys.stderr)
    for k, v in out["line"]["checks"].items():
        print(f"[check] {k} {v['value']:.6e} limit {v['limit']:.6e}", file=sys.stderr)
    print(json.dumps(out["line"]), flush=True)
    return 0
