"""A copy of the benchmark's tree with its cells cut to a size the CPU runs
in seconds (the program on the CPU takes the plain forms of its kernels),
for the tests.  ``python -m lpbench.tests.tiny <dir> <workload> <trace>``
runs one cell there and prints its line, then the modules it loaded."""

import json
import pathlib
import shutil
import sys
import time

LPBENCH = pathlib.Path(__file__).resolve().parents[1]
SEED = 2**31 + 3
SIZES = {"pilot": dict(m=24, n_struct=48), "pds-10": dict(m=48, n_struct=96)}
TRAFFIC = {"batch128": dict(lanes=2, pad_multiple=16), "fleet64": dict(lanes=3, block=16)}


def make_tiny_root(dst: pathlib.Path) -> pathlib.Path:
    """``dst/lpbench``: configs, traffic, entries, generators, limits and
    metrics of the real tree, with every configuration and traffic file cut
    down."""
    root = dst / "lpbench"
    for sub in ("configs", "traffic", "entries", "gen", "limits", "metrics"):
        shutil.copytree(LPBENCH / sub, root / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for name, kw in SIZES.items():
        path = root / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update(kw)
        path.write_text(json.dumps(cfg))
    for name, kw in TRAFFIC.items():
        path = root / "traffic" / f"{name}.json"
        t = json.loads(path.read_text())
        t.update(kw)
        path.write_text(json.dumps(t))
    return root


def spec() -> dict:
    return json.loads((LPBENCH.parent / "BENCHMARK.json").read_text())


def run(root, workload, trace, spec_=None, seconds=0.5):
    from lpbench import harness

    spec_ = spec_ or spec()
    cell = {w["name"]: w for w in spec_["workloads"]}[workload]
    return harness.run_cell(spec_, cell, SEED, seconds, bool(trace), "cpu",
                            time.perf_counter(), root=root)


if __name__ == "__main__":
    sys.path.insert(0, str(LPBENCH.parent))
    out = run(make_tiny_root(pathlib.Path(sys.argv[1])), sys.argv[2], int(sys.argv[3]))
    print(json.dumps(out["line"]))
    print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
