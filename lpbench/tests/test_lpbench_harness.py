"""The harness on the CPU at tiny sizes (the program's plain kernel forms):
new cells, traffic and metrics are found by name from new files alone, the
result's line has the contract's keys, the run loads neither JAX nor the
JAX package and reads nothing of the JAX package's benchmarks, and without
a card the command prints no result."""

import hashlib
import json
import pathlib
import subprocess
import sys

import pytest

from lpbench.tests import tiny

LPBENCH = tiny.LPBENCH
REPO = LPBENCH.parent
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]
DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


def _digests(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


NEW_METRIC = '''"""Twice the loops' iterations (a metric that exists only as a new file)."""

SPANS = {"new_span": "cholesky_is_magic_tpu_torch.sparse.tiled:TiledCholesky.factorize"}


def read(run):
    if not run.loop_iterations:
        return None
    return 2.0 * run.loop_iterations[0] + 0.0 * run.spans["new_span"][0]
'''

# A kind of call no existing entry makes: each lane solved on its own by the
# single-LP pdas on one shared tile engine, the results stacked on the host.
NEW_ENTRY = '''"""One lane at a time: the single-LP pdas on one tile engine."""

import numpy as np

from lpbench.program import mod, pdas_config, pdas_host, standard_forms

OPERANDS = "sparse"


def setup(drv):
    pdas = mod("solvers.pdas")
    sfs = standard_forms(drv.fleet)
    kw = dict(block=drv.traffic["block"], dtype=drv.dtype, device=drv.device)
    st0, engine = pdas.make_pdas_sparse(sfs[0], **kw)
    return engine, [st0] + [pdas.make_pdas_sparse(sf, engine=engine, **kw)[0]
                            for sf in sfs[1:]]


def call(drv, state, cap):
    engine, states = state
    cfg = pdas_config(drv.phases[0], cap)
    return [[mod("solvers.pdas").pdas(st, cfg, engine=engine) for st in states]]


def host(results):
    lanes = [pdas_host(r) for r in results]
    return {key: np.stack([np.asarray(h[key]) for h in lanes]) for key in lanes[0]}
'''
GEN_ALIAS = '''"""The constructed-optimum generator under another name."""

from lpbench.gen.constructed_optimum import make  # noqa: F401
'''


def test_new_config_traffic_entry_generator_and_metric_are_found_by_name(tmp_path):
    root = tiny.make_tiny_root(tmp_path)
    before = _digests(root)
    cfg = json.loads((root / "configs" / "pds-10.json").read_text())
    cfg.update(m=40, n_struct=80, generator="stair_alias",
               phases={"p": {"solver": "pdas", "config": {"max_iters": 200, "mehrotra": True}}})
    (root / "configs" / "stair-40.json").write_text(json.dumps(cfg))
    (root / "gen" / "stair_alias.py").write_text(GEN_ALIAS)
    (root / "entries" / "one_by_one.py").write_text(NEW_ENTRY)
    (root / "traffic" / "solo.json").write_text(json.dumps(
        {"entry": "one_by_one", "block": 16, "loop": "closed", "clients": 1, "lanes": 2,
         "phases": ["p"]}))
    (root / "metrics" / "twice_iters.py").write_text(NEW_METRIC)
    (root / "limits" / "stair-40.solo.json").write_text(json.dumps(
        {"limits": {"primal_res": 2e-5, "x_err": 1.8e-4}}))
    spec = tiny.spec()
    spec["configs"].append({"name": "stair-40", "source": "test", "file": "x",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "stair-40.solo", "config": "stair-40",
                              "traffic": "solo", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "twice_iters", "unit": "count", "better": "lower",
                              "source": "program_span", "layer": "batched loop",
                              "moves": "solves_per_s", "workloads": ["stair-40.solo"]})
    e2e = tiny.run(root, "stair-40.solo", 0, spec)
    traced = tiny.run(root, "stair-40.solo", 1, spec)["line"]
    assert set(e2e["line"]["metrics"]) == {"solves_per_s", "setup_s"}
    assert e2e["line"]["correct"] and traced["correct"], (e2e["line"]["checks"],
                                                          traced["checks"])
    assert e2e["line"]["failed"] == 0
    # Only the metrics that name the new cell, and the new one among them.
    assert set(traced["metrics"]) == {"twice_iters"}
    twice = traced["metrics"]["twice_iters"]["value"]
    assert twice > 0 and twice % 2 == 0
    # Nothing that was there before changed.
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())


@pytest.mark.parametrize("workload", ["pds-10.fleet64", "pilot.batch128"])
@pytest.mark.parametrize("trace", [0, 1])
def test_the_last_line_has_the_contracts_keys(tmp_path, workload, trace):
    line = tiny.run(tiny.make_tiny_root(tmp_path), workload, trace)["line"]
    keys = list(line)
    assert keys[:5] == LINE_KEYS and keys[-1] == "checks"
    assert set(keys[5:-1]) == ({"breakdown"} if trace else set())
    assert set(line["device"]) == DEVICE_KEYS | ({"busy_s", "window_s"} if trace else set())
    assert line["correct"] is True, line["checks"]
    spec = tiny.spec()
    kind = "per_layer" if trace else "end_to_end"
    allowed = {m["name"]: m for m in spec[kind]
               if workload in m.get("workloads", [workload])}
    assert set(line["metrics"]) <= set(allowed) and line["metrics"]
    for name, m in line["metrics"].items():
        assert m["unit"] == allowed[name]["unit"] and isinstance(m["value"], float)
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
    else:
        assert {"solves_per_s", "setup_s"} <= set(line["metrics"])
    json.dumps(line)  # one JSON object


AUDIT = '''
import json, pathlib, sys
opened = []
def hook(event, args):
    if event == "open" and isinstance(args[0], (str, bytes, pathlib.PurePath)):
        opened.append(str(args[0]))
sys.addaudithook(hook)
sys.argv = ["tiny", sys.argv[1], sys.argv[2], sys.argv[3]]
import runpy
runpy.run_module("lpbench.tests.tiny", run_name="__main__")
print(json.dumps(opened))
'''


@pytest.mark.parametrize("workload", ["pds-10.fleet64", "pilot.batch128"])
def test_the_run_loads_no_jax_and_reads_no_jax_benchmark(tmp_path, workload):
    out = subprocess.run([sys.executable, "-c", AUDIT, str(tmp_path), workload, "1"],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith(("{", "["))]
    line, modules, opened = json.loads(lines[-3]), json.loads(lines[-2]), json.loads(lines[-1])
    assert line["correct"] is True
    # Top-level names compared whole: the port's name begins with the JAX
    # package's.
    assert "cholesky_is_magic_tpu_torch" in modules
    assert not {"jax", "jaxlib", "flax", "cholesky_is_magic_tpu"} & set(modules)
    bad = [p for p in opened if "/benchmarks/" in p or p.endswith("/bench.py")
           or "/cholesky_is_magic_tpu/" in p]
    assert not bad, bad


def test_the_sources_name_no_jax_module():
    for path in LPBENCH.rglob("*.py"):
        if path == pathlib.Path(__file__).resolve():
            continue  # this test names them
        text = path.read_text()
        for needle in ("import jax", "from jax", "import cholesky_is_magic_tpu\n",
                       "from cholesky_is_magic_tpu import", "from cholesky_is_magic_tpu.",
                       "benchmarks/", "bench.py"):
            assert needle not in text, (path, needle)


def test_without_a_card_the_command_prints_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the command runs")
    for cwd in (REPO, tmp_path):
        if cwd == tmp_path:  # only BENCHMARK.json and the benchmark's files
            (tmp_path / "BENCHMARK.json").write_bytes((REPO / "BENCHMARK.json").read_bytes())
            subprocess.run(["cp", "-r", str(LPBENCH), str(tmp_path / "lpbench")], check=True)
        out = subprocess.run([sys.executable, "lpbench/run.py", "--workload", "pilot.batch128",
                              "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"],
                             cwd=cwd, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and out.stdout.strip() == "", (out.returncode, out.stdout)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["pds-10.fleet64", "pilot.batch128"])
def test_a_cell_runs_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their full sizes there")
    out = subprocess.run([sys.executable, "lpbench/run.py", "--workload", workload,
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
