"""The cell ``qap15.fleet32``, and ``pilot.solve`` (its files are ready, the
cell is not in ``BENCHMARK.json``: its host-paced runs spread too widely),
on the CPU at tiny sizes (the program's plain kernel forms): the result's
line has the contract's keys, every lane is correct under the cells'
limits, and the traced run reads the Schur updates' counters where the tile
engine runs."""

import json

import pytest

from lpbench.tests import tiny

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]
SOLVE = {"name": "pilot.solve", "config": "pilot", "traffic": "solve", "chips": 1,
         "why": "one LP per call, pdas then the double-word finisher, closed loop of one client"}


def _spec():
    spec = tiny.spec()
    spec["workloads"].append(SOLVE)
    return spec


def _root(tmp_path):
    root = tiny.make_tiny_root(tmp_path)
    cfg = json.loads((root / "configs" / "qap15.json").read_text())
    for key in ("m", "n_struct"):
        cfg.pop(key)
    (root / "configs" / "qap15.json").write_text(json.dumps(dict(cfg, n=4)))
    t = json.loads((root / "traffic" / "fleet32.json").read_text())
    (root / "traffic" / "fleet32.json").write_text(json.dumps(dict(t, lanes=2, block=16)))
    return root


@pytest.mark.parametrize("workload", ["pilot.solve", "qap15.fleet32"])
@pytest.mark.parametrize("trace", [0, 1])
def test_the_new_cells_run_and_are_correct(tmp_path, workload, trace):
    spec = _spec()
    line = tiny.run(_root(tmp_path), workload, trace, spec_=spec)["line"]
    assert list(line)[:5] == LINE_KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= (1 if workload == "pilot.solve" else 2)
    kind = "per_layer" if trace else "end_to_end"
    allowed = {m["name"] for m in spec[kind] if workload in m.get("workloads", [workload])}
    assert set(line["metrics"]) <= allowed
    if not trace:
        assert {"solves_per_s", "setup_s"} <= set(line["metrics"])
    elif workload == "qap15.fleet32":
        # On the CPU no device interval: the span's busy time and the share
        # read nothing; the counter reads two factorizations an iteration.
        got = line["metrics"]["schur_products_per_iter"]["value"]
        assert got > 0 and got % 2 == 0
        assert "schur_update_roofline" not in line["metrics"]
