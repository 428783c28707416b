"""The cells ``lands.saa64`` and ``pilot.batch128engine`` through
``lpbench`` on the CPU at tiny sizes (the program's plain kernel forms), as
``lpbench/tests/test_lpbench_new_cells.py`` runs ``qap15.fleet32``: the
result's line has the contract's keys, every lane is correct under the
cells' limits, and the traced run reads the dense columns' span and counter
where the engine sets columns apart; and the readers of the cells'
nested-span metrics on a hand-made traced call."""

import json

import pytest

from cholesky_is_magic_tpu_torch.sparse import symbolic
from lpbench.tests import tiny

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]
def _root(tmp_path):
    root = tiny.make_tiny_root(tmp_path)
    path = root / "configs" / "lands.json"
    cfg = json.loads(path.read_text())
    for key in ("m", "n_struct"):
        cfg.pop(key)
    path.write_text(json.dumps(dict(cfg, scenarios=24)))
    for name, kw in (("saa64", dict(lanes=2, block=16)),
                     ("batch128engine", dict(lanes=2, pad_multiple=16, block=16))):
        path = root / "traffic" / f"{name}.json"
        path.write_text(json.dumps(dict(json.loads(path.read_text()), **kw)))
    return root


@pytest.mark.parametrize("workload", ["lands.saa64", "pilot.batch128engine"])
@pytest.mark.parametrize("trace", [0, 1])
def test_the_new_cells_run_and_are_correct(tmp_path, monkeypatch, workload, trace):
    # At 24 scenarios the capacities (26 entries) are not long against m =
    # 170 by the rule's 10·sqrt(m): lower its floor so that the tiny cell sets
    # them apart, as the rule does at the cell's size.
    monkeypatch.setattr(symbolic, "DENSE_SQRT_M", 1.0)
    spec = tiny.spec()
    line = tiny.run(_root(tmp_path), workload, trace, spec_=spec)["line"]
    assert list(line)[:5] == LINE_KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 2
    kind = "per_layer" if trace else "end_to_end"
    allowed = {m["name"] for m in spec[kind] if workload in m.get("workloads", [workload])}
    assert set(line["metrics"]) <= allowed
    if not trace:
        assert {"solves_per_s", "setup_s"} <= set(line["metrics"])
    elif workload == "lands.saa64":
        # On the CPU no device interval: the span's busy time reads nothing;
        # the counter reads the four columns in each of the two
        # factorizations an iteration (the fleet's per-lane dbound retry).
        assert line["metrics"]["dense_col_rhs_per_iter"]["value"] == 8.0
        assert "dense_cols_busy_ms_per_iter" not in line["metrics"]


# One traced iteration from 0 to 100 ms: a factorization (10-60) holding a
# tile factor (10-20) and the dense columns' part (30-50), a solve (60-80)
# holding a correction (65-75).
MS = 1_000_000
SPANS = [("loop.iteration", -1, 0, 100), ("normal.factorize", 0, 10, 60),
         ("factorize.tile", 1, 10, 20), ("normal.dense_cols", 1, 30, 50),
         ("normal.solve", 0, 60, 80), ("normal.dense_cols", 4, 65, 75)]
# (name, is_device, start, end, correlation id), each kernel after its launch.
EVENTS = [("cudaLaunchKernel", False, 11 * MS, 12 * MS, 1), ("k1", True, 12 * MS, 18 * MS, 1),
          ("cudaLaunchKernel", False, 31 * MS, 32 * MS, 2), ("fwd", True, 32 * MS, 35 * MS, 2),
          ("cudaLaunchKernel", False, 40 * MS, 41 * MS, 3), ("qr", True, 41 * MS, 42 * MS, 3),
          ("cudaLaunchKernel", False, 66 * MS, 67 * MS, 4), ("fix", True, 67 * MS, 69 * MS, 4)]


@pytest.mark.parametrize("name,want", [("dense_cols_busy_ms_per_iter", 3.0),
                                       ("tile_factor_busy_ms_per_iter", 3.0)])
def test_the_nested_span_metrics_read_their_spans_device_time(name, want):
    """The readers of the two nested spans on a hand-made traced call of two
    iterations: each span's device time (both ``normal.dense_cols`` spans,
    in the factorization and in the solve) over the iterations; nothing
    where the program keeps no recording or opens no such span."""
    import types

    from lpbench import program_spans as ps
    from lpbench import trace as tracing
    from lpbench.drive import HERE, load
    from cholesky_is_magic_tpu_torch.utils.spans import Recording, Span

    def run(spans, capture=True):
        rec = Recording(t0_ns=0, t1_ns=100 * MS, counts={},
                        spans=[Span(n, p, a * MS, b * MS) for n, p, a, b in spans])
        launches = {ps.OPEN: [None], ps.CLOSE: [ps.Capture(rec, EVENTS) if capture else None],
                    ps.WINDOW: [(0, 100 * MS)]}
        log = []
        return types.SimpleNamespace(
            trace=tracing.reduce([e[:4] for e in EVENTS], 0, 100 * MS), traced_iterations=2,
            launches=launches, log=log, say=log.append)

    reader = load(HERE, "metrics", name)
    assert reader.LAUNCHES is ps.LAUNCHES
    assert reader.read(run(SPANS)) == pytest.approx(want)
    assert reader.read(run(SPANS, capture=False)) is None
    other = [("other.span",) + s[1:] if s[0] == reader.SPAN else s for s in SPANS]
    assert reader.read(run(other)) is None
