"""The traced call put down to the program's spans (lpbench/program_spans.py)
on hand-made events and spans, its timeline beside the trace's reduction of
the same events, and the tiny cells' counter metrics on the CPU, with the
program's recorder and without it."""

import pytest

from lpbench import program_spans as ps
from lpbench import trace as tracing
from lpbench.tests import tiny
from cholesky_is_magic_tpu_torch.utils.spans import Recording, Span

MS = 1_000_000  # ns

# One iteration from 0 to 100 ms: an assembly (10-20), a factorization
# (20-50) with a product span inside it (30-40), a solve (60-70); the
# iteration's own step around them; nothing open from 100 to 120.
SPANS = [Span("loop.iteration", -1, 0, 100 * MS),
         Span("normal.assemble", 0, 10 * MS, 20 * MS),
         Span("normal.factorize", 0, 20 * MS, 50 * MS),
         Span("ops.bell.matvec", 2, 30 * MS, 40 * MS),
         Span("normal.solve", 0, 60 * MS, 70 * MS)]

# (name, is_device, start, end, correlation id): each kernel launched by a
# runtime call (cudaLaunchKernel) at the stated host time.
EVENTS = [
    ("cudaLaunchKernel", False, 5 * MS, 6 * MS, 1),     # in the step
    ("k_step", True, 6 * MS, 12 * MS, 1),
    ("cudaLaunchKernel", False, 15 * MS, 16 * MS, 2),   # in the assembly
    ("k_asm", True, 16 * MS, 30 * MS, 2),
    ("cudaLaunchKernel", False, 35 * MS, 36 * MS, 3),   # in the product, in factorize
    ("k_mv", True, 36 * MS, 44 * MS, 3),
    ("cudaMemcpyAsync", False, 65 * MS, 66 * MS, 4),    # in the solve
    ("Memcpy DtoH", True, 66 * MS, 68 * MS, 4),
    ("cudaLaunchKernel", False, 110 * MS, 111 * MS, 5),  # outside every span
    ("k_late", True, 111 * MS, 115 * MS, 5),
    ("k_orphan", True, 80 * MS, 82 * MS, 99),           # no runtime call
    ("cudaStreamSynchronize", False, 90 * MS, 100 * MS, 6),
]
T0, T1 = 0, 120 * MS


def _rec(spans=SPANS, counts=None):
    return Recording(t0_ns=T0, t1_ns=T1, spans=list(spans), counts=counts or {})


def test_known_busy_idle_and_self_times():
    tr = ps.timeline(EVENTS, T0, T1)
    # Idle: 0-6 (the step), 12-16 (mid 14: the assembly), 30-36 (mid 33:
    # the product), 44-66, 68-80, 82-111 (the step), 115-120 (outside).
    assert tr.gaps == [(a * MS, b * MS) for a, b in (
        (0, 6), (12, 16), (30, 36), (44, 66), (68, 80), (82, 111), (115, 120))]
    got = ps.reduce(tr, _rec())
    ms = {k: (round(v.busy_s * 1e3, 6), round(v.idle_s * 1e3, 6), round(v.self_s * 1e3, 6),
              v.calls) for k, v in got.items()}
    assert ms == {"loop.iteration": (6.0, 69.0, 50.0, 1),
                  "normal.assemble": (14.0, 4.0, 10.0, 1),
                  "normal.factorize": (0.0, 0.0, 20.0, 1),
                  "ops.bell.matvec": (8.0, 6.0, 10.0, 1),
                  "normal.solve": (2.0, 0.0, 10.0, 1),
                  ps.OUTSIDE: (4.0, 5.0, 0.0, 0),
                  ps.UNMATCHED: (2.0, 0.0, 0.0, 0)}
    layers = ps.by_layer(tr, _rec())
    # The product span rolls up into the factorization around it.
    assert round(layers["normal.factorize"].busy_s * 1e3, 6) == 8.0
    assert round(layers["normal.factorize"].idle_s * 1e3, 6) == 6.0
    assert round(layers["loop.iteration"].busy_s * 1e3, 6) == 6.0
    assert layers["normal.refine"].busy_s == layers["normal.refine"].idle_s == 0.0


@pytest.mark.parametrize("spans", [SPANS, SPANS[:1], []], ids=["nested", "one", "none"])
def test_busy_and_idle_sum_to_the_device_total_and_the_windows_idle(spans):
    tr = ps.timeline(EVENTS, T0, T1)
    for got in (ps.reduce(tr, _rec(spans)), ps.by_layer(tr, _rec(spans))):
        device_total = sum(e - s for _, s, e, _ in tr.device) * 1e-9
        assert sum(v.busy_s for v in got.values()) == pytest.approx(device_total, rel=1e-12)
        idle = tr.window_s - tr.busy_s
        assert sum(v.idle_s for v in got.values()) == pytest.approx(idle, rel=1e-12)


def test_the_existing_trace_fields_are_unchanged():
    """The trace's reduction of the events (without their correlation ids)
    gives the numbers it gave before the timeline existed, and the timeline
    of the same events agrees with its window and busy time."""
    old = [e[:4] for e in EVENTS]
    tr = tracing.reduce(old, T0, T1)
    assert tr.window_s == pytest.approx(0.120)
    assert tr.busy_s == pytest.approx(0.006 + 0.014 + 0.008 + 0.002 + 0.002 + 0.004)
    assert tr.kernels == [("k_step", pytest.approx(0.006)), ("k_asm", pytest.approx(0.014)),
                          ("k_mv", pytest.approx(0.008)), ("k_orphan", pytest.approx(0.002)),
                          ("k_late", pytest.approx(0.004))]
    assert tr.device_by_name == {k: pytest.approx(v) for k, v in {
        "k_step": 0.006, "k_asm": 0.014, "k_mv": 0.008, "Memcpy DtoH": 0.002,
        "k_orphan": 0.002, "k_late": 0.004}.items()}
    assert tr.idle_by_host == {k: pytest.approx(v) for k, v in {
        "host: no CUDA call (Python, the loop's own work)":
            0.006 + 0.004 + 0.006 + 0.022 + 0.012 + 0.005,
        "cudaStreamSynchronize": 0.029}.items()}
    tl = ps.timeline(EVENTS, T0, T1)
    assert (tl.t0_ns, tl.t1_ns) == (T0, T1)
    assert tl.window_s == tr.window_s and tl.busy_s == tr.busy_s
    assert sum(e - s for s, e in tl.gaps) * 1e-9 == pytest.approx(tr.window_s - tr.busy_s)
    assert sum(tr.idle_by_host.values()) == pytest.approx(tr.window_s - tr.busy_s)
    # Events without a correlation id: nothing is matched.
    got = ps.reduce(ps.timeline([e[:4] + (None,) for e in EVENTS], T0, T1), _rec())
    assert set(got) >= {ps.UNMATCHED} and got[ps.UNMATCHED].busy_s == pytest.approx(0.036)


def test_innermost_span_at_each_moment():
    bounds, owner = ps.innermost(SPANS)
    at = lambda t: ps._at(bounds, owner, t)  # noqa: E731
    assert [at(t * MS) for t in (-1, 0, 15, 25, 35, 45, 55, 65, 99, 100, 130)] == \
        [-1, 0, 1, 2, 3, 2, 0, 4, 0, -1, -1]
    assert ps.layer_of(SPANS, 3) == "normal.factorize" and ps.layer_of(SPANS, -1) == ps.OUTSIDE


def _run(capture, iterations=1):
    """What a metric reader sees of a traced run whose launch records hold
    ``capture`` (None: a program without the recorder)."""
    import types

    log = []
    launches = {ps.OPEN: [None], ps.CLOSE: [capture], ps.WINDOW: [(T0, T1)]}
    return types.SimpleNamespace(trace=tracing.reduce([e[:4] for e in EVENTS], T0, T1),
                                 traced_iterations=iterations, launches=launches,
                                 log=log, say=log.append)


def test_the_metrics_find_nothing_without_a_recording():
    from lpbench.drive import HERE, load

    names = ("assemble_busy_ms_per_iter", "step_idle_ms_per_iter", "host_reads_per_iter",
             "raw_solves_per_iter")
    for run in (_run(None), _run(ps.Capture(_rec(), EVENTS), iterations=0)):
        for name in names:
            assert load(HERE, "metrics", name).read(run) is None
        assert run.log == []
    run = _run(ps.Capture(_rec(counts={"loop.iterations": 1, "loop.host_reads": 2}), EVENTS))
    assert load(HERE, "metrics", "host_reads_per_iter").read(run) == 2.0
    assert load(HERE, "metrics", "factorizations_per_iter").read(run) == 0.0
    assert load(HERE, "metrics", "assemble_busy_ms_per_iter").read(run) == pytest.approx(14.0)
    assert load(HERE, "metrics", "step_idle_ms_per_iter").read(run) == pytest.approx(69.0)
    # The lines are said once a run, whichever reader asks first.
    assert [ln.split(":")[0] for ln in run.log] == ["[trace] by span", "[trace] counters"]
    # Each reader takes the recording through the same launch records.
    for name in names:
        assert load(HERE, "metrics", name).LAUNCHES is ps.LAUNCHES


COUNTERS = {"host_reads_per_iter", "factorizations_per_iter", "raw_solves_per_iter"}


@pytest.mark.parametrize("workload", ["pds-10.fleet64", "pilot.batch128"])
def test_the_tiny_cells_report_the_counter_metrics(tmp_path, workload):
    out = tiny.run(tiny.make_tiny_root(tmp_path), workload, 1)
    metrics = out["line"]["metrics"]
    assert COUNTERS <= set(metrics), metrics
    # The traced call: TRACE_ITERS iterations a phase, one read each and one
    # that ends each phase's loop; two factorizations an iteration (the
    # per-lane dbound retry); pilot's pdas (Mehrotra, 1 refinement) 2 x 2
    # raw solves and its pdas_dd (2 refinements) 2 x 3, pds-10's pdas
    # (Mehrotra, 2 refinements) 2 x 3.
    assert metrics["host_reads_per_iter"]["value"] == 1.5
    assert metrics["factorizations_per_iter"]["value"] == 2.0
    assert metrics["raw_solves_per_iter"]["value"] == (6.0 if workload.startswith("pds") else 5.0)
    # No card: no device interval to put down.
    assert not {m for m in metrics if "_busy_" in m or "_idle_" in m}
    assert any(line.startswith("[trace] by span:") for line in out["log"])


def test_a_program_without_the_recorder_leaves_the_metrics_out(tmp_path, monkeypatch):
    """The parent of the recorder: the traced run ends, its line whole and
    without the recorder's metrics."""
    from cholesky_is_magic_tpu_torch.utils import diag

    monkeypatch.delattr(diag, "recording")
    out = tiny.run(tiny.make_tiny_root(tmp_path), "pilot.batch128", 1)
    line = out["line"]
    assert line["correct"]
    assert not COUNTERS & set(line["metrics"])
    assert not any(ln.startswith("[trace] by span:") for ln in out["log"])
    assert "slowest_lane_iters" in line["metrics"]
