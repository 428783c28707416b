"""The tile engine's spans and counters inside a factorization, recorded on
the CPU: ``factorize.tile``, ``factorize.trsm`` and ``factorize.schur`` open
once per panel that has the step, inside ``normal.factorize``; the counters
``normal.trsm_tiles`` and ``normal.schur_products`` add the engine's own
per-panel counts; and the benchmark's roll-up to the solver's layers
(``lpbench/program_spans.py``) reads the same with the new spans as
without them."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cholesky_is_magic_tpu_torch.ingest.standard_form import scale_constraints
from cholesky_is_magic_tpu_torch.sparse.tiled import engine_for_sparse
from cholesky_is_magic_tpu_torch.utils import diag
from cholesky_is_magic_tpu_torch.utils.spans import Recording, Span
from lpbench import program_spans as ps
from lpbench.gen import qap_relaxation as qap

STEPS = ("factorize.tile", "factorize.trsm", "factorize.schur")


def _engine(n=5, block=16):
    f = qap.fleet(n, 0, 1, lanes=1)
    vals, _ = scale_constraints(f.rows.astype(np.int32), f.vals, f.b[0])
    A = sp.csc_matrix((vals, (f.rows, f.cols)), shape=(f.m, f.n))
    eng = engine_for_sparse(A, block=block, dtype=torch.float64, device="cpu")
    d = torch.as_tensor(np.random.default_rng(3).random(f.n) + 0.5, dtype=torch.float64)
    return eng, eng.assemble_pairs(d)


def _recorded(times=1):
    eng, tiles = _engine()
    with diag.recording() as rec:
        with diag.span("loop.iteration"):
            for _ in range(times):
                eng.factorize(tiles)
    return eng, rec


@pytest.mark.parametrize("times", [1, 2])
def test_counters_are_the_engines_per_panel_counts(times):
    eng, rec = _recorded(times)
    assert rec.counts["normal.factorizations"] == times
    assert rec.counts["normal.schur_products"] == times * sum(eng._n_syrk) > 0
    assert rec.counts["normal.trsm_tiles"] == times * sum(eng._n_rows) > 0


def test_a_span_per_panel_step_inside_the_factorization():
    eng, rec = _recorded()
    names = [s.name for s in rec.spans]
    assert names.count("normal.factorize") == 1
    top = names.index("normal.factorize")
    assert names.count("factorize.tile") == eng.B
    assert names.count("factorize.trsm") == sum(1 for k in eng._n_rows if k)
    assert names.count("factorize.schur") == sum(1 for k in eng._n_syrk if k)
    for s in rec.spans:
        if s.name in STEPS:
            assert s.parent == top
            assert rec.spans[top].t0_ns <= s.t0_ns <= s.t1_ns <= rec.spans[top].t1_ns


def _without_steps(rec):
    """The recording with the panel steps' spans taken out (they have no
    children, so every other span keeps its parent)."""
    keep = [i for i, s in enumerate(rec.spans) if s.name not in STEPS]
    new = {old: k for k, old in enumerate(keep)}
    spans = [Span(s.name, new.get(s.parent, -1), s.t0_ns, s.t1_ns)
             for s in (rec.spans[i] for i in keep)]
    return Recording(t0_ns=rec.t0_ns, t1_ns=rec.t1_ns, spans=spans, counts=rec.counts)


def test_the_layers_read_the_same_with_the_panel_spans_as_without():
    _, rec = _recorded(2)
    # A launch every 1/400 of the recording, each kernel 1 ns after its
    # launch for 1 ns, so that launches and idle gaps fall in every span.
    t0, t1 = rec.t0_ns, rec.t1_ns
    events = []
    for k, t in enumerate(np.linspace(t0, t1 - 3, 400).astype(np.int64).tolist()):
        events += [("cudaLaunchKernel", False, t, t + 1, k), ("k", True, t + 1, t + 2, k)]
    tl = ps.timeline(events, t0, t1)
    nested, flat = ps.by_layer(tl, rec), ps.by_layer(tl, _without_steps(rec))
    assert set(nested) == set(flat)
    for layer in nested:
        assert nested[layer].busy_s == pytest.approx(flat[layer].busy_s, abs=1e-15)
        assert nested[layer].idle_s == pytest.approx(flat[layer].idle_s, abs=1e-15)
    assert nested["normal.factorize"].busy_s > 0
    # By span, the panel steps hold part of what the layer holds.
    by_span = ps.reduce(tl, rec)
    steps = sum(by_span[n].busy_s for n in STEPS if n in by_span)
    assert 0 < steps <= nested["normal.factorize"].busy_s + 1e-15
