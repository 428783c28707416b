"""Device ms per batched-loop iteration of the tile engine's Schur updates:
every kernel, copy and fill launched inside a ``factorize.schur`` span (each
panel's SYRK gathers, batched products and ``index_add_``, nested in
``normal.factorize``), the dbound retry's factorization too, from the traced
call (:mod:`lpbench.schur`)."""

from lpbench import program_spans, schur

LAUNCHES = program_spans.LAUNCHES


def read(run):
    s = schur.busy_s(run)
    return None if s is None or run.traced_iterations <= 0 else 1e3 * s / run.traced_iterations
