"""Device ms per batched-loop iteration of the tile engine's diagonal-tile
factors: every kernel, copy and fill launched inside a ``factorize.tile``
span (each panel's K1 with its tile copies, nested in
``normal.factorize``), the dbound retry's factorization too, from the
traced call.  None where the program opens no such span."""

from lpbench import program_spans

LAUNCHES = program_spans.LAUNCHES
SPAN = "factorize.tile"


def read(run):
    got = program_spans.traced(run)
    if got is None or got[0].busy_s <= 0.0 or run.traced_iterations <= 0:
        return None
    spans = program_spans.reduce(*got)
    return 1e3 * spans[SPAN].busy_s / run.traced_iterations if SPAN in spans else None
