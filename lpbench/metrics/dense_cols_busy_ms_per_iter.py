"""Device ms per batched-loop iteration of the work on the columns the tile
engine sets apart from the normal matrix: every kernel, copy and fill
launched inside a ``normal.dense_cols`` span in the traced call (in
``normal.factorize``: the forward substitutions of the columns, their QR
and the small factor, the dbound retry's too; in ``normal.solve``: each
solve's correction).  None where the program opens no such span."""

from lpbench import program_spans

LAUNCHES = program_spans.LAUNCHES
SPAN = "normal.dense_cols"


def read(run):
    got = program_spans.traced(run)
    if got is None or got[0].busy_s <= 0.0 or run.traced_iterations <= 0:
        return None
    spans = program_spans.reduce(*got)
    return 1e3 * spans[SPAN].busy_s / run.traced_iterations if SPAN in spans else None
