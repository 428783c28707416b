"""Right-hand sides the tile engine solves for the columns it sets apart from
the normal matrix (``normal.dense_col_rhs``: the columns, once a
factorization, the dbound retry's included) per batched-loop iteration: the
program's counter over the traced call, over the loops' iterations in it.
None where the program keeps no such counter."""

from lpbench import program_spans

LAUNCHES = program_spans.LAUNCHES
COUNTER = "normal.dense_col_rhs"


def read(run):
    got = program_spans.traced(run)
    if got is None or COUNTER not in got[1].counts:
        return None
    return program_spans.count_per_iter(run, COUNTER)
