"""Reads of a device tensor on the host (each ``bool``, ``.item()``, ``.cpu()``
of the loops and the normal solves they call; ``loop.host_reads``) per
batched-loop iteration: the program's counter over the traced call, over the
loops' iterations in it."""

from lpbench import program_spans

LAUNCHES = program_spans.LAUNCHES


def read(run):
    return program_spans.count_per_iter(run, "loop.host_reads")
