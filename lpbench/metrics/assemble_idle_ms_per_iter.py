"""Device-idle ms per batched-loop iteration while the host was in the normal
matrix's assembly (dense: the scaled SGEMM; the tile engine: the pair-
schedule assembly kernel): each idle gap of the traced call put down to the
span open on the host at its middle, rolled up to ``normal.assemble``
(:mod:`lpbench.program_spans`)."""

from lpbench import program_spans

LAUNCHES = program_spans.LAUNCHES


def read(run):
    return program_spans.idle_ms_per_iter(run, "normal.assemble")
