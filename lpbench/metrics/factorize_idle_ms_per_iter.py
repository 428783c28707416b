"""Device-idle ms per batched-loop iteration while the host was in the
factorizations (the dbound retry's too): each idle gap of the traced call
put down to the span open on the host at its middle, rolled up to
``normal.factorize`` (:mod:`lpbench.program_spans`)."""

from lpbench import program_spans

LAUNCHES = program_spans.LAUNCHES


def read(run):
    return program_spans.idle_ms_per_iter(run, "normal.factorize")
