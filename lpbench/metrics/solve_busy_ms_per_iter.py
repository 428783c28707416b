"""Device ms per batched-loop iteration put down to the raw solves (triangular
solves; the tile engine's blocked substitutions): every kernel, copy and
fill whose runtime call started inside a ``normal.solve`` span of the
program (or inside a span nested in it that is no other layer's), from the
traced call (:mod:`lpbench.program_spans`)."""

from lpbench import program_spans

LAUNCHES = program_spans.LAUNCHES


def read(run):
    return program_spans.busy_ms_per_iter(run, "normal.solve")
