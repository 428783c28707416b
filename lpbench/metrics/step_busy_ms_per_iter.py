"""Device ms per batched-loop iteration put down to the iteration's own step:
``loop.iteration`` less its ``normal.*`` children: every kernel, copy and
fill whose runtime call started inside a ``loop.iteration`` span of the
program (or inside a span nested in it that is no other layer's), from the
traced call (:mod:`lpbench.program_spans`)."""

from lpbench import program_spans

LAUNCHES = program_spans.LAUNCHES


def read(run):
    return program_spans.busy_ms_per_iter(run, "loop.iteration")
