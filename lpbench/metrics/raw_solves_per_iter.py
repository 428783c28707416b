"""Raw solves with the normal matrix's factor (``normal.solves``: the
predictor's, the corrector's and their refinements') per batched-loop
iteration: the program's counter over the traced call, over the loops'
iterations in it."""

from lpbench import program_spans

LAUNCHES = program_spans.LAUNCHES


def read(run):
    return program_spans.count_per_iter(run, "normal.solves")
