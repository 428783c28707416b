"""Iterations the batched loops ran in a call (their slowest lane's, summed
over the call's phases), from the results' per-lane counts."""


def read(run):
    if not run.loop_iterations:
        return None
    return sum(run.loop_iterations) / len(run.loop_iterations)
