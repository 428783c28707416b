"""Kernel launches per batched-loop iteration: the profiler's kernel events
in the traced call over the loops' iterations in it."""


def read(run):
    if run.trace is None or run.traced_iterations <= 0 or not run.trace.kernels:
        return None
    return len(run.trace.kernels) / run.traced_iterations
