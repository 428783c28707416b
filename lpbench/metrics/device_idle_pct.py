"""Share of the traced call's host-clock window in which no kernel, copy or
fill ran on the card (the window less the union of device intervals)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0.0 or run.trace.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
