"""Solves per second: lanes whose last phase met its stop, over every call
of the window, divided by the window's host-clock seconds from its start
to the end of its last call (the call running at the close finishes and
counts).  Lanes that miss their stop are attempted and failed."""


def read(run):
    if run.trace is not None or run.window_s <= 0.0:
        return None
    return run.stopped / run.window_s
