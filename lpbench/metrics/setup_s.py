"""Set-up seconds: from the process's start (imports and the CUDA context
included) through input generation, the program's set-up and one warm call
of the cell's own shapes, to the window's start (host clock)."""


def read(run):
    return run.setup_s
