"""Seconds from the process's start to the window's opening: imports, the
kernels loaded (built, in a checkout's first run), the weights, the engine,
the warm-up of the cell's shapes and any lead-in load."""


def read(run):
    return run.setup_s
