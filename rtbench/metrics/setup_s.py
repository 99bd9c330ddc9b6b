"""Seconds from the process's start to the window's first call: imports,
the card's context, the kernels' library, the inputs, the reference's
target and the warm-up through the window's own call."""


def read(run):
    return run.setup_s
