"""Seconds from the process's start to the window's opening: the weights,
the program's build and the untimed job (``host_clock``)."""


def read(run):
    return run.setup_s
