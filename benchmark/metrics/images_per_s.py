"""Images of every job completed in the window over the window's host
seconds (``host_clock``)."""


def read(run):
    return run.images / run.window_s if run.window_s > 0 else None
