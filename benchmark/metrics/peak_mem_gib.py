"""Peak device memory allocated in the window, GiB
(``torch.cuda.max_memory_allocated``, reset as the window opens)."""


def read(run):
    return run.window_peak_bytes / 2 ** 30 if run.window_peak_bytes else None
