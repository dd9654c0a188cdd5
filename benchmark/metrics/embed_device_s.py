"""Device seconds per job of the operations launched inside the
pipeline's ``embed`` range (``device_trace``)."""


def read(run):
    t = run.trace
    if t is None or not t.jobs or "embed" not in t.stage_device_s:
        return None
    return t.stage_device_s["embed"] / t.jobs
