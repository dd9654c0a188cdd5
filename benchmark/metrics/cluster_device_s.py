"""Device seconds per job of the operations launched inside the
pipeline's ``cluster`` range: the bucketed engine (``device_trace``)."""


def read(run):
    t = run.trace
    if t is None or not t.jobs or "cluster" not in t.stage_device_s:
        return None
    return t.stage_device_s["cluster"] / t.jobs
