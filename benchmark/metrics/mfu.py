"""The whole job's share of the card's peak: the window's images times the
tower's FLOPs per image (from the published architecture,
``reference/<family>.py``), over the traced window's seconds and the
card's dense peak in the tower's product dtype (``device_trace``)."""

from benchmark.peaks import FLOPS_PER_S


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not run.flops_per_image:
        return None
    dtype = run.config["program"]["embed"]["dtype"]
    flops = run.images * run.flops_per_image
    return 100.0 * flops / t.window_s / FLOPS_PER_S[dtype]
