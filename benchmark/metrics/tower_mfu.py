"""The towers' own share of the card's peak: the window's images times the
tower's FLOPs per image (from the published architecture,
``reference/<family>.py``), over the device seconds of the operations
launched inside the pipeline's ``embed`` range (the images' generation on
the card among them) and the card's dense peak in the tower's product
dtype (``device_trace``). Unlike ``mfu``, the host's stages and the card's
idle time are left out."""

from benchmark.peaks import FLOPS_PER_S


def read(run):
    t = run.trace
    if t is None or not run.flops_per_image:
        return None
    seconds = t.stage_device_s.get("embed", 0.0)
    if seconds <= 0:
        return None
    dtype = run.config["program"]["embed"]["dtype"]
    return 100.0 * run.images * run.flops_per_image / seconds / FLOPS_PER_S[
        dtype]
