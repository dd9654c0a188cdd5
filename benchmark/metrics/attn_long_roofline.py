"""The towers' long-sequence attention (T > 128: PyTorch's fused
``scaled_dot_product_attention`` pinned to its cuDNN backend) against its
roofline: the least time of one launch at the cell's batch, the larger of
its FLOPs (the scores and their product with the values, 4 * B * T^2 *
width) over the card's bf16 peak and its bytes (q, k and v read once and o
written once, 4 * B * T * width in the tower's dtype) over its HBM
bandwidth, from the published, unpadded sizes, over the kernel's mean
device time per launch in the trace (``device_trace``). A kernel that pads
the head dim shows the padding as lost share. Every launch in a job runs at
the embedder's batch (the stream pads the last chunk)."""

from benchmark.peaks import FLOPS_PER_S, HBM_BYTES_PER_S

KERNEL = "native_sdpa_sm90_flash_fprop"
BYTES = {"bfloat16": 2, "float32": 4}


def read(run):
    t = run.trace
    if t is None:
        return None
    seconds, launches = t.durations(KERNEL)
    if not launches or seconds <= 0:
        return None
    m = run.config["model"]
    embed = run.config["program"]["embed"]
    tokens = (m["image_size"] // m["patch_size"]) ** 2
    b, d, dtype = int(embed["batch_size"]), m["hidden_size"], embed["dtype"]
    least = max(4 * b * tokens ** 2 * d / FLOPS_PER_S[dtype],
                4 * b * tokens * d * BYTES[dtype] / HBM_BYTES_PER_S)
    return 100.0 * least / (seconds / launches)
