"""K5 (``short_seq_attention``, the ViT towers' attention) against its
roofline: the least time its bytes need (q, k and v read once and o
written once, (batch, tokens, heads, head_dim) each in the tower's dtype,
over the card's HBM bandwidth; its FLOPs need far less) over its mean
device time per launch in the trace (``device_trace``). Every launch in a
job runs at the embedder's batch (the stream pads the last chunk)."""

from benchmark.peaks import HBM_BYTES_PER_S

KERNEL = "short_seq_attention"
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
    tokens = (m["image_size"] // m["patch_size"]) ** 2 + 1
    elems = int(embed["batch_size"]) * tokens * m["hidden_size"]
    least = 4 * elems * BYTES[embed["dtype"]] / HBM_BYTES_PER_S
    return 100.0 * least / (seconds / launches)
