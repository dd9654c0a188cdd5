"""Time PyTorch's fused attention backends against the port's plain twin at
the ViT towers' long sequences (T > 128), on one CUDA card.

    python -m tools.time_long_attention [--out build/long_attention.json]

For each shape (B, T, H, Dh) in bf16: every backend of
``scaled_dot_product_attention`` pinned alone (flash, cuDNN, memory
efficient) on (B, H, T, Dh) views of (B, T, H, Dh) tensors, as the towers
call it, timed with CUDA events over a burst of launches after a warm-up;
its largest difference from the twin; its kernels' names from the
profiler. At the first shape the twin (``short_seq_attention_plain``) is
timed too, with its peak memory above the inputs. Prints one JSON line and
writes it to ``--out``. Needs a card: it exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

# (batch, tokens, heads, head dim): SigLIP So400m/14@384 at its batch, then
# ViT-B/16, L/14, L/14@336 and the JAX package's SigLIP-style tower
SHAPES = [(128, 729, 16, 72), (256, 197, 12, 64), (128, 257, 16, 64),
          (64, 577, 16, 64), (128, 256, 16, 72)]
BURST = 20


def _time(fn, n=BURST) -> float:
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _kernels(fn) -> list[str]:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()
             if getattr(e, "device_time_total", 0) > 0
             and not e.key.startswith(("aten::", "cuda"))}
    return sorted(n[:160] for n in names)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/long_attention.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        sys.exit(2)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from imageclust_tpu_torch.ops.attention import short_seq_attention_plain

    dev = torch.device("cuda")
    backends = {"flash": SDPBackend.FLASH_ATTENTION,
                "cudnn": SDPBackend.CUDNN_ATTENTION,
                "efficient": SDPBackend.EFFICIENT_ATTENTION}
    out = {"card": torch.cuda.get_device_name(dev),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "shapes": []}
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        for i, (b, t, h, d) in enumerate(SHAPES):
            q, k, v = (torch.randn((b, t, h, d), generator=gen, device=dev,
                                   dtype=torch.bfloat16) for _ in range(3))
            row = {"shape": [b, t, h, d],
                   "least_ms": 1e3 * max(4 * b * t * t * h * d / 989e12,
                                         4 * b * t * h * d * 2 / 3.35e12)}
            if i == 0:
                torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev)
                want = short_seq_attention_plain(q, k, v)
                torch.cuda.synchronize()
                row["twin_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                          - base)
                row["twin_ms"] = _time(
                    lambda: short_seq_attention_plain(q, k, v), 5)
            else:
                want = short_seq_attention_plain(q, k, v)
            for name, be in backends.items():

                def call(be=be):
                    with sdpa_kernel([be]):
                        return torch.nn.functional.scaled_dot_product_attention(
                            q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2)).transpose(1, 2)

                try:
                    got = call()
                    row[name] = {
                        "ms": _time(call),
                        "max_abs_err": float((got.float() - want.float())
                                             .abs().max()),
                        "kernels": _kernels(call)}
                except RuntimeError as exc:
                    row[name] = {"error": str(exc).splitlines()[0][:300]}
            out["shapes"].append(row)
            del q, k, v, want
            torch.cuda.empty_cache()
    line = json.dumps(out)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as fh:
        fh.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
