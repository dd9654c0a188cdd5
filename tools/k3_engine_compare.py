#!/usr/bin/env python3
"""The 100,000-image centroid job of ``chip_smoke.py`` phase 8, run from a
given checkout of the repository, to compare two versions of K3 and its
lockstep loop on one card.

    python3 tools/k3_engine_compare.py CHECKOUT [CHECKOUT ...]

For each checkout (a directory holding ``imageclust_tpu_torch``, e.g. an
unpacked ``git archive`` of a commit), in the order given, in a fresh
process: builds that checkout's kernels, makes phase 8's features (n =
100,000, d = 1000, seeded normal on the card), runs
``constrained_ward_bucketed`` with the centroid rule once to warm up, once
timed (host clock, synchronised; the engine's phase timer) and once under
torch.profiler (K3's summed device time and launches, by the kernel names
of either version). Prints one JSON line per run with the card's name and
power limit and the sha256 of the merge log, which must be equal across
checkouts.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

BIG_N, BIG_D = 100_000, 1000
# K3's kernels: the lockstep kernel, and the earlier full-scan design's two
K3_NAMES = ("lockstep_step_kernel", "batched_step_rows",
            "reduce_bucket_partials")


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_one(checkout: str) -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, checkout)
    from imageclust_tpu_torch.cluster import constrained_ward_bucketed
    from imageclust_tpu_torch.device import resolve_device
    from imageclust_tpu_torch.ops._build import load_kernels

    resolve_device("cuda")
    load_kernels()
    os.environ["IMAGECLUST_CLUSTER_PROFILE"] = "1"
    gen = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn((BIG_N, BIG_D), generator=gen, device="cuda")
    kw = dict(min_size=3, max_size=6, update_rule="centroid", device="cuda")
    constrained_ward_bucketed(x, **kw)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = constrained_ward_bucketed(x, **kw)
    wall_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        constrained_ward_bucketed(x, **kw)
        torch.cuda.synchronize()
    k3_us, k3_events = 0.0, 0
    for evt in prof.key_averages():
        if any(name in evt.key for name in K3_NAMES):
            k3_us += getattr(evt, "self_device_time_total",
                             getattr(evt, "self_cuda_time_total", 0.0))
            k3_events += evt.count
    return {"checkout": checkout, "card": _card(), "wall_s": wall_s,
            "bucket_merges_s": res.phases_s["bucket-merges"],
            "phases_s": res.phases_s, "host_paths": res.host_paths,
            "k3_device_s": k3_us / 1e6, "k3_kernel_events": k3_events,
            "merges": int(len(res.merges)),
            "merges_sha256": hashlib.sha256(
                np.ascontiguousarray(res.merges).tobytes()).hexdigest(),
            "timing": "wall_s: host clock around the second run; "
                      "bucket_merges_s: the engine's synchronised phase "
                      "timer; k3_device_s: torch.profiler kernel time of a "
                      "third run"}


def main(argv: list[str]) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    if argv[0] == "--one":
        print(json.dumps(run_one(str(Path(argv[1]).resolve()))), flush=True)
        return 0
    rc = 0
    for checkout in argv:  # a fresh process each: one package per process
        rc |= subprocess.run([sys.executable, __file__, "--one",
                              checkout]).returncode
    return rc


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
