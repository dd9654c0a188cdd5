"""Readings of a cell's comparisons for sound runs, for the control and
for planted faults, at the cell's own size: what its limits are set from.

    python -m benchmark.control --workload <cell> --sound 11 12 ... \\
        --control 21 22 23 --fault 31 32 33 [--fault-kind row]

Each seed runs one job of the cell, as a run's window does, in one
process (no warm-up, no timing) and prints one JSON line: the seed, the
side, the checks' values and the per-job readings. The sound side runs
the configuration as stated; the control side runs the program's own
lower-precision path (``embed.quantize=int8``, the step below the
configuration's bfloat16 tower); a fault side breaks the timed path as
:mod:`benchmark.faults` sets out. The benchmark's own runs never run
these sides.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

import torch

from benchmark import faults
from benchmark.manifest import Manifest
from benchmark.run import Context, execute

CONTROL = {"embed": {"quantize": "int8"}}


def reading(manifest, cell_name: str, seed: int, side: str, device,
            traffic: dict | None = None, overrides: dict | None = None,
            fault: str = "row", limits: dict | None = None) -> dict:
    cell = manifest.cell(cell_name)
    brk = faults.KINDS[fault] if side == "fault" else None
    over = dict(overrides or {})
    if side == "control":
        over = {**over, "embed": {**over.get("embed", {}),
                                  **CONTROL["embed"]}}
    with tempfile.TemporaryDirectory(prefix="bench_ctl_") as tmp:
        ctx = Context(cell=cell, config=manifest.config(cell["config"]),
                      traffic=traffic or manifest.traffic(cell["traffic"]),
                      limits=limits or manifest.limits(cell_name), seed=seed,
                      seconds=0.0, trace=False, device=device, tmp=tmp,
                      warm=False, program_overrides=over,
                      break_program=brk, extra=True)
        out, _rec, checks = execute(ctx, manifest)
    return {"seed": seed, "side": side, "correct": out["correct"],
            "checks": {c.name: c.value for c in checks},
            "readings": ctx.readings}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--sound", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--fault", type=int, nargs="*", default=[])
    ap.add_argument("--fault-kind", default="row",
                    choices=sorted(faults.KINDS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from imageclust_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    manifest = Manifest()
    for side, seeds in (("sound", args.sound), ("control", args.control),
                        ("fault", args.fault)):
        for seed in seeds:
            print(json.dumps(reading(manifest, args.workload, seed, side,
                                     dev, fault=args.fault_kind)),
                  flush=True)


if __name__ == "__main__":
    main()
