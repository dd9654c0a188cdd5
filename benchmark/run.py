"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. Set-up (the tower's weights made on the card
from the seed, the program's build, one untimed job) counts in
``setup_s``; the window then runs whole jobs for ``--seconds``. Once it
has closed, the program's state is freed and every job is judged against
the plain reference (:mod:`benchmark.check`). The last lines on standard
error give each number compared beside its limit; the last line on
standard output is the result: ``correct``, ``attempted`` and ``failed``
jobs, the cell's end-to-end metrics (``--trace 0``) or per-layer ones
(``--trace 1``, with the trace's ``breakdown``), ``device`` and the
``checks``.

Without a CUDA card, with fewer cards than the cell asks for, or with JAX,
its libraries or the JAX package in ``sys.modules`` once the window has
closed, it prints no result and exits 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "imageclust_tpu")


@dataclass
class Context:
    """What a traffic kind's loop (``kinds/<kind>.py``) is given."""
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    tmp: str
    t_start: float = T_START
    warm: bool = True
    # program settings over the configuration's (tests and the control)
    program_overrides: dict = field(default_factory=dict)
    # breaks the timed path under test (the fault tests)
    break_program: object = None
    # each job's readings beside its checks (the control's, not a run's)
    extra: bool = False
    readings: list = field(default_factory=list)


def _fail(msg: str) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(2)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def execute(ctx: Context, manifest):
    """Run the cell's traffic kind; returns the result line (without its
    device record), the run's record and its checks."""
    kind = importlib.import_module(
        f"benchmark.kinds.{ctx.traffic['kind']}")
    rec, checks, failed = kind.run(ctx)
    metrics = {}
    for m in manifest.metrics(ctx.cell["name"], ctx.trace):
        value = manifest.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": all(c.ok for c in checks) and failed == 0,
           "attempted": len(rec.jobs), "failed": failed,
           "metrics": metrics}
    return out, rec, checks


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.manifest import Manifest

    manifest = Manifest()
    cell = manifest.cell(args.workload)
    config = manifest.config(cell["config"])
    # the deployment's host threads, as its configuration states them,
    # set before torch loads its thread pools
    threads = int(config["host"]["compute_threads"])
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(threads)

    import torch

    torch.set_num_threads(threads)
    if not torch.cuda.is_available():
        _fail("no CUDA device: the benchmark measures the card only")
    if torch.cuda.device_count() < int(cell["chips"]):
        _fail(f"the cell asks for {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found")
    from imageclust_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    with tempfile.TemporaryDirectory(prefix="bench_") as tmp:
        ctx = Context(cell=cell, config=config,
                      traffic=manifest.traffic(cell["traffic"]),
                      limits=manifest.limits(cell["name"]), seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace),
                      device=dev, tmp=tmp)
        out, rec, checks = execute(ctx, manifest)
    bad = forbidden_modules()
    if bad:
        _fail(f"modules of JAX or the JAX package were loaded: {bad}")
    out["device"] = {
        "platform": "gpu", "kind": torch.cuda.get_device_name(dev),
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(rec.memory_peak_bytes)}
    if rec.trace is not None:
        from benchmark.trace import breakdown

        out["device"].update(busy_s=rec.trace.busy_s,
                             window_s=rec.trace.window_s)
        out["breakdown"] = breakdown(rec.trace)
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in checks}
    for r in ctx.readings:
        print("reading " + json.dumps(r), file=sys.stderr)
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
