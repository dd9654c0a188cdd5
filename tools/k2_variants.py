#!/usr/bin/env python3
"""Time K2 (``csrc/merge_loop_whole.cu``) against variants of itself.

    python3 tools/k2_variants.py [512x2 256x2 1024x1 every-row no-prefetch ...]

Each variant is a copy of the source with a few lines rewritten:

* ``THREADSxBLOCKS``: the block size ``kThreads`` and the least number of
  blocks per SM that ``__launch_bounds__`` asks for;
* ``every-row``: each trip writes column sa into every row, as the twin
  does, instead of only the rows active before the merge (the end-of-kernel
  fill of inactive rows then copies values already there);
* ``no-prefetch``: the queued rows are not prefetched into L2;
* ``no-column``: no column write at all. It gives wrong results and serves
  only to show what the column writes cost.

The script compiles all copies at once (nvcc, the flags of
``ops/_build.py``) into ``build/k2_variants/``, runs each at the timing
shape of ``chip_smoke.py`` phase 7 (C = 256 buckets of B = 512 with 384
normal d = 64 items each, absorb_min 3), checks its five outputs and final
D against the built library's, and times it: CUDA events around a burst of
launches, each on a fresh copy of D. The library and the variants are timed
in turns, forwards then backwards. One JSON line per variant, with the
card's name and power limit and ptxas's register count. Exits 1 if a
variant other than ``no-column`` differs from the library.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "build" / "k2_variants"
REPS, WARM = 10, 2
DEFAULT = ["256x2", "512x2", "1024x1", "every-row", "no-prefetch",
           "no-column"]
_COLUMN = re.compile(r"^ *if \(\(was_active >> i\) & 1u\) "
                     r"(k\.D\[static_cast<size_t>\(j\) \* B \+ m\.sa\] = v;)$",
                     re.M)
_PREFETCH = (r"^ *for \(int o = 0; o < B; o \+= 32\) "
             r"prefetch_l2\(row \+ o\);\n")


def _sub(pattern, repl, src: str, flags=0) -> str:
    out, n = re.subn(pattern, repl, src, flags=flags)
    if n != 1:
        raise RuntimeError(f"merge_loop_whole.cu no longer has the line "
                           f"this tool rewrites ({pattern!r})")
    return out


def variant_source(src: str, name: str) -> str:
    if name == "every-row":
        return _sub(_COLUMN, r"    \1", src)
    if name == "no-column":
        return _sub(_COLUMN, "", src)
    if name == "no-prefetch":
        return _sub(_PREFETCH, "", src, re.M)
    threads, blocks = (int(v) for v in name.split("x"))
    src = _sub(r"constexpr int kThreads = \d+;",
               f"constexpr int kThreads = {threads};", src)
    return _sub(r"__launch_bounds__\(kThreads, \d+\)",
                f"__launch_bounds__(kThreads, {blocks})", src)


def _build(names):
    from imageclust_tpu_torch.ops import _build as b

    OUT.mkdir(parents=True, exist_ok=True)
    shutil.copy(b._CSRC / "lexmin.cuh", OUT / "lexmin.cuh")
    src = (b._CSRC / "merge_loop_whole.cu").read_text()
    procs = {}
    for name in names:
        cu = OUT / f"{name}.cu"
        cu.write_text(variant_source(src, name))
        cmd = [b._nvcc(), *b.NVCC_FLAGS, "-shared", str(cu), "-o",
               str(OUT / f"{name}.so")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs, regs = {}, {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        found = re.findall(r"Used (\d+) registers", out)
        regs[name] = int(found[-1]) if found else None
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ic_merge_loop_whole.argtypes = [p, p, p, i, i, i, i, p, p, p, p,
                                            p, p]
        lib.ic_merge_loop_whole.restype = i
        libs[name] = lib
    return libs, regs


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("k2_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from imageclust_tpu_torch.cluster import sharded
    from imageclust_tpu_torch.device import resolve_device
    from imageclust_tpu_torch.ops import bucket_kernels as bk

    resolve_device("cuda")
    names = argv or DEFAULT
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    libs, regs = _build(names)

    C, B, per, d = 256, 512, 384, 64
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(7)
    x = torch.randn((C * B, d), generator=gen).to(dev)
    bidx = torch.arange(C * B, dtype=torch.int32, device=dev).reshape(C, B)
    ct = torch.full((C,), per, dtype=torch.int32, device=dev)
    tg = torch.full((C,), sharded._bucket_target(per, 3, 6),
                    dtype=torch.int32, device=dev)
    D0 = sharded.pairwise_ward_singleton(sharded._gather_buckets(x, bidx))

    def library(D):
        return bk.merge_loop_whole(D, ct, tg, 6, 3)

    def runner(lib):
        def run(D):
            log = torch.empty((C, B - 1, 3), dtype=torch.int32, device=dev)
            step = torch.empty(C, dtype=torch.int32, device=dev)
            st = torch.empty((3, C, B), dtype=torch.int32, device=dev)
            rc = lib.ic_merge_loop_whole(
                D.data_ptr(), ct.data_ptr(), tg.data_ptr(), C, B, 6, 3,
                log.data_ptr(), step.data_ptr(), st[0].data_ptr(),
                st[1].data_ptr(), st[2].data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: cudaError {rc}")
            return log, step, st[0], st[1], st[2] > 0
        return run

    runs = {"library": library}
    runs.update({name: runner(libs[name]) for name in names})
    want_D = D0.clone()
    want = library(want_D)
    identical = {}
    for name, run in runs.items():
        got_D = D0.clone()
        got = run(got_D)
        torch.cuda.synchronize()
        identical[name] = (all(torch.equal(g, w) for g, w in zip(got, want))
                           and torch.equal(got_D.view(torch.int32),
                                           want_D.view(torch.int32)))

    def burst(run):
        pool = [D0.clone() for _ in range(REPS + WARM)]
        for _ in range(WARM):
            run(pool.pop())
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(REPS):
            run(pool.pop())
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / REPS

    order = list(runs)
    times = {name: [] for name in order}
    for name in order + order[::-1]:
        times[name].append(burst(runs[name]))
    for name in order:
        print(json.dumps({
            "variant": name, "card": card, "C": C, "B": B,
            "items_per_bucket": per, "device_ms": times[name],
            "registers": regs.get(name),
            "identical_to_library": identical[name],
            "timing": f"CUDA events around {REPS} back-to-back launches "
                      "(fresh D each), per launch; two turns"}), flush=True)
    return 0 if all(ok for name, ok in identical.items()
                    if name != "no-column") else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
