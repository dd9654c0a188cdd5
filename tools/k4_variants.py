#!/usr/bin/env python3
"""Time K4 (``csrc/pref_topk_block.cu``) against variants of itself.

    python3 tools/k4_variants.py [stages=3 no-epilogue no-mma ...]

Each variant is a copy of the source with a line or two rewritten:

* ``stages=N``: a ring of N centroid stages on the tensor-core paths;
* ``f32-stages=N``: a ring of N slab stages on the f32 path;
* ``f32-whole-b``: the f32 path loads all 16 centroid vectors of a k-step
  before its FMAs instead of two halves of 8;
* ``no-epilogue``: the tensor-core paths skip the top-k epilogue (wrong
  results: it shows what the epilogue costs);
* ``no-mma``: the tensor-core paths issue no wgmma (wrong results: the
  copies and the epilogue alone);
* ``f32-no-epilogue``: the f32 path only tests each sum of a tile instead
  of scoring and queueing it (wrong results).

The script compiles all copies at once (nvcc, the flags of
``ops/_build.py``) into ``build/k4_variants/``, runs each at the timing
shapes of ``chip_smoke.py`` phase 16 (n = 2,000,000 rows, k = 5209
centroids; bf16 and f32 at d = 512, int8 at d = 1024, integer-grid data),
checks the outputs of the variants that should be right against the built
library's, and times them: CUDA events around 3 back-to-back launches. The
library and the variants are timed in turns, forwards then backwards. One
JSON line per variant and dtype, with the card's name and power limit and
ptxas's register count. Exits 1 if a variant that should be right differs.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "build" / "k4_variants"
REPS, WARM = 3, 1
N, K, KK = 2_000_000, 5209, 8
SHAPES = (("bfloat16", 512), ("int8", 1024), ("float32", 512))
DEFAULT = ["stages=3", "no-epilogue", "no-mma", "f32-no-epilogue",
           "f32-whole-b"]
WRONG = ("no-epilogue", "no-mma", "f32-no-epilogue")


def _sub(pattern, repl, src: str) -> str:
    out, n = re.subn(pattern, repl, src, flags=re.M)
    if n != 1:
        raise RuntimeError(f"pref_topk_block.cu no longer has the line this "
                           f"tool rewrites ({pattern!r})")
    return out


def variant_source(src: str, name: str) -> str:
    if name.startswith("f32-stages="):
        return _sub(r"^constexpr int kF32Stages = \d+;",
                    f"constexpr int kF32Stages = {int(name[11:])};", src)
    if name.startswith("stages="):
        return _sub(r"^constexpr int kStages = \d+;",
                    f"constexpr int kStages = {int(name[7:])};", src)
    if name == "no-epilogue":
        return _sub(r"^    tc_tile\(top, queue, acc, .*\);$", "", src)
    if name == "no-mma":
        return _sub(r"^        wgmma_k\(acc, da \+ 2 \* ks, db \+ 2 \* ks, "
                    r".*\);$", "        ;", src)
    if name == "f32-no-epilogue":  # a test of each sum keeps the gram
        return _sub(r"^        enqueue\(top, qa, kF32Threads, nq, h, score\(.*\);$",
                    "        nq[h] += acc[h][m] == -1.5f;", src)
    if name == "f32-whole-b":
        return _sub(r"^constexpr int kF32Halves = \d+;",
                    "constexpr int kF32Halves = 1;", src)
    raise ValueError(f"unknown variant {name!r}")


def _build(names):
    sys.path.insert(0, str(REPO))
    from imageclust_tpu_torch.ops import _build as b

    src = (b._CSRC / "pref_topk_block.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        tag = re.sub(r"[^a-z0-9]+", "_", name)
        cu = OUT / f"{tag}.cu"
        cu.write_text(variant_source(src, name))
        so = OUT / f"{tag}.so"
        cmd = [b._nvcc(), *b.NVCC_FLAGS, "-shared", str(cu), "-o", str(so)]
        procs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs, regs = {}, {}
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs[name] = [int(r) for r in re.findall(r"Used (\d+) registers",
                                                 log)]
        lib = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ic_pref_topk_block.argtypes = [p, p, p, i, i, i, i, i, i, p, p, p]
        lib.ic_pref_topk_block.restype = i
        libs[name] = lib
    return libs, regs


def main(argv: list[str]) -> int:
    import torch

    sys.path.insert(0, str(REPO))
    from imageclust_tpu_torch.device import resolve_device
    from imageclust_tpu_torch.ops import pref_kernels as pk

    names = argv or DEFAULT
    resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs, regs = _build(names)
    gen = torch.Generator(device="cuda").manual_seed(16)
    dts = {"bfloat16": torch.bfloat16, "int8": torch.int8,
           "float32": torch.float32}
    bad = False
    for dname, d in SHAPES:
        dt = dts[dname]
        hi = 127 if dt == torch.int8 else 8
        x, c = (torch.randint(-hi, hi + 1, (m, d), generator=gen,
                              device="cuda", dtype=torch.int16).to(dt)
                for m in (N, K))
        cn = pk.row_norms(c)
        want = pk.pref_topk_block(x, c, cn, KK)
        cn_pad = pk._padded_norms(cn)  # as the wrapper hands them over
        idx = torch.empty((N, KK), dtype=torch.int32, device="cuda")
        vals = torch.empty((N, KK), dtype=torch.float32, device="cuda")

        def runner(lib):
            def run():
                rc = lib.ic_pref_topk_block(
                    x.data_ptr(), c.data_ptr(), cn_pad.data_ptr(), N, K, d, d,
                    KK, pk._DTYPES[dt], idx.data_ptr(), vals.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"launch failed: {rc}")
            return run

        def burst(run):
            for _ in range(WARM):
                run()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(REPS):
                run()
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / REPS

        order = ["library", *names]
        runs = {"library": lambda: pk.pref_topk_block(x, c, cn, KK)}
        runs.update({n: runner(libs[n]) for n in names})
        times = {n: [] for n in order}
        for seq in (order, order[::-1]):
            for n in seq:
                times[n].append(burst(runs[n]))
        for n in names:
            runs[n]()
            torch.cuda.synchronize()
            same = bool(torch.equal(idx, want[0]) and torch.equal(
                vals.view(torch.int32), want[1].view(torch.int32)))
            if n not in WRONG and not same:
                bad = True
            print(json.dumps({
                "variant": n, "dtype": dname, "n": N, "k": K, "d": d,
                "card": card, "ms": times[n], "library_ms": times["library"],
                "identical_to_library": same, "registers": regs[n]}),
                flush=True)
        del x, c, cn, cn_pad, want, idx, vals
        torch.cuda.empty_cache()
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
