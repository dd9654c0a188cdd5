#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``imageclust_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``imageclust_tpu_torch/csrc`` and drives
the port end to end on the card, phase by phase; each phase prints one JSON
line and raises on any failure:

1. the card (``nvidia-smi`` name and power limit, printed as given) and the
   kernel build;
2. K1 (``merge_update_argmin``) against its plain PyTorch twin on the card
   at n in {128, 256, 1024, 4096}: random and integer-grid (tied) matrices,
   random active/size/birth patterns, ``do_update`` 0 and 1, an
   all-infeasible case — bit-identical (D, dmin, bhi, blo) required; then
   the kernel's and the twin's times (CUDA events, warm, median of 25) beside
   the bound (bytes moved over 3.35 TB/s);
3. the exact engine (``constrained_ward``) on 4096 integer-grid features
   (d = 1000) through K1 and through the twin: identical merge logs and
   clusters required;
4. the server (stdlib HTTP) in-process with full-width ResNet50 (bf16, s2d
   stem, seeded random init) and fake naming: three ``POST /api/cluster``
   (18 images in 3 colour groups, 200 images, the 18 again with
   ``?async=1``), then ``/api/result``, ``/api/view``, ``/api/image`` and
   ``/healthz``;
5. ``cli run`` (``Pipeline.run_paths``) on 4000 BMPs in a temp directory.

The K1 launch counter is set to 0 just before phases 3, 4 and 5 and read
just after each: every job's launches must lie in [merges, merges + K],
K = ``FOUND_READ_EVERY`` (the gated no-op steps the merge loop may run
before its next host read of ``found``). The line before the last is the
``{"kernels": [...]}`` summary; the last line is
``{"ok": true, "device": {...}}``. Long outputs (the nvcc log, the CLI
job's result) go to ``$IMAGECLUST_SMOKE_OUT`` (default ``build/chip_smoke``).
Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import uuid
from pathlib import Path

REPO = Path(__file__).resolve().parent
OUT = REPO / os.environ.get("IMAGECLUST_SMOKE_OUT", "build/chip_smoke")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
TIMING_REPS = 25
DEVICE = "cuda"
ENGINE_N = 4096     # phase 3: the exact engine's largest padded size
CLI_GROUPS = 800    # phase 5: 800 groups x 5 = 4000 images (< exact_limit)
SERVER_GROUPS = 40  # phase 4: 40 groups x 5 = 200 images in one request


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = TIMING_REPS, warm: int = 3) -> float:
    """Median per-call device time of ``fn`` from CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, match: tuple[str, ...] = (), reps: int = TIMING_REPS):
    """Mean device time per call of the CUDA kernels ``fn`` launches whose
    names contain one of ``match`` (all kernels when empty), from
    torch.profiler; None when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = _kernel_us(prof, match)
    return total_us / reps / 1e3 if total_us else None


def _kernel_us(prof, match=()) -> float:
    total = 0.0
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if us and (not match or any(m in evt.key for m in match)):
            total += us
    return total


# -- synthetic images (GPU hosts may lack cv2 and PIL: BMPs decode with numpy)

def encode_bmp(img) -> bytes:
    """(H, W, 3) BGR uint8 -> uncompressed 24-bit BMP bytes."""
    import numpy as np

    h, w, _ = img.shape
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = img[::-1].reshape(h, w * 3)  # bottom-up
    size = 54 + rows.size
    header = (b"BM" + size.to_bytes(4, "little") + b"\0\0\0\0"
              + (54).to_bytes(4, "little") + (40).to_bytes(4, "little")
              + w.to_bytes(4, "little") + h.to_bytes(4, "little")
              + (1).to_bytes(2, "little") + (24).to_bytes(2, "little")
              + b"\0" * 24)
    return header + rows.tobytes()


def group_images(rng, n_groups: int, per_group: int, prefix: str,
                 size: int = 224):
    """(names, BMP bytes, group of each image): flat colour groups + noise."""
    import numpy as np

    bases = rng.integers(0, 256, (n_groups, 3))
    if n_groups <= 3:
        bases = np.array([(220, 30, 30), (30, 220, 30), (30, 30, 220)])[
            :n_groups]
    names, blobs, groups = [], [], []
    for g in range(n_groups):
        for i in range(per_group):
            noise = rng.integers(0, 21, (size, size, 3), dtype=np.uint8)
            img = np.clip(bases[g].astype(np.int16) - 10 + noise, 0,
                          255).astype(np.uint8)
            names.append(f"{prefix}g{g}_img{i}.bmp")
            blobs.append(encode_bmp(img))
            groups.append(g)
    return names, blobs, groups


# -- phases ------------------------------------------------------------------

def phase_card_and_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    from imageclust_tpu_torch.ops._build import build_info, load_kernels

    load_kernels()
    info = build_info()
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "build.log").write_text(info["log"])
    emit({"phase": "build", "card": card, "seconds": info["seconds"],
          "library": os.path.relpath(info["path"], REPO),
          "log": os.path.relpath(OUT / "build.log", REPO)})
    return card


def _k1_state(gen, n, dev, integer_grid, frac_active=0.8):
    import torch

    if integer_grid:
        d = torch.randint(0, 5, (n, n), generator=gen).float()
    else:
        d = torch.rand((n, n), generator=gen)
    d = ((d + d.T) / 2).contiguous()
    d.fill_diagonal_(0.0)
    births = torch.randperm(2 * n, generator=gen)[:n].to(torch.int32)
    sizes = torch.randint(1, 4, (n,), generator=gen).to(torch.int32)
    active = (torch.rand(n, generator=gen) < frac_active).to(torch.int32)
    active[:2] = 1
    dvec = torch.randint(0, 5, (n,), generator=gen).float() if integer_grid \
        else torch.rand(n, generator=gen)
    return [t.to(dev) for t in (d, dvec, births, sizes, active)]


def phase_k1(card: str):
    import torch

    from imageclust_tpu_torch.ops import merge_kernels as mk

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1234)
    cases = 0
    max_err = 0.0
    # 128, 256 and 4096 are the padded sizes of the main path's jobs
    # (18, 200 and 4000 images); 1024 sits between
    for n in (128, 256, 1024, 4096):
        for integer_grid in (False, True):
            D, dvec, births, sizes, active = _k1_state(gen, n, dev,
                                                       integer_grid)
            sa = int(torch.randint(0, n, (1,), generator=gen))
            for do_update in (0, 1):
                for max_size in (0, 2, 6, 100):  # 0: all infeasible
                    d_k, d_p = D.clone(), D.clone()
                    args = (dvec, sa, do_update, births, sizes, active,
                            max_size)
                    _, k_min, k_hi, k_lo = mk.merge_update_argmin(d_k, *args)
                    _, p_min, p_hi, p_lo = mk.merge_update_argmin_plain(
                        d_p, *args)
                    torch.cuda.synchronize()
                    same = (torch.equal(d_k.view(torch.int32),
                                        d_p.view(torch.int32))
                            and torch.equal(k_min.view(torch.int32),
                                            p_min.view(torch.int32))
                            and int(k_hi) == int(p_hi)
                            and int(k_lo) == int(p_lo))
                    if not same:
                        raise AssertionError(
                            f"K1 != twin at n={n} grid={integer_grid} "
                            f"do={do_update} max={max_size}: "
                            f"{(float(k_min), int(k_hi), int(k_lo))} vs "
                            f"{(float(p_min), int(p_hi), int(p_lo))}")
                    if max_size == 0 and not (torch.isinf(k_min)
                                              and int(k_hi) == 2**31 - 1):
                        raise AssertionError("all-infeasible case found a pair")
                    max_err = max(max_err, float((d_k - d_p).abs().max()))
                    cases += 1
    emit({"phase": "k1_parity", "cases": cases, "parity": "bit-identical",
          "max_abs_err": max_err})

    timings = {}
    for n in (1024, 4096):
        # the main path's heaviest state: every slot active, update pending
        D, dvec, births, sizes, active = _k1_state(gen, n, dev, False, 1.0)
        args = (dvec, torch.tensor([n // 2], dtype=torch.int32, device=dev),
                torch.ones(1, dtype=torch.int32, device=dev), births, sizes,
                active, 6)
        call = lambda: mk.merge_update_argmin(D, *args)  # noqa: E731
        plain = lambda: mk.merge_update_argmin_plain(D, *args)  # noqa: E731
        # wall time of a call, the wrapper's host work included (what the
        # merge loop pays), and the device time of the kernels alone
        kernel_ms = cuda_ms(call)
        plain_ms = cuda_ms(plain)
        kernel_device_ms = device_ms(call, ("merge_step_rows",
                                            "reduce_partials"))
        plain_device_ms = device_ms(plain)
        n_act = int(active.sum())
        # each active row of D read once, one row + one column written,
        # dvec/births/sizes/active read once
        bytes_moved = n_act * n * 4 + 2 * n * 4 + 4 * n * 4
        bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        # the kernel's own time is its device time; the call time where the
        # profiler records no device activity
        timings[n] = dict(ms=kernel_device_ms or kernel_ms,
                          plain_ms=plain_device_ms or plain_ms,
                          call_ms=kernel_ms, bound_ms=bound_ms)
        emit({"phase": "k1_time", "n": n, "card": card,
              "kernel_ms": kernel_ms, "plain_ms": plain_ms,
              "kernel_device_ms": kernel_device_ms,
              "plain_device_ms": plain_device_ms,
              "bound_ms": bound_ms, "bound_by": "bytes",
              "bytes": bytes_moved,
              "timing": f"*_ms: CUDA events, median of {TIMING_REPS} warm "
                        f"calls; *_device_ms: torch.profiler kernel time, "
                        f"mean of {TIMING_REPS}"})
    return max_err, timings


def phase_engine(card: str):
    import numpy as np
    import torch

    from imageclust_tpu_torch.cluster import ward
    from imageclust_tpu_torch.ops import merge_kernels as mk

    rng = np.random.default_rng(7)
    n, d = ENGINE_N, 1000
    x = rng.integers(-2, 3, (n, d)).astype(np.float32)
    kw = dict(min_size=3, max_size=6, update_rule="centroid",
              reassign_dropped=False, mesh=None, device=DEVICE)
    mk.launches = 0
    t0 = time.perf_counter()
    got = ward._constrained_ward(x, None, merge_step=mk.merge_update_argmin,
                                 **kw)
    total_s = time.perf_counter() - t0
    launches = mk.launches
    t0 = time.perf_counter()
    ref = ward._constrained_ward(
        x, None, merge_step=mk.merge_update_argmin_plain, **kw)
    plain_s = time.perf_counter() - t0
    merges = len(got.merges)
    if not (np.array_equal(got.merges, ref.merges)
            and got.cluster_map == ref.cluster_map
            and got.dropped == ref.dropped):
        raise AssertionError(f"exact engine: K1 loop != twin loop at n={n}")
    _check_launches("engine", launches, merges)
    busy = None
    if DEVICE == "cuda":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ward._constrained_ward(x, None, merge_step=mk.merge_update_argmin,
                                   **kw)
            torch.cuda.synchronize()
        all_us = _kernel_us(prof)
        k1_us = _kernel_us(prof, ("merge_step_rows", "reduce_partials"))
        busy = {"device_s": all_us / 1e6, "k1_device_s": k1_us / 1e6,
                "device_busy_share": all_us / 1e6 / total_s,
                "k1_share_of_wall": k1_us / 1e6 / total_s}
    emit({"phase": "exact_engine", "card": card, "n": n, "d": d,
          "merges": merges, "k1_launches": launches,
          "ms_per_merge": total_s * 1e3 / max(merges, 1),
          "total_s": total_s, "plain_twin_total_s": plain_s,
          "clusters": got.n_clusters, "logs_identical": True,
          "profile": busy})


def _check_launches(what: str, launches: int, merges: int) -> None:
    from imageclust_tpu_torch.cluster.ward import FOUND_READ_EVERY

    if not merges <= launches <= merges + FOUND_READ_EVERY:
        raise AssertionError(
            f"{what}: {launches} K1 launches for {merges} merges (want "
            f"[merges, merges + {FOUND_READ_EVERY}])")


def _multipart(names, blobs, fields):
    bnd = uuid.uuid4().hex
    out = io.BytesIO()
    for k, v in fields.items():
        out.write(f'--{bnd}\r\nContent-Disposition: form-data; name="{k}"'
                  f'\r\n\r\n{v}\r\n'.encode())
    for name, blob in zip(names, blobs):
        out.write(f'--{bnd}\r\nContent-Disposition: form-data; '
                  f'name="images"; filename="{name}"\r\n'
                  f'Content-Type: image/bmp\r\n\r\n'.encode())
        out.write(blob)
        out.write(b"\r\n")
    out.write(f"--{bnd}--\r\n".encode())
    return out.getvalue(), f"multipart/form-data; boundary={bnd}"


def _http(base: str, path: str, body: bytes | None = None,
          ctype: str | None = None):
    req = urllib.request.Request(base + path, data=body)
    if ctype:
        req.add_header("Content-Type", ctype)
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.status, resp.headers.get("Content-Type", ""), resp.read()


def _check_sizes(clusters: dict, lo: int = 3, hi: int = 6) -> None:
    for key, c in clusters.items():
        if not lo <= len(c["images"]) <= hi:
            raise AssertionError(f"{key} has {len(c['images'])} images")


def phase_server(card: str):
    import numpy as np

    from imageclust_tpu_torch.config import AppConfig, ServiceConfig
    from imageclust_tpu_torch.ops import merge_kernels as mk
    from imageclust_tpu_torch.pipeline import Pipeline
    from imageclust_tpu_torch.service.app import create_server

    work = Path(tempfile.mkdtemp(prefix="imageclust_smoke_jobs_"))
    cfg = AppConfig(service=ServiceConfig(work_dir=str(work)))
    t0 = time.perf_counter()
    pipeline = Pipeline(cfg, device=DEVICE)
    build_s = time.perf_counter() - t0
    server = create_server(cfg, pipeline, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(11)
    small = group_images(rng, 3, 6, "")
    big = group_images(rng, SERVER_GROUPS, 5, "b")
    requests = []
    try:
        mk.launches = 0
        for label, (names, blobs, groups), query in (
                ("18_images", small, ""), ("200_images", big, ""),
                ("18_images_async", small, "?async=1")):
            body, ctype = _multipart(names, blobs, {"minClusterSize": 3,
                                                    "maxClusterSize": 6})
            if len(body) > cfg.service.max_upload_bytes:
                raise AssertionError(f"{label}: request is {len(body)} bytes")
            before = mk.launches
            t0 = time.perf_counter()
            status, _, raw = _http(base, "/api/cluster" + query, body, ctype)
            data = json.loads(raw)
            job = data.get("jobId")
            if query:
                if status != 202:
                    raise AssertionError(f"{label}: HTTP {status}")
                deadline = time.monotonic() + 600
                while time.monotonic() < deadline:
                    status, _, raw = _http(base, f"/api/result?job={job}")
                    data = json.loads(raw)
                    if "clusters" in data or data.get("status") == "failed":
                        break
                    time.sleep(0.05)
            wall_s = time.perf_counter() - t0
            if status != 200 or "clusters" not in data:
                raise AssertionError(f"{label}: HTTP {status} {data}")
            _check_sizes(data["clusters"])
            merges = int(data["metrics"]["counters"]["merges"])
            _check_launches(label, mk.launches - before, merges)
            placed = [m for c in data["clusters"].values()
                      for m in c["images"]]
            if sorted(placed + data["dropped"]) != sorted(names):
                raise AssertionError(f"{label}: images lost")
            if len(names) == 18:
                # 18 images under (3, 6) target 4 clusters, so one colour
                # group splits; every cluster must hold one group only, and
                # every group must lead at least one cluster (the reference
                # drops the members of an under-min cluster)
                by_name = dict(zip(names, groups))
                found = set()
                for key, c in data["clusters"].items():
                    gs = {by_name[m] for m in c["images"]}
                    if len(gs) != 1:
                        raise AssertionError(f"{label}: {key} mixes groups "
                                             f"{data['clusters']}")
                    found |= gs
                if found != set(groups):
                    raise AssertionError(f"{label}: groups {found}")
            metrics = data["metrics"]
            requests.append({
                "request": label, "images": len(names), "wall_s": wall_s,
                "stages_s": metrics["stages_s"],
                "embed_images_per_s": metrics.get("images_per_sec_embed"),
                "clusters": len(data["clusters"]),
                "sizes": sorted(len(c["images"])
                                for c in data["clusters"].values()),
                "dropped": len(data["dropped"]), "merges": merges,
                "k1_launches": mk.launches - before})
        main_path_launches = mk.launches
        for path in (f"/api/result?job={job}", "/api/view",
                     f"/api/image/{small[0][0]}", "/healthz"):
            status, ctype, raw = _http(base, path)
            if status != 200 or not raw:
                raise AssertionError(f"GET {path}: HTTP {status}")
            if path == "/healthz":
                health = json.loads(raw)
    finally:
        server.shutdown()
        server.server_close()
        server.service.wait_background(60)
        thread.join(60)
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "server", "card": card, "pipeline_build_s": build_s,
          "requests": requests, "healthz": health,
          "k1_launches": main_path_launches})
    return main_path_launches


def phase_cli(card: str):
    import numpy as np

    from imageclust_tpu_torch import cli
    from imageclust_tpu_torch.ops import merge_kernels as mk

    tmp = Path(tempfile.mkdtemp(prefix="imageclust_smoke_cli_"))
    try:
        rng = np.random.default_rng(5)
        names, blobs, _ = group_images(rng, CLI_GROUPS, 5, "c")
        img_dir = tmp / "images"
        img_dir.mkdir()
        for name, blob in zip(names, blobs):
            (img_dir / name).write_bytes(blob)
        out = io.StringIO()
        mk.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["run", "--images", str(img_dir), "--device",
                           DEVICE, "--out", str(tmp / "work")])
        wall_s = time.perf_counter() - t0
        launches = mk.launches
        if rc != 0:
            raise AssertionError(f"cli run exited {rc}")
        result = json.loads(out.getvalue())
        OUT.mkdir(parents=True, exist_ok=True)
        (OUT / "cli_result.json").write_text(out.getvalue())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _check_sizes(result["clusters"])
    counters = result["metrics"]["counters"]
    n = len(names)
    merges = int(counters["merges"])
    from imageclust_tpu_torch.cluster.ward import calculate_optimal_clusters

    if merges != n - calculate_optimal_clusters(n, 3, 6):
        raise AssertionError(f"cli: {merges} merges for {n} images")
    _check_launches("cli", launches, merges)
    placed = sum(len(c["images"]) for c in result["clusters"].values())
    if placed + len(result["dropped"]) != n:
        raise AssertionError("cli: images lost")
    emit({"phase": "cli_run", "card": card, "images": n, "wall_s": wall_s,
          "stages_s": result["metrics"]["stages_s"],
          "embed_images_per_s": result["metrics"].get("images_per_sec_embed"),
          "clusters": len(result["clusters"]), "merges": merges,
          "k1_launches": launches,
          "output": os.path.relpath(OUT / "cli_result.json", REPO)})


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not importable", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (REPO / "imageclust_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {REPO} is not a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from imageclust_tpu_torch.device import resolve_device

    resolve_device("cuda")  # TF32 off for the whole run
    card = phase_card_and_build()
    max_err, timings = phase_k1(card)
    phase_engine(card)
    launches = phase_server(card)
    phase_cli(card)
    t = timings[4096]
    emit({"kernels": [{
        "name": "merge_update_argmin",
        "route": "cuda",
        "source": "imageclust_tpu_torch/csrc/merge_update_argmin.cu",
        "replaces": "imageclust_tpu/ops/pallas_kernels.py:134",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": t["ms"],
        "call_ms": t["call_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "shape": "n=4096",
        "parity": "bit-identical",
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
