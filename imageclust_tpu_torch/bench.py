"""Benchmark harness of the PyTorch port: the JAX package's ``bench.py``
modes on one CUDA card.

    python -m imageclust_tpu_torch.bench [--e2e-stream | --cluster-only |
        --embed-only | --e2e-real | --decode | --quality] [--device cuda]

(or ``python -m imageclust_tpu_torch.cli bench ...``). The default mode
embeds ``--n`` synthetic images through ResNet50 (device-side preprocess
included) and clusters the features with the bucketed constrained-Ward
engine: the two compute cores of a job. The flags, their defaults and the
metric names are bench.py's letter for letter, plus ``--device``
(default ``cuda``; without a card it raises, it never drops to the CPU).

Prints ONE JSON line on stdout,
``{"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...}``, and the
detail (bench.py's keys plus ``device``: the card's name and power limit as
``nvidia-smi`` gives them and the device count, or ``"cpu"``) on stderr.

Where it differs from bench.py:

* Timing is a host clock around work that ends in
  ``torch.cuda.synchronize()``. Kernel builds, cuDNN's first-call choices
  and CUDA graph captures happen in untimed warm runs, as the JAX compiles
  do in bench.py. There is no compile cache to enable.
* ``vs_baseline`` is null in the four modes where bench.py divides by the
  JAX package's north star, a TPU figure, which is no target for the port
  (ROADMAP): e2e, e2e-stream, e2e-real and cluster-only.
* ``--embed-only`` counts one batch's FLOPs with
  ``torch.utils.flop_counter.FlopCounterMode`` (a multiply-add is 2, as in
  XLA's cost analysis) and reports ``gflops_per_img``; on the card also
  ``pct_peak`` against the H100's published dense peak for the tower's
  product dtype, where bench.py reports a TPU measurement's share.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np
import torch

from imageclust_tpu_torch.cluster.chain import constrained_ward_chain
from imageclust_tpu_torch.cluster.sharded import constrained_ward_bucketed
from imageclust_tpu_torch.cluster.ward import constrained_ward
from imageclust_tpu_torch.config import EmbedConfig
from imageclust_tpu_torch.device import resolve_device
from imageclust_tpu_torch.models.registry import create_embedder

__all__ = [
    "bench_e2e",
    "bench_e2e_stream",
    "bench_e2e_real",
    "bench_decode",
    "bench_embed_only",
    "bench_cluster_only",
    "bench_quality",
    "add_arguments",
    "run",
    "main",
]

# H100 SXM data sheet, dense: the towers' products run in bf16, or in int8
# for the PTQ towers (operations per second)
PEAK_OPS_PER_S = {"": 989e12, "int8": 1979e12}


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _device_info(dev: torch.device):
    """``"cpu"``, or the card as ``nvidia-smi`` names it, with its power
    limit, and the device count."""
    if dev.type != "cuda":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    lines = smi.stdout.strip().splitlines()
    return {"card": lines[dev.index if dev.index < len(lines) else 0],
            "count": torch.cuda.device_count()}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _build_kernels(dev: torch.device) -> None:
    """Build the card's kernels before a timed region that launches them
    without an untimed run of the same work first."""
    if dev.type == "cuda":
        from imageclust_tpu_torch.ops._build import load_kernels

        load_kernels()


def _generator(dev: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def bench_e2e(n_images: int, batch_size: int, bucket_size: int,
              quantize: str = "", device=None) -> dict:
    """Embed ``n_images`` synthetic images through ResNet50 (logits) and
    cluster the features, which stay on the device, with the bucketed
    engine under Lance-Williams."""
    dev = resolve_device(device)
    info = _device_info(dev)
    _log(f"device: {info}")
    embedder = create_embedder(
        EmbedConfig(model="resnet50", batch_size=batch_size, output="logits",
                    quantize=quantize), device=dev)
    fwd = embedder._forward
    # one seeded uint8 batch on the device; batch j adds j * 37 % 251 to it
    # (uint8 wraps), a cheap elementwise pass instead of a draw per batch
    base = torch.randint(0, 256, (embedder.batch_size, 224, 224, 3),
                         generator=_generator(dev, 0), device=dev,
                         dtype=torch.uint8)

    def synth_batch(j: int) -> torch.Tensor:
        return base + (j * 37 % 251)

    t0 = time.perf_counter()
    fwd(synth_batch(0))
    _sync(dev)
    _log(f"warmup embed: {time.perf_counter() - t0:.1f}s")

    n_batches = -(-n_images // embedder.batch_size)

    def embed_all():
        # The host waits on the event recorded one group of 8 batches back,
        # never on the batch just queued, so the card's queue never drains
        chunks = []
        fence = None
        for i in range(0, n_batches, 8):
            chunks += [fwd(synth_batch(j)).float()
                       for j in range(i, min(i + 8, n_batches))]
            if dev.type == "cuda":
                if fence is not None:
                    fence.synchronize()
                fence = torch.cuda.Event()
                fence.record()
        feats = torch.cat(chunks)[:n_images]
        _sync(dev)
        return feats

    def cluster_all(feats):
        res = constrained_ward_bucketed(
            feats, min_size=3, max_size=6, bucket_size=bucket_size,
            update_rule="lance_williams", device=dev)
        _sync(dev)
        return res

    # one untimed pass of both stages: the kernels' build, cuDNN's choices
    t0 = time.perf_counter()
    cluster_all(embed_all())
    _log(f"warmup cluster: {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    feats = embed_all()
    t_embed = time.perf_counter() - t0
    _log(f"embed: {n_images} imgs in {t_embed:.2f}s "
         f"({n_images / t_embed:.0f} img/s/chip)")

    t0 = time.perf_counter()
    res = cluster_all(feats)
    t_cluster = time.perf_counter() - t0
    _log(f"cluster: {res.n_clusters} clusters in {t_cluster:.2f}s "
         f"({len(res.dropped)} dropped)")

    total = t_embed + t_cluster
    return {
        "metric": f"e2e_embed+ward_{n_images // 1000}k_images",
        "value": round(total, 3),
        "unit": "s",
        "vs_baseline": None,
        "detail": {
            "embed_s": round(t_embed, 3),
            "cluster_s": round(t_cluster, 3),
            "images_per_sec_chip": round(n_images / t_embed, 1),
            "n_clusters": res.n_clusters,
            "device": info,
        },
    }


def bench_e2e_stream(n_images: int, model: str, batch_size: int,
                     bucket_size: int, feature_dtype: str,
                     work_dir: str, n_base: int = 2048,
                     device=None) -> dict:
    """One ``Pipeline.run_stream`` job: synthetic ingest on the device,
    streamed embed into the residency buffer, the bucketed engine, the fake
    namer (one retry) and the sectioned report written for every cluster.
    Walls come from the pipeline's stage metrics, and the report's page
    count is checked against the cluster count.

    Images are ``n_base`` seeded base patterns in [0, 200) plus per-item
    noise ``bits & 55`` (uint8 end to end: 199 + 55 does not wrap)."""
    from imageclust_tpu_torch.config import (
        AppConfig,
        ClusterConfig,
        LabelConfig,
        NamingConfig,
    )
    from imageclust_tpu_torch.pipeline import Pipeline

    dev = resolve_device(device)
    info = _device_info(dev)
    _log(f"device: {info}")
    cfg = AppConfig(
        embed=EmbedConfig(model=model, batch_size=batch_size),
        labels=LabelConfig(backend="none"),
        naming=NamingConfig(services=("fake",), retries=1),
        cluster=ClusterConfig(bucket_size=bucket_size,
                              feature_dtype=feature_dtype),
    )
    pipeline = Pipeline(cfg, device=dev)
    bs = pipeline.embedder.batch_size
    s = pipeline.embedder.spec.input_size
    base = torch.randint(0, 200, (n_base, s, s, 3), generator=_generator(
        dev, 0), device=dev, dtype=torch.uint8)

    def synth(i: int) -> torch.Tensor:
        gen = _generator(dev, i + 1)
        z = torch.randint(0, n_base, (bs,), generator=gen, device=dev)
        noise = torch.randint(0, 256, (bs, s, s, 3), generator=gen,
                              device=dev, dtype=torch.uint8)
        return base[z] + (noise & 55)

    def chunk_iter():
        for i in range(-(-n_images // bs)):
            c = min(bs, n_images - i * bs)
            out = synth(i)
            yield out if c == bs else out[:c]

    # the synth and embed warm-up, and the kernels' build, outside the wall
    t0 = time.perf_counter()
    pipeline.embedder._forward(synth(0))
    _build_kernels(dev)
    _sync(dev)
    _log(f"warmup embed+synth: {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    res = pipeline.run_stream(chunk_iter(), n_images, work_dir,
                              min_size=3, max_size=6)
    _sync(dev)
    total = time.perf_counter() - t0

    md = res.metrics.to_dict()
    stages = {k: round(v, 2) for k, v in md["stages_s"].items()}
    counters = md["counters"]
    n_clusters = counters["clusters"]
    pages = len(glob.glob(os.path.join(work_dir, "clusters_p*.html")))
    sections = len(glob.glob(os.path.join(work_dir, "clusters_ix*.html")))
    page_size = cfg.service.report_page_size
    expect_pages = -(-n_clusters // page_size)
    _log(f"e2e-stream n={n_images}: {total:.1f}s total, stages {stages}, "
         f"{n_clusters} clusters, {counters.get('dropped', 0)} dropped, "
         f"naming_skipped={counters.get('naming_skipped', 0)}, "
         f"report: {pages} pages / {sections} sections "
         f"(expect {expect_pages} pages)")
    if not (pages == expect_pages or n_clusters <= page_size):
        raise RuntimeError(f"report has {pages} pages, expected "
                           f"{expect_pages} for {n_clusters} clusters")
    return {
        "metric": f"e2e_stream_{n_images // 1000}k_images[{model} "
                  f"{feature_dtype}]",
        "value": round(total, 3),
        "unit": "s",
        "vs_baseline": None,
        "detail": {
            "stages_s": stages,
            "n_clusters": n_clusters,
            "dropped": counters.get("dropped", 0),
            "naming_skipped": counters.get("naming_skipped", 0),
            "report_pages": pages,
            "report_sections": sections,
            "model": model,
            "feature_dtype": feature_dtype,
            "device": info,
        },
    }


def _cv2(mode: str):
    try:
        import cv2
    except ImportError as exc:
        raise RuntimeError(f"{mode} needs cv2 (OpenCV) to encode its "
                           "JPEGs, and it is not importable") from exc
    return cv2


def _ensure_real_jpegs(n: int, root: str) -> list:
    """Write n distinct small JPEGs under ``root`` once (kept across
    runs): bench.py's images, byte for byte."""
    cv2 = _cv2("--e2e-real")
    d = os.path.join(root, f"real_{n}")
    marker = os.path.join(d, ".complete")
    if os.path.exists(marker):
        return [os.path.join(d, f"{i:07d}.jpg") for i in range(n)]
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(0)
    # structured images (16 bases, one channel shifted per item): cheap to
    # encode, some cluster structure, about 8-15 KB each
    base = rng.integers(0, 256, (16, 240, 320, 3), dtype=np.uint8)
    t0 = time.perf_counter()
    for i in range(n):
        img = base[i % 16].copy()
        img[:, :, i % 3] = (img[:, :, i % 3] // 4) + (i * 29) % 192
        ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 80])
        if not ok:
            raise RuntimeError(f"cv2.imencode failed on image {i}")
        with open(os.path.join(d, f"{i:07d}.jpg"), "wb") as fh:
            fh.write(enc.tobytes())
        if i % 20000 == 19999:
            _log(f"  generated {i + 1}/{n} jpegs "
                 f"({time.perf_counter() - t0:.0f}s)")
    open(marker, "w").close()
    return [os.path.join(d, f"{i:07d}.jpg") for i in range(n)]


def _max_rss_gb() -> float:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def bench_e2e_real(n_images: int, batch_size: int, bucket_size: int,
                   workers: int, data_dir: str, device=None) -> dict:
    """n JPEGs on disk -> streamed read and decode -> embed on the device
    -> constrained Ward, with bounded host memory; reports peak RSS beside
    the wall time."""
    from imageclust_tpu_torch.data.loader import stream_decode

    dev = resolve_device(device)
    info = _device_info(dev)
    _log(f"device: {info}")
    paths = _ensure_real_jpegs(n_images, data_dir)
    rss_after_gen = _max_rss_gb()

    embedder = create_embedder(
        EmbedConfig(model="resnet50", batch_size=batch_size, output="logits"),
        device=dev)
    warm = np.zeros((embedder.batch_size, 224, 224, 3), np.uint8)
    t0 = time.perf_counter()
    embedder.embed_stream([warm])
    _build_kernels(dev)
    _sync(dev)
    _log(f"warmup embed: {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    feats = embedder.embed_stream(
        imgs for _s, _b, imgs in stream_decode(
            paths, size=224, batch=batch_size, workers=workers))
    _sync(dev)
    t_embed = time.perf_counter() - t0
    _log(f"stream ingest+embed: {n_images} jpegs in {t_embed:.2f}s "
         f"({n_images / t_embed:.0f} img/s), peak RSS {_max_rss_gb():.2f} GB")

    t0 = time.perf_counter()
    res = constrained_ward_bucketed(
        feats, min_size=3, max_size=6, bucket_size=bucket_size,
        update_rule="lance_williams", device=dev)
    _sync(dev)
    t_cluster = time.perf_counter() - t0
    _log(f"cluster: {res.n_clusters} clusters in {t_cluster:.2f}s "
         f"({len(res.dropped)} dropped)")

    total = t_embed + t_cluster
    return {
        "metric": f"e2e_real_jpeg_{n_images // 1000}k_images",
        "value": round(total, 3),
        "unit": "s",
        "vs_baseline": None,
        "detail": {
            "ingest_embed_s": round(t_embed, 3),
            "cluster_s": round(t_cluster, 3),
            "images_per_sec": round(n_images / t_embed, 1),
            "peak_rss_gb": round(_max_rss_gb(), 2),
            "rss_after_datagen_gb": round(rss_after_gen, 2),
            "n_clusters": res.n_clusters,
            "dropped": len(res.dropped),
            "device": info,
        },
    }


def bench_decode(n_images: int, workers: int, device=None) -> dict:
    """The host ingest stage: decode and resize n copies of one JPEG into a
    uint8 batch."""
    from imageclust_tpu_torch.data.loader import decode_images

    info = _device_info(resolve_device(device))
    cv2 = _cv2("--decode")
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
    ok, enc = cv2.imencode(".jpg", img)
    if not ok:
        raise RuntimeError("cv2.imencode failed")
    blobs = [enc.tobytes()] * n_images
    decode_images(blobs[:16], size=224, workers=workers)  # warm pools
    t0 = time.perf_counter()
    batch = decode_images(blobs, size=224, workers=workers)
    dt = time.perf_counter() - t0
    if batch.shape != (n_images, 224, 224, 3):
        raise RuntimeError(f"decoded batch has shape {batch.shape}")
    _log(f"decode: {n_images} jpegs in {dt:.2f}s ({n_images / dt:.0f} img/s, "
         f"{workers} workers)")
    return {
        "metric": f"host_decode_{n_images}_jpegs",
        "value": round(dt, 3),
        "unit": "s",
        "vs_baseline": round(n_images / dt, 1),
        "detail": {"images_per_sec": round(n_images / dt, 1),
                   "device": info},
    }


def _synth_features(n: int, d: int, dt: torch.dtype, *,
                    one_shot_elems: int = 1 << 30,
                    block_elems: int = 512 << 20,
                    device=None) -> torch.Tensor:
    """Gaussian (n, d) features on the device from a seeded generator.

    Up to ``one_shot_elems`` one draw; above it, row blocks of
    ``block_elems`` written into a preallocated buffer, so the extra memory
    is one block. The start of the last block is clamped to ``n - block``,
    as ``dynamic_update_slice`` clamps it in bench.py: it draws the tail's
    overlap again, so every row is still i.i.d. normal. int8: the normal
    draw times 127 / 3.5, rounded and clipped to [-127, 127] (the grid
    ``_feat_int8`` gives Gaussian features)."""
    dev = resolve_device(device)
    gen = _generator(dev, 0)

    def draw(shape):
        if dt == torch.int8:
            g = torch.randn(shape, generator=gen, device=dev) * (127.0 / 3.5)
            return torch.clamp(torch.round(g), -127, 127).to(torch.int8)
        return torch.randn(shape, generator=gen, device=dev, dtype=dt)

    if n * d <= one_shot_elems:
        return draw((n, d))
    block = min(n, max(1, block_elems // max(d, 1)))
    buf = torch.zeros((n, d), dtype=dt, device=dev)
    for i in range(-(-n // block)):
        start = min(i * block, n - block)
        buf[start:start + block] = draw((block, d))
    return buf


def _int_mm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs):
    """``torch._int_mm`` of (m, k) by (k, n): 2 m k n, as a matmul."""
    (m, k), (_, n) = a_shape, b_shape
    return 2 * m * k * n


def _flops_per_batch(embedder, batch: torch.Tensor) -> float:
    """FLOPs of one forward of ``batch`` (a multiply-add is 2). The int8
    GEMMs (``torch._int_mm``) count as matmuls. K5 on the card is a ctypes
    launch the counter cannot see: each launch during the count adds its
    two products, 4 * B * T^2 * H * Dh."""
    from torch.utils.flop_counter import FlopCounterMode

    from imageclust_tpu_torch.models.vit import VIT_CONFIGS
    from imageclust_tpu_torch.ops._build import launches

    before = launches["short_seq_attention"]
    with FlopCounterMode(display=False, custom_mapping={
            torch.ops.aten._int_mm: _int_mm_flops}) as counter:
        embedder._forward(batch)
    flops = float(counter.get_total_flops())
    k5 = launches["short_seq_attention"] - before
    if k5:
        vc = VIT_CONFIGS[embedder.spec.name]
        t = (vc.image_size // vc.patch) ** 2 + int(vc.use_class_token)
        flops += k5 * 4.0 * batch.shape[0] * t * t * vc.width
    return flops


def bench_embed_only(model: str, batch_size: int, n_images: int,
                     quantize: str = "", device=None) -> dict:
    """Warm steady-state embed throughput of one tower (any registry model,
    optionally int8) on synthetic uint8 batches at its input size."""
    dev = resolve_device(device)
    info = _device_info(dev)
    _log(f"device: {info}")
    embedder = create_embedder(
        EmbedConfig(model=model, batch_size=batch_size, quantize=quantize),
        device=dev)
    bs = embedder.batch_size
    s = embedder.spec.input_size
    fwd = embedder._forward
    batch = torch.randint(0, 256, (bs, s, s, 3), generator=_generator(dev, 0),
                          device=dev, dtype=torch.uint8)
    fwd(batch)  # warm: the kernels' build, cuDNN's choices
    gflops_img = _flops_per_batch(embedder, batch) / bs / 1e9
    n_batches = max(1, n_images // bs)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n_batches):
        fwd(batch)
    _sync(dev)
    dt = time.perf_counter() - t0
    ips = n_batches * bs / dt
    q = f"+{quantize}" if quantize else ""
    detail = {"model": model, "batch": bs, "quantize": quantize,
              "batches": n_batches, "wall_s": round(dt, 3),
              "gflops_per_img": round(gflops_img, 2), "device": info}
    if dev.type == "cuda":
        tfs = ips * gflops_img / 1e3
        peak = PEAK_OPS_PER_S[quantize] / 1e12
        detail.update({"tf_per_s": round(tfs, 1), "peak_tflops": peak,
                       "pct_peak": round(100.0 * tfs / peak, 1)})
    return {
        "metric": f"embed_img_per_s[{model}{q} b{bs}]",
        "value": round(ips, 1),
        "unit": "img/s/chip",
        "vs_baseline": round(ips / 1.0, 1),  # reference: serialized CPU
        "detail": detail,
    }


def bench_cluster_only(n: int, d: int, bucket_size: int,
                       engine: str = "auto",
                       feature_dtype: str = "float32", device=None) -> dict:
    """Constrained Ward alone over synthetic features. ``engine``: "auto"
    (the exact engine up to 4096 items, bucketed above), "bucketed", or
    "chain" (nearest-neighbour chains: exact greedy semantics in O(n*d)
    memory)."""
    dev = resolve_device(device)
    info = _device_info(dev)
    # drawn in the residency dtype: an f32 original beside a bf16 working
    # copy would waste n*d*4 bytes of device memory
    gen_dt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "int8": torch.int8}[feature_dtype]
    feats = _synth_features(n, d, gen_dt, device=dev)

    def run():
        if engine == "chain":
            res = constrained_ward_chain(feats, min_size=3, max_size=6,
                                         device=dev)
        elif engine == "auto" and n <= 4096:
            # bench.py hands the exact engine a host array, which it reads
            # as float32
            res = constrained_ward(feats.float(), min_size=3, max_size=6,
                                   update_rule="lance_williams", device=dev)
        else:
            res = constrained_ward_bucketed(
                feats, min_size=3, max_size=6, bucket_size=bucket_size,
                update_rule="lance_williams", feature_dtype=feature_dtype,
                device=dev)
        _sync(dev)
        return res

    t0 = time.perf_counter()
    run()
    _log(f"warmup cluster: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    res = run()
    dt = time.perf_counter() - t0
    _log(f"cluster-only n={n} d={d}: {dt:.2f}s, {res.n_clusters} "
         f"clusters, {len(res.dropped)} dropped")
    return {
        "metric": f"ward_cluster_{n}_items",
        "value": round(dt, 3),
        "unit": "s",
        "vs_baseline": None,
        "detail": {"n_clusters": res.n_clusters, "d": d,
                   "engine": engine, "dropped": len(res.dropped),
                   "feature_dtype": feature_dtype, "device": info},
    }


def bench_quality(n: int, d: int, sep: float, towers: str,
                  batch_size: int, device=None) -> dict:
    """The non-parity quality scoreboard: partition agreement of every
    precision-caveated mode against the f32 parity engine on overlapping
    synthetic mixtures. The ``f32_seed_yardstick`` row is the unit: the
    f32 engine against itself under another k-means seed.

    vs_baseline = (min mode ARI) / (yardstick ARI): above 1.0 every
    non-parity mode diverges less from the parity run than the engine's
    own bucketing randomness does."""
    from imageclust_tpu_torch.cluster.quality import (
        fusion_scoreboard,
        ptq_scoreboard,
        residency_scoreboard,
    )

    dev = resolve_device(device)
    info = _device_info(dev)
    rows = {}
    t0 = time.perf_counter()
    sb = residency_scoreboard(n, d, sep=sep, device=dev)
    _log(f"residency scoreboard n={n} d={d} sep={sep} "
         f"({time.perf_counter() - t0:.1f}s):")
    for mode, row in sb.items():
        _log(f"  {mode}: {json.dumps(row)}")
        if mode not in ("f32", "f32_seed_yardstick"):
            rows[f"residency_{mode}"] = row
    yard = sb["f32_seed_yardstick"]["ari"]

    n_fuse = min(n, 20_000)
    t0 = time.perf_counter()
    fuse = fusion_scoreboard(n_fuse, d, sep=sep, device=dev)
    _log(f"fusion text-vs-onehot n={n_fuse} "
         f"({time.perf_counter() - t0:.1f}s): {json.dumps(fuse)}")
    rows["fusion_text"] = fuse

    for tower in [t for t in towers.split(",") if t]:
        n_t = min(n, 10_000)
        t0 = time.perf_counter()
        row = ptq_scoreboard(tower, n_t, batch_size=batch_size, device=dev)
        _log(f"ptq int8 tower={tower} n={n_t} "
             f"({time.perf_counter() - t0:.1f}s): {json.dumps(row)}")
        rows[f"ptq_{tower}"] = row

    mode_aris = {k: v["ari"] for k, v in rows.items()}
    worst = min(mode_aris, key=mode_aris.get)
    return {
        "metric": f"quality_nonparity_min_ari[n{n} d{d} sep{sep}]",
        "value": mode_aris[worst],
        "unit": "ari_vs_f32_parity",
        "vs_baseline": round(mode_aris[worst] / max(yard, 1e-9), 3),
        "detail": {"worst_mode": worst, "seed_yardstick_ari": yard,
                   "modes": rows, "device": info},
    }


def add_arguments(parser: argparse.ArgumentParser) -> None:
    """bench.py's flags and defaults, plus ``--device``."""
    parser.add_argument("--n", type=int, default=100_000)
    parser.add_argument("--batch", type=int, default=0,
                        help="0 = per-mode default: 512 for the e2e "
                             "resnet50 benches, the tower's DEFAULT_BATCH "
                             "for --embed-only")
    parser.add_argument("--bucket", type=int, default=256)
    parser.add_argument("--decode", action="store_true",
                        help="benchmark the host decode stage instead")
    parser.add_argument("--e2e-real", action="store_true",
                        help="end-to-end over real JPEG files on disk via "
                             "the streamed bounded-memory ingest")
    parser.add_argument("--e2e-stream", action="store_true",
                        help="ONE real Pipeline.run_stream job: synthetic "
                             "ingest on the device -> streamed embed -> "
                             "bucketed cluster -> naming -> full sectioned "
                             "report (uses --model, --feature-dtype, "
                             "--bucket, --work-dir)")
    parser.add_argument("--work-dir", default=".bench_e2e_stream",
                        help="job work dir for --e2e-stream (the report "
                             "tree is written here)")
    parser.add_argument("--data-dir", default=".bench_data",
                        help="cache dir for generated benchmark JPEGs")
    parser.add_argument("--cluster-only", action="store_true",
                        help="benchmark constrained Ward alone")
    parser.add_argument("--embed-only", action="store_true",
                        help="benchmark one tower's warm embed throughput")
    parser.add_argument("--model", default="resnet50",
                        help="tower for --embed-only and --e2e-stream (any "
                             "registry model)")
    parser.add_argument("--d", type=int, default=64,
                        help="feature dim for --cluster-only")
    parser.add_argument("--quantize", default="", choices=["", "int8"],
                        help="quantized embed tower for the e2e and "
                             "--embed-only benches (non-parity embeddings)")
    parser.add_argument("--feature-dtype", default="float32",
                        choices=["float32", "bfloat16", "int8"],
                        help="bucketed-engine feature residency dtype for "
                             "--cluster-only and --e2e-stream (non-parity "
                             "below float32)")
    parser.add_argument("--engine", default="auto",
                        choices=["auto", "bucketed", "chain"],
                        help="cluster engine for --cluster-only")
    parser.add_argument("--workers", type=int, default=8)
    parser.add_argument("--quality", action="store_true",
                        help="non-parity quality scoreboard: partition "
                             "agreement of bf16/int8 residency, text "
                             "fusion, and (--towers) int8 PTQ towers vs "
                             "the f32 parity engine on overlapping "
                             "mixtures")
    parser.add_argument("--sep", type=float, default=1.0,
                        help="mixture separation for --quality (1.0 = "
                             "heavy overlap, >=8 = separated blobs)")
    parser.add_argument("--towers", default="",
                        help="comma-separated towers for the --quality "
                             "int8 PTQ stage (e.g. resnet50,vit_b32)")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu")


def run(args: argparse.Namespace) -> int:
    """Run the mode ``args`` selects; print the detail on stderr and the
    result line on stdout."""
    dev = args.device
    if args.quality:
        result = bench_quality(args.n, args.d, args.sep, args.towers,
                               args.batch, device=dev)
    elif args.decode:
        result = bench_decode(min(args.n, 10_000), args.workers, device=dev)
    elif args.e2e_real:
        result = bench_e2e_real(args.n, args.batch or 512, args.bucket,
                                args.workers, args.data_dir, device=dev)
    elif args.e2e_stream:
        result = bench_e2e_stream(args.n, args.model, args.batch,
                                  args.bucket, args.feature_dtype,
                                  args.work_dir, device=dev)
    elif args.cluster_only:
        result = bench_cluster_only(args.n, args.d, args.bucket, args.engine,
                                    args.feature_dtype, device=dev)
    elif args.embed_only:
        result = bench_embed_only(args.model, args.batch, args.n,
                                  args.quantize, device=dev)
    else:
        result = bench_e2e(args.n, args.batch or 512, args.bucket,
                           args.quantize, device=dev)
    detail = result.pop("detail")
    _log(f"detail: {json.dumps(detail)}")
    print(json.dumps(result), flush=True)
    return 0


def main(argv: list[str] | None = None) -> int:
    if os.environ.get("IMAGECLUST_CLUSTER_PROFILE"):
        # the engine's per-phase INFO lines on stderr
        logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    parser = argparse.ArgumentParser(prog="imageclust_tpu_torch.bench")
    add_arguments(parser)
    return run(parser.parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
