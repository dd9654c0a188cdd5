"""Closed loop of whole ``Pipeline.run_stream`` jobs from one client.

Set-up builds one ``Pipeline`` with the configuration's tower, its weights
made on the card from the seed and handed to the program's loader, and
runs one untimed job at the cell's own shapes (the kernels load from the
checkout's build cache, cuDNN chooses, the engine captures its CUDA
graphs, and with ``--trace 1`` the profiler starts once). Then jobs run
back to back: each gets fresh images from (seed, job index) and a new
work dir under ``TMPDIR``, since the naming resumes from a work dir's
state. The window opens as the first job starts; no job starts after
``--seconds``; the window closes when the last one completes.

After the window every job is judged (:mod:`benchmark.check`): the
program's embedding rows of a sample of each job's images are kept as the
embed stage returns them, and the reference tower runs on the same images
once the program is freed. For the jobs of the seed's reservoir sample
(``ward_jobs_per_run``) the whole buffer is kept too, and the plain Ward
runs on it to judge the engine's partition.
"""

from __future__ import annotations

import gc
import importlib
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark import check, traffic, weights
from benchmark.record import JobRecord, RunRecord
from benchmark.trace import TraceSummary, summarize


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


class _Capture:
    """Wraps the embedder's ``embed_stream_quantized`` and keeps, as
    float32, the rows ``idx`` of what it returns and, while ``whole`` is
    set, a copy of the whole buffer, taken on the device as the stream
    queues it (the host copy waits for the job's end)."""

    def __init__(self, embedder):
        self.orig = embedder.embed_stream_quantized
        self.whole = False
        self.idx = None
        self.rows = None
        self.buffer = None
        embedder.embed_stream_quantized = self

    def __call__(self, *args, **kwargs):
        emb, scale = self.orig(*args, **kwargs)
        if self.idx is not None:
            rows = emb.index_select(0, self.idx).float()
            self.rows = rows * scale if emb.dtype == torch.int8 else rows
        if self.whole:
            self.buffer = (emb.clone(), scale)
        return emb, scale

    def take_buffer(self):
        """The whole buffer of the last job, on the host, as float32."""
        if self.buffer is None:
            return None
        emb, scale = self.buffer
        self.buffer = None
        host = emb.cpu().float()
        return host * float(scale) if emb.dtype == torch.int8 else host


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(ctx) -> tuple[RunRecord, list[check.Check], int]:
    """Returns the run's record, its checks and the number of jobs that
    failed one."""
    from imageclust_tpu_torch.config import load_config
    from imageclust_tpu_torch.models import create_embedder
    from imageclust_tpu_torch.pipeline import Pipeline

    cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    family = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    adapter = importlib.import_module(f"benchmark.adapters.{cfg['reference']}")
    shape = family.shape_of(cfg["model"])
    inits = family.initializers(shape)
    marks = {"imports": time.perf_counter() - ctx.t_start}
    variables = adapter.to_program(weights.make(inits, seed, dev))
    marks["weights"] = time.perf_counter() - ctx.t_start
    app = load_config(overrides=_merge(cfg["program"], ctx.program_overrides),
                      environ={})
    embedder = create_embedder(app.embed, device=dev, variables=variables)
    del variables
    pipeline = Pipeline(app, device=dev, embedder=embedder)
    marks["program"] = time.perf_counter() - ctx.t_start
    if ctx.break_program is not None:
        ctx.break_program(pipeline)
    capture = _Capture(embedder)
    kept = {}  # the sampled jobs' whole buffers by reservoir slot
    size, batch = embedder.spec.input_size, embedder.batch_size
    n = int(tr["images_per_job"])
    lo, hi = int(tr["min_size"]), int(tr["max_size"])
    plan = traffic.group_plan(tr)

    def job(j: int):
        wd = tempfile.mkdtemp(prefix=f"job{j}_", dir=ctx.tmp)
        images = traffic.Job(tr, seed, j, size, batch, dev, plan)
        idx = traffic.sample_rows(tr, seed, j)
        capture.idx = torch.from_numpy(idx).to(dev)
        slot = traffic.ward_slot(tr, seed, j) if j >= 0 else None
        capture.whole = slot is not None
        t = time.perf_counter()
        res = pipeline.run_stream(
            images.chunks(), n, wd, min_size=lo, max_size=hi,
            profile_dir=os.path.join(wd, "trace") if ctx.trace else None)
        _sync(dev)
        wall = time.perf_counter() - t
        if slot is not None:
            kept[slot] = (j, capture.take_buffer())
        return res, wd, wall, capture.rows

    if ctx.warm:
        shutil.rmtree(job(-1)[1])
    _sync(dev)
    marks["warm_job"] = time.perf_counter() - ctx.t_start
    ctx.readings.append({"setup_marks_s": marks})
    cuda = dev.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    rec = RunRecord(ctx.cell, cfg, tr, seed, ctx.seconds,
                    flops_per_image=family.flops_per_image(shape))
    t_open = time.perf_counter()
    rec.setup_s = t_open - ctx.t_start
    done = []
    while not done or time.perf_counter() - t_open < ctx.seconds:
        done.append(job(len(done)))
    rec.window_s = time.perf_counter() - t_open
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    rec.window_peak_bytes = window_peak
    rec.memory_peak_bytes = max(setup_peak, window_peak)

    for res, wd, wall, *_ in done:
        md = res.metrics.to_dict()
        rec.jobs.append(JobRecord(n, wall, md["stages_s"], md["counters"]))
    if ctx.trace:
        rec.trace = TraceSummary()
        for res, wd, *_ in done:
            path = os.path.join(wd, "trace", "trace.json")
            rec.trace.add(summarize(path, set(res.metrics.stages)))
            os.remove(path)

    # the program's state goes before the reference runs
    del pipeline, embedder, capture
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    buffers = dict(kept.values())
    checks, failed = _judge(ctx, family, shape, inits, app, plan, batch,
                            done, buffers)
    for _res, wd, *_ in done:
        shutil.rmtree(wd, ignore_errors=True)
    return rec, checks, failed


def _judge(ctx, family, shape, inits, app, plan, batch, done, buffers):
    tr, dev, seed, limits = ctx.traffic, ctx.device, ctx.seed, ctx.limits
    n = int(tr["images_per_job"])
    lo, hi = int(tr["min_size"]), int(tr["max_size"])
    w = weights.make(inits, seed, dev)
    worst = dict.fromkeys(limits, 0)
    failed = 0
    for j, (res, wd, wall, rows) in enumerate(done):
        images = traffic.Job(tr, seed, j, shape.image_size, batch, dev, plan)
        ref = family.embed(w, shape, images.rows(
            traffic.sample_rows(tr, seed, j)))
        clusters, dropped = check.members_of(res.clusters, res.dropped)
        sq = check.tower_sq_err(rows, ref)
        mine = {
            "tower_sq_err": float(sq.max()),
            "partition_faults": check.partition_faults(
                clusters, dropped, n, lo, hi, res.metrics.counters),
            "unnamed_clusters": check.unnamed_clusters(
                res.clusters, app.naming.max_clusters),
            "report_faults": check.report_faults(
                wd, len(clusters), n - len(dropped),
                app.service.report_page_size),
        }
        if j in buffers and mine["partition_faults"] == 0:
            mine["ward_excess"] = check.ward_excess(
                buffers.pop(j).to(dev), clusters, lo, hi)
        if ctx.extra:
            ctx.readings.append(control_readings(
                j, res, wall, rows, ref, sq, clusters, dropped,
                images.z.cpu().numpy(), mine))
        mine = {k: v for k, v in mine.items() if k in limits}
        failed += any(v > limits[k] for k, v in mine.items())
        for k, v in mine.items():
            worst[k] = max(worst[k], v)
    del w
    return [check.Check(k, v, limits[k]) for k, v in worst.items()], failed


def control_readings(j, res, wall, rows, ref, sq, clusters, dropped, z,
                     mine) -> dict:
    """What :mod:`benchmark.control` prints of one job beside its checks:
    the stages, the rows' errors, and the share of images whose cluster
    neither lies inside their scene's near-duplicates nor holds all of
    them (dropped images count)."""
    cos = torch.nn.functional.cosine_similarity(rows.double(), ref.double())
    base_size = np.bincount(z)
    misplaced = len(dropped)
    for c in clusters:
        ids, counts = np.unique(z[c], return_counts=True)
        if len(ids) > 1:
            misplaced += int(counts[counts != base_size[ids]].sum())
    return {"job": j, "wall_s": wall, "stages_s": res.metrics.stages,
            "rel_max": float(sq.max() ** 0.5),
            "one_minus_cos_max": float((1 - cos).max()),
            "misplaced_share": misplaced / len(z),
            "clusters": len(clusters), "dropped": len(dropped), **mine}
