"""Faults planted under a run's timed path, for the tests and the readings
that show the checks fail on them. Each takes the built ``Pipeline`` and
breaks it in place through its public surface. No benchmark run plants
one.

* ``half_batch``: half of every chunk's rows are never embedded (left at
  zero), the rest as computed.
* ``row``: every 64th embedding row altered by a tenth of its norm where
  the stream returns it.
* ``shuffle``: a fifth of the engine's clusters (at least two, drawn
  from a fixed seed) trade their members among themselves where the
  engine returns them, sizes kept: answers altered where they are made.
* ``oversize``: one cluster padded past the size bound with repeats of
  its members.
* ``unnamed``: one cluster's title and namer outputs dropped.
* ``report``: one page of the report removed.

(A cell on one card has no exchange between chips, and a job carries no
state from step to step, so those faults do not apply.)
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch


def _wrap_embed(pipeline, fn) -> None:
    emb = pipeline.embedder
    orig = emb.embed_stream_quantized

    def broken(*args, **kwargs):
        out, scale = orig(*args, **kwargs)
        with torch.inference_mode():  # the stream's buffer is one
            return fn(out, emb.batch_size), scale

    emb.embed_stream_quantized = broken


def _wrap_result(pipeline, fn) -> None:
    orig = pipeline.run_stream

    def broken(*args, **kwargs):
        res = orig(*args, **kwargs)
        fn(res, args[2] if len(args) > 2 else kwargs["work_dir"], kwargs)
        return res

    pipeline.run_stream = broken


def half_batch(pipeline) -> None:
    def fn(out, bs):
        rows = torch.arange(out.shape[0], device=out.device)
        out[(rows % bs) >= bs // 2] = 0
        return out

    _wrap_embed(pipeline, fn)


def row(pipeline) -> None:
    def fn(out, _bs):
        sel = out[::64].float()
        bump = 0.1 * sel.norm(dim=1, keepdim=True) / sel.shape[1] ** 0.5
        out[::64] = (sel + bump).to(out.dtype)
        return out

    _wrap_embed(pipeline, fn)


def shuffle(pipeline) -> None:
    orig = pipeline._cluster_big

    def broken(*args, **kwargs):
        res = orig(*args, **kwargs)
        rng = np.random.default_rng(0)
        if res._members is not None:
            off = np.asarray(res._offsets)
            k = len(off) - 1
            pick = rng.choice(k, min(k, max(2, k // 5)), replace=False)
            pos = np.concatenate([np.arange(off[c], off[c + 1])
                                  for c in pick])
            mem = np.asarray(res._members)
            mem[pos] = mem[rng.permutation(pos)]
            res._members = mem
        else:  # the single-bucket hand-off keeps an index map
            keys = sorted(res._index_map)
            k = len(keys)
            pick = [keys[i] for i in rng.choice(
                k, min(k, max(2, k // 5)), replace=False)]
            pool = rng.permutation(np.concatenate(
                [np.asarray(res._index_map[c]) for c in pick]))
            start = 0
            for c in pick:
                size = len(res._index_map[c])
                res._index_map[c] = pool[start:start + size].tolist()
                start += size
        return res

    pipeline._cluster_big = broken


def oversize(pipeline) -> None:
    def fn(res, _wd, kw):
        d = res.clusters[sorted(res.clusters)[0]]
        d.images += d.images[:kw["max_size"] + 1 - len(d.images)]

    _wrap_result(pipeline, fn)


def unnamed(pipeline) -> None:
    def fn(res, _wd, _kw):
        d = res.clusters[sorted(res.clusters)[0]]
        d.title = ""
        d.service_outputs = []

    _wrap_result(pipeline, fn)


def report(pipeline) -> None:
    def fn(_res, wd, _kw):
        pages = sorted(glob.glob(os.path.join(wd, "clusters_p*.html")))
        os.remove(pages[-1] if pages else os.path.join(wd, "clusters.html"))

    _wrap_result(pipeline, fn)


KINDS = {"half_batch": half_batch, "row": row, "shuffle": shuffle,
         "oversize": oversize,
         "unnamed": unnamed, "report": report}
