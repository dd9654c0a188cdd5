"""The clustering pipeline on PyTorch: ingest -> label -> decode -> embed ->
fuse -> cluster -> name -> report.

The port of ``imageclust_tpu/pipeline.py``. Jobs up to
``cluster.exact_limit`` images take one batched forward over the upload on
the card and the exact constrained-Ward engine (K1 per merge). Larger jobs
stream their ingest (read -> decode -> forward in bounded chunks), keep the
features on the card and cluster them with the bucketed engine (K2 or K3)
or, with ``cluster.scale_engine="chain"``, the NN-chain engine (the greedy
engine's partition wherever merge distances are distinct);
:meth:`Pipeline.run_stream` takes uint8 chunks directly. The same naming
and HTML report follow. With ``cluster.feature_dtype`` bfloat16 or int8
the stream casts each chunk into that residency (the bucketed engine
only), so the f32 matrix never exists. Zero-shot labels
(``labels.backend="zero_shot"``) come from the batch embeddings on the
card, with no per-image labeler; the label block is the one-hot matrix
or, with ``labels.fusion="text"``, the text tower's dense block
(labels/text_fusion.py).

On a mesh (``Pipeline(config, mesh=...)``, every rank running the same
call on the same inputs; JAX pipeline.py:80-86, 536-590) the embedder is
data-parallel: above ``exact_limit`` each rank reads, labels, decodes and
embeds only its row block of the job, the per-image labels are gathered,
the label block (replicated) is fused onto each rank's rows and the scale
engines run over the mesh with the features row-sharded; smaller jobs
gather the features for the mesh exact engine. Rank 0 alone names the
clusters (the others receive its names) and writes the report and the
uploads; every rank returns the same result. The embedding cache is off
on a mesh (ranks would race on it).

Output shape parity with the reference: {"Cluster-<i>": ClusterDetails}
(workflow.go:192) and a clusters.html report in the work dir.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field

import numpy as np

from imageclust_tpu_torch.cluster import (
    constrained_ward,
    constrained_ward_bucketed,
    constrained_ward_chain,
)
from imageclust_tpu_torch.config import AppConfig
from imageclust_tpu_torch.data.loader import (
    _read_file,
    decode_images,
    dedup_name,
    sanitize_filename,
    stream_decode,
)
from imageclust_tpu_torch.device import resolve_device
from imageclust_tpu_torch.labels import (
    build_label_set,
    combine_embeddings,
    create_labeler,
    one_hot_matrix,
)
from imageclust_tpu_torch.naming import create_naming_service
from imageclust_tpu_torch.report import write_report
from imageclust_tpu_torch.types import ClusterDetails, UploadedImage
from imageclust_tpu_torch.utils.metrics import RunMetrics, StageTimer

log = logging.getLogger(__name__)

__all__ = ["Pipeline", "PipelineResult"]


@dataclass
class PipelineResult:
    clusters: dict[str, ClusterDetails]
    html_path: str
    metrics: RunMetrics
    dropped: list[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "clusters": {k: v.to_dict() for k, v in self.clusters.items()},
            "dropped": list(self.dropped),
            "metrics": self.metrics.to_dict(),
            "htmlPath": self.html_path,
        }


class Pipeline:
    """Long-lived pipeline: construct once (the model loads once onto the
    device), run per job. ``device`` defaults to ``"cuda"`` and raises
    without a card; pass ``device="cpu"`` to run on the CPU. ``mesh`` (a
    :class:`~imageclust_tpu_torch.core.mesh.Mesh`) runs every job over its
    ranks on the mesh's device; an ``embedder`` given with it must be
    built on that mesh."""

    def __init__(self, config: AppConfig | None = None, *, device=None,
                 embedder=None, mesh=None):
        from imageclust_tpu_torch.core.mesh import check_mesh
        from imageclust_tpu_torch.models import create_embedder

        self.config = config or AppConfig()
        self.mesh = check_mesh(mesh)
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        self.embedder = embedder or create_embedder(
            self.config.embed, device=self.device, mesh=mesh)
        if mesh is not None and getattr(self.embedder, "mesh", None) \
                is not mesh:
            raise ValueError("the embedder of a mesh pipeline must be built "
                             "on the same mesh (Embedder(..., mesh=mesh))")
        self.naming = create_naming_service(self.config.naming)
        self._text_encoder = None  # lazy: only labels.fusion="text" pays

    def _get_text_encoder(self):
        """Text tower for dense label fusion (labels.fusion="text"), built
        once per pipeline on its device, like the image tower: label-name
        embeddings do not depend on the corpus."""
        if self._text_encoder is None:
            from imageclust_tpu_torch.models.text import TextEncoder

            ckpt = self.config.labels.text_checkpoint_path
            self._text_encoder = (
                TextEncoder.from_checkpoint(ckpt, device=self.device)
                if ckpt else TextEncoder(device=self.device))
        return self._text_encoder

    # ------------------------------------------------------------------

    def run(
        self,
        uploads: list[UploadedImage],
        work_dir: str,
        min_size: int | None = None,
        max_size: int | None = None,
        profile_dir: str | None = None,
        image_route: str = "/api/image/",
        report_routes: tuple[str, str] | None = None,
    ) -> PipelineResult:
        cfg = self.config
        min_size = cfg.cluster.min_size if min_size is None else min_size
        max_size = cfg.cluster.max_size if max_size is None else max_size
        if not uploads:
            raise ValueError("no images uploaded")
        if min_size < 1 or max_size < min_size:
            raise ValueError(
                f"invalid cluster size bounds [{min_size}, {max_size}]"
            )

        metrics = RunMetrics()
        timer = StageTimer(metrics, profile_dir)
        metrics.counters["images"] = len(uploads)

        image_dir = os.path.join(work_dir, "images")
        cache_dir = os.path.join(work_dir, "cache")
        os.makedirs(image_dir, exist_ok=True)  # workflow.go:110-118
        os.makedirs(cache_dir, exist_ok=True)

        with timer.profiled():
            with timer.stage("ingest"):
                names, blobs = self._save_uploads(uploads, image_dir,
                                                  write=self._rank0())
                item_ids = [f"img_{i}" for i in range(len(names))]  # workflow.go:140
            return self._run_core(
                names, blobs, item_ids, work_dir, cache_dir,
                min_size, max_size, metrics, timer, image_route,
                report_routes,
            )

    def run_paths(
        self,
        paths: list[str],
        work_dir: str,
        min_size: int | None = None,
        max_size: int | None = None,
        profile_dir: str | None = None,
        image_route: str = "/api/image/",
        report_routes: tuple[str, str] | None = None,
    ) -> PipelineResult:
        """Run over images already on disk. Images are not copied into the
        work dir; report entries use the (sanitized, deduplicated)
        basenames."""
        cfg = self.config
        min_size = cfg.cluster.min_size if min_size is None else min_size
        max_size = cfg.cluster.max_size if max_size is None else max_size
        if not paths:
            raise ValueError("no images supplied")
        if min_size < 1 or max_size < min_size:
            raise ValueError(
                f"invalid cluster size bounds [{min_size}, {max_size}]"
            )

        metrics = RunMetrics()
        timer = StageTimer(metrics, profile_dir)
        metrics.counters["images"] = len(paths)
        cache_dir = os.path.join(work_dir, "cache")
        os.makedirs(cache_dir, exist_ok=True)

        names: list[str] = []
        seen: set[str] = set()
        for p in paths:
            name = dedup_name(
                sanitize_filename(os.path.basename(p)) or "image", seen)
            seen.add(name)
            names.append(name)
        item_ids = [f"img_{i}" for i in range(len(names))]

        with timer.profiled():
            return self._run_core(
                names, list(paths), item_ids, work_dir, cache_dir,
                min_size, max_size, metrics, timer, image_route,
                report_routes,
            )

    def run_stream(
        self,
        chunks,
        n_images: int,
        work_dir: str,
        name_fn=None,
        min_size: int | None = None,
        max_size: int | None = None,
        profile_dir: str | None = None,
        image_route: str = "/api/image/",
        report_routes: tuple[str, str] | None = None,
    ) -> PipelineResult:
        """Tier-scale entry (JAX pipeline.py:192-314): images arrive as an
        iterator of uint8 (b, S, S, 3) chunks, host arrays or CUDA tensors
        (a CUDA chunk feeds the forward with no transfer). Embeddings go
        into one preallocated buffer on the card, the bucketed engine
        clusters them in columnar form (no per-item id strings), then the
        same naming and report tail runs.

        ``name_fn(i) -> str`` names item i (default ``img_{i:07d}.jpg``).
        Labels: backend ``none`` (skip) or ``zero_shot`` (from the
        embeddings on the card, no image bytes needed); blob-based labelers
        need :meth:`run_paths`. On a mesh every rank passes the same global
        stream and embeds the rows of its block."""
        cfg = self.config
        min_size = cfg.cluster.min_size if min_size is None else min_size
        max_size = cfg.cluster.max_size if max_size is None else max_size
        if n_images < 1:
            raise ValueError("no images supplied")
        if min_size < 1 or max_size < min_size:
            raise ValueError(
                f"invalid cluster size bounds [{min_size}, {max_size}]")
        if cfg.labels.backend not in ("none", "", "zero_shot"):
            raise ValueError(
                f"run_stream supports labels.backend 'none' or 'zero_shot' "
                f"(got {cfg.labels.backend!r}); blob-based labelers need "
                "run_paths")
        name_fn = name_fn or (lambda i: f"img_{i:07d}.jpg")

        metrics = RunMetrics()
        timer = StageTimer(metrics, profile_dir)
        metrics.counters["images"] = n_images
        os.makedirs(work_dir, exist_ok=True)

        if self.mesh is not None:  # this rank's rows of the global stream
            from imageclust_tpu_torch.core.mesh import local_stream

            chunks = local_stream(chunks, n_images, self.mesh)

        with timer.profiled():
            with timer.stage("embed"):
                image_emb, emb_scale = self.embedder.embed_stream_quantized(
                    chunks, out_dtype=self._residency_dtype(),
                    total=n_images)
                self._drain(timer)

            per_image_labels = None
            label_mat = np.zeros((n_images, 0), np.float32)
            if cfg.labels.backend == "zero_shot":
                with timer.stage("label"):
                    per_image_labels, label_set = self._zero_shot_labels(
                        image_emb, metrics)
                with timer.stage("fuse"):
                    label_mat = self._label_block(per_image_labels,
                                                  label_set)
            features = self._fuse_big(image_emb, label_mat, emb_scale)

            with timer.stage("cluster"):
                result = self._cluster_big(features, None, min_size,
                                           max_size)
                self._engine_spans(result, metrics)
                if result._dropped_idx is not None:
                    dropped_idx = [int(i) for i in result._dropped_idx]
                else:  # the single-bucket hand-off: ids are "img_<k>"
                    dropped_idx = [int(s.rsplit("_", 1)[-1])
                                   for s in result.dropped]
                metrics.counters["clusters"] = result.n_clusters
                metrics.counters["dropped"] = len(dropped_idx)
                metrics.counters["merges"] = len(result.merges)

            with timer.stage("name"):
                details = self._prepare_details_columnar(
                    result, name_fn, timer, per_image_labels,
                    work_dir=work_dir)

            with timer.stage("report"):
                html_path = self._write_report(details, work_dir,
                                               image_route, report_routes)

        dropped_names = [name_fn(i) for i in dropped_idx]
        log.info("pipeline done: %d clusters, %d dropped, stages %s",
                 len(details), len(dropped_names), metrics.stages)
        return PipelineResult(details, html_path, metrics, dropped_names)

    def _run_core(
        self,
        names: list[str],
        sources: list,  # bytes (uploads) or str paths (run_paths)
        item_ids: list[str],
        work_dir: str,
        cache_dir: str,
        min_size: int,
        max_size: int,
        metrics: RunMetrics,
        timer: StageTimer,
        image_route: str,
        report_routes: tuple[str, str] | None = None,
    ) -> PipelineResult:
        cfg = self.config
        # zero-shot labels come from the batch embeddings (computed below)
        # instead of a forward pass per image and label query
        zero_shot_batched = cfg.labels.backend == "zero_shot"
        # Above exact_limit, embeddings stay on the card all the way through
        # clustering (no per-image cache); small jobs use the cache.
        big_job = len(sources) > cfg.cluster.exact_limit
        if cfg.labels.fusion not in ("onehot", "text"):
            raise ValueError(  # fail loud: a typo must not change geometry
                f"unknown labels.fusion {cfg.labels.fusion!r} "
                "(expected 'onehot' or 'text')")

        labeler = labeling = None
        if not zero_shot_batched:
            labeler = create_labeler(
                cfg.labels, cache_dir if cfg.labels.cache else None,
                embedder=self.embedder,
            )
            labeling = self._labeling_service(labeler, cfg.labels,
                                              total=len(sources))
        if big_job:
            # Streamed ingest (JAX pipeline.py:339-394): read -> label ->
            # decode -> forward in bounded chunks; the producer thread
            # decodes chunk k+1 while the card runs chunk k, so host memory
            # stays O(chunk), not O(job).
            per_image_labels: list = []
            r0, n_mine = self._block(len(sources))

            def chunk_iter():
                for _start, chunk_blobs, imgs in stream_decode(
                    sources[r0:r0 + n_mine],
                    size=self.embedder.spec.input_size,
                    batch=self.embedder.batch_size,
                    workers=cfg.preprocess.decode_workers,
                ):
                    if labeling is not None:
                        # one service spans the stream: rate limiter, retry
                        # budget and progress are job-global
                        per_image_labels.extend(
                            labeling.detect_all(chunk_blobs))
                    yield imgs

            with timer.stage("embed"):
                # stream straight into the cluster residency dtype
                image_emb, emb_scale = self.embedder.embed_stream_quantized(
                    chunk_iter(), out_dtype=self._residency_dtype(),
                    total=len(sources))
                self._drain(timer)
            if not zero_shot_batched:
                per_image_labels = self._gather_list(per_image_labels)
                label_set = self._label_set(per_image_labels, cfg.labels)
                metrics.counters["unique_labels"] = len(label_set)
                if hasattr(labeler, "hits"):
                    metrics.counters["label_cache_hits"] = labeler.hits
        else:
            blobs = [
                s if isinstance(s, (bytes, bytearray)) else _read_file(s)
                for s in sources
            ]
            if not zero_shot_batched:
                with timer.stage("label"):
                    r0, n_mine = self._block(len(blobs))
                    per_image_labels = self._gather_list(
                        labeling.detect_all(blobs[r0:r0 + n_mine]))
                    label_set = self._label_set(per_image_labels, cfg.labels)
                    metrics.counters["unique_labels"] = len(label_set)
                    if hasattr(labeler, "hits"):
                        metrics.counters["label_cache_hits"] = labeler.hits

            with timer.stage("decode"):
                batch = decode_images(
                    blobs,
                    size=self.embedder.spec.input_size,
                    workers=cfg.preprocess.decode_workers,
                )

            with timer.stage("embed"):
                if cfg.embed.cache and self.mesh is None:
                    from imageclust_tpu_torch.utils.checkpoint import (
                        EmbeddingCache,
                    )

                    emb_cache = EmbeddingCache(
                        os.path.join(cache_dir, "embeddings"),
                        self.embedder.tag,
                    )
                    image_emb = emb_cache.embed_with_cache(
                        self.embedder, blobs, batch
                    )
                    metrics.counters["embed_cache_hits"] = emb_cache.hits
                else:
                    image_emb = self.embedder.embed(batch)
                self._drain(timer)

        if zero_shot_batched:
            with timer.stage("label"):
                per_image_labels, label_set = self._zero_shot_labels(
                    image_emb, metrics)

        with timer.stage("fuse"):
            label_mat = self._label_block(per_image_labels, label_set)
            if big_job:
                features = self._fuse_big(image_emb, label_mat, emb_scale)
            else:
                features = combine_embeddings(image_emb, label_mat)

        with timer.stage("cluster"):
            if big_job:
                result = self._cluster_big(features, item_ids, min_size,
                                           max_size)
                self._engine_spans(result, metrics)
            else:
                result = constrained_ward(
                    features, item_ids,
                    min_size=min_size, max_size=max_size,
                    update_rule=cfg.cluster.update_rule,
                    reassign_dropped=cfg.cluster.reassign_dropped,
                    mesh=self.mesh, device=self.device,
                )
            metrics.counters["clusters"] = result.n_clusters
            metrics.counters["dropped"] = len(result.dropped)
            metrics.counters["merges"] = len(result.merges)

        with timer.stage("name"):
            details = self._prepare_cluster_details(
                result.cluster_map, item_ids, names, per_image_labels,
                timer, work_dir=work_dir,
            )

        with timer.stage("report"):
            html_path = self._write_report(details, work_dir, image_route,
                                           report_routes)

        id_to_name = dict(zip(item_ids, names))
        dropped_names = [id_to_name[i] for i in result.dropped]
        log.info("pipeline done: %d clusters, %d dropped, stages %s",
                 len(details), len(dropped_names), metrics.stages)
        return PipelineResult(details, html_path, metrics, dropped_names)

    # ------------------------------------------------------------------

    def _rank0(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def _drain(self, timer: StageTimer) -> None:
        """Ends the embed stage when its work has ended on the card: waits
        for the stream's queued chunks (span ``embed/drain``, the seconds
        the host ran ahead of the tower)."""
        with timer.span("embed/drain"):
            if self.device.type == "cuda":
                import torch

                torch.cuda.current_stream(self.device).synchronize()

    @staticmethod
    def _engine_spans(result, metrics: RunMetrics) -> None:
        """The bucketed engine's phases as spans ``cluster/<phase>``. Other
        engines, and the single-bucket hand-off, report none."""
        for phase, seconds in getattr(result, "phases_s", {}).items():
            metrics.spans[f"cluster/{phase}"] = seconds

    def _block(self, n: int) -> tuple[int, int]:
        """(first row, rows) of this rank's block of an n-item job: the
        whole job without a mesh."""
        if self.mesh is None:
            return 0, n
        from imageclust_tpu_torch.core.mesh import row_block

        return row_block(n, self.mesh)

    def _gather_list(self, items: list) -> list:
        """The ranks' per-item lists concatenated in row order (the list
        itself without a mesh)."""
        if self.mesh is None:
            return items
        from imageclust_tpu_torch.core.collectives import gather_objects

        return [x for part in gather_objects(items, self.mesh) for x in part]

    def _write_report(self, details, work_dir, image_route, report_routes):
        """report_routes = (page_route, index_route[, section_route]) for
        job-scoped pagination links; file-relative defaults otherwise. On a
        mesh rank 0 writes; the others return the same path."""
        if not self._rank0():
            return os.path.join(work_dir, "clusters.html")
        routes = tuple(report_routes or ())
        page_route = routes[0] if routes else "clusters_p{page}.html"
        index_route = routes[1] if len(routes) > 1 else "clusters.html"
        section_route = (routes[2] if len(routes) > 2
                         else "clusters_ix{sec}.html")
        return write_report(
            details, work_dir, image_route,
            page_size=self.config.service.report_page_size,
            page_route=page_route, index_route=index_route,
            section_route=section_route)

    def _zero_shot_labels(self, image_emb, metrics: RunMetrics):
        """Zero-shot labels of every image from its embedding (a host
        array, or the tensor on the card in its residency dtype), and the
        label set. Construction stays with create_labeler; the per-image
        label cache does not apply (the embedding cache covers the costly
        half)."""
        from imageclust_tpu_torch.core.mesh import ShardedRows

        cfg = self.config.labels
        zs = create_labeler(cfg, None, embedder=self.embedder)
        if isinstance(image_emb, ShardedRows):  # this rank's rows, gathered
            per_image_labels = self._gather_list(zs.labels_from_embeddings(
                image_emb.local[:image_emb.n_local], cfg.max_labels,
                cfg.min_confidence))
        else:
            per_image_labels = zs.labels_from_embeddings(
                image_emb, cfg.max_labels, cfg.min_confidence)
        label_set = self._label_set(per_image_labels, cfg)
        metrics.counters["unique_labels"] = len(label_set)
        return per_image_labels, label_set

    def _label_block(self, per_image_labels, label_set) -> np.ndarray:
        """The label block fused onto the embeddings: one-hot over the label
        set, or the text tower's dense block (``labels.fusion="text"``),
        scaled by ``labels.fusion_weight``."""
        cfg = self.config.labels
        if cfg.fusion == "text":
            from imageclust_tpu_torch.labels.text_fusion import (
                text_label_matrix,
            )

            label_mat = text_label_matrix(per_image_labels, label_set,
                                          self._get_text_encoder())
        else:
            label_mat = one_hot_matrix(per_image_labels, label_set)
        if cfg.fusion_weight != 1.0:
            label_mat = label_mat * np.float32(cfg.fusion_weight)
        return label_mat

    def _residency_dtype(self):
        """The bucketed engine's residency dtype for the streamed features
        (JAX pipeline.py:244-250, 376-389); None keeps float32."""
        import torch

        cluster = self.config.cluster
        if cluster.scale_engine != "bucketed":
            return None
        return {"bfloat16": torch.bfloat16,
                "int8": torch.int8}.get(cluster.feature_dtype)

    def _fuse_big(self, image_emb, label_mat: np.ndarray,
                  emb_scale: float = 1.0):
        """Fuse the label block onto the embeddings ON THE CARD (the
        big-job path: features never visit the host), in the embeddings'
        residency dtype (JAX pipeline.py:515-554). On the int8 grid the
        label block is divided by the stream's scale and rounded, so the
        relative geometry matches the f32 pipeline."""
        import torch

        from imageclust_tpu_torch.core.mesh import ShardedRows, local_rows
        from imageclust_tpu_torch.ops.pref_kernels import to_grid

        if not label_mat.shape[1]:
            return image_emb
        if isinstance(image_emb, ShardedRows):  # this rank's label rows
            lm = local_rows(label_mat, image_emb.mesh).local.cpu().numpy()
            return image_emb.map(
                lambda e: self._fuse_big(e, lm, emb_scale))
        lm = torch.from_numpy(np.ascontiguousarray(label_mat))
        if image_emb.dtype == torch.int8:
            had_labels = bool(label_mat.any())
            lm = to_grid(lm, float(emb_scale))
            if had_labels and not bool(lm.any()):
                log.warning(
                    "int8 residency rounded the label block to all zeros "
                    "(values below the grid step %.3g) — labels will not "
                    "influence clustering; raise labels.fusion_weight to "
                    "give them weight", emb_scale)
        lm = lm.to(image_emb.device).to(image_emb.dtype)
        return torch.cat([image_emb, lm], dim=1)

    def _cluster_big(self, features, item_ids, min_size: int,
                     max_size: int):
        """Scale-engine dispatch above cluster.exact_limit: NN-chain for
        exact greedy semantics, bucketed for capacity (JAX
        pipeline.py:556-585). ``item_ids`` may be None: the result is then
        columnar with integer item indices."""
        cfg = self.config
        if cfg.cluster.scale_engine == "chain":
            return constrained_ward_chain(
                features, item_ids,
                min_size=min_size, max_size=max_size,
                reassign_dropped=cfg.cluster.scale_reassign_dropped,
                mesh=self.mesh, device=self.device,
            )
        if cfg.cluster.scale_engine != "bucketed":
            # fail loud: a typo must not silently pick an engine
            raise ValueError(
                f"unknown cluster.scale_engine "
                f"{cfg.cluster.scale_engine!r}; know 'bucketed', 'chain'")
        return constrained_ward_bucketed(
            features, item_ids,
            min_size=min_size, max_size=max_size,
            bucket_size=cfg.cluster.bucket_size,
            kmeans_iters=cfg.cluster.kmeans_iters,
            update_rule=cfg.cluster.scale_update_rule,
            reassign_dropped=cfg.cluster.scale_reassign_dropped,
            feature_dtype=cfg.cluster.feature_dtype,
            mesh=self.mesh, device=self.device,
        )

    @staticmethod
    def _labeling_service(labeler, label_cfg, total: int):
        """Per-image labels at scale (labels/service.py): bounded
        concurrency, shared rate limiter, retries, progress. The "none"
        backend skips the thread pool entirely (its answers are free)."""
        from imageclust_tpu_torch.labels.service import create_labeling_service

        svc = create_labeling_service(labeler, label_cfg, total=total)
        if label_cfg.backend in ("none", ""):
            svc.concurrency = 1
        return svc

    @staticmethod
    def _label_set(per_image_labels, label_cfg):
        """Label-set threshold: 0 = observed reference behavior (the cache
        reuses the first query's labels); >0 filters like the reference's
        intended BuildLabelSet call (embeddings.go:208)."""
        floor = label_cfg.label_set_min_confidence
        if floor > 0:
            source = [
                [l for l in labels if l.confidence >= floor]
                for labels in per_image_labels
            ]
        else:
            source = per_image_labels
        return build_label_set(source)

    def _save_uploads(
        self, uploads: list[UploadedImage], image_dir: str,
        write: bool = True,
    ) -> tuple[list[str], list[bytes]]:
        """Persist sanitized uploads (handlers.go:86-104 + workflow.go:120-127)
        and return (filenames, raw bytes); ``write=False`` names them
        without writing (a mesh rank other than 0)."""
        names: list[str] = []
        blobs: list[bytes] = []
        seen: set[str] = set()
        for up in uploads:
            name = dedup_name(sanitize_filename(up.filename) or "image", seen)
            seen.add(name)
            if write:
                with open(os.path.join(image_dir, name), "wb") as fh:
                    fh.write(up.data)
            names.append(name)
            blobs.append(up.data)
        return names, blobs

    def _prepare_cluster_details(
        self,
        cluster_map: dict[int, list[str]],
        item_ids: list[str],
        names: list[str],
        per_image_labels,
        timer: StageTimer,
        work_dir: str | None = None,
    ) -> dict[str, ClusterDetails]:
        """workflow.go:187-229 with deterministic label order, a working
        primary-title assignment, and resumable naming state under the
        job's work dir."""
        details: dict[str, ClusterDetails] = {}
        texts: dict[str, str] = {}
        with timer.span("name/details"):
            id_to_idx = {iid: i for i, iid in enumerate(item_ids)}
            for cluster_id, members in cluster_map.items():
                d = ClusterDetails()
                seen_labels: list[str] = []
                for iid in members:
                    idx = id_to_idx[iid]
                    for label in per_image_labels[idx]:
                        if label.name not in seen_labels:
                            seen_labels.append(label.name)
                    d.images.append(names[idx])
                d.labels = ", ".join(seen_labels)
                key = f"Cluster-{cluster_id}"  # workflow.go:192
                details[key] = d
                texts[key] = d.labels

        self._apply_naming(details, texts, work_dir, timer)
        return details

    def _prepare_details_columnar(
        self,
        result,
        name_fn,
        timer: StageTimer,
        per_image_labels=None,
        work_dir: str | None = None,
    ) -> dict[str, ClusterDetails]:
        """workflow.go:187-229 over the engine's COLUMNAR result: member
        indices drive ``name_fn`` and label lookups directly, so no per-item
        id string or id->index dict is built. Same naming budget and resume
        as :meth:`_prepare_cluster_details`."""
        details: dict[str, ClusterDetails] = {}
        texts: dict[str, str] = {}

        def cluster_iter():
            if result._members is not None:
                mem, off = result._members, result._offsets
                for c in range(len(off) - 1):
                    yield c, mem[off[c]:off[c + 1]]
            else:  # eager engine result (the single-bucket hand-off)
                for c, idxs in result._index_map.items():
                    yield c, idxs

        with timer.span("name/details"):
            for cid, idxs in cluster_iter():
                d = ClusterDetails()
                if per_image_labels is None:
                    d.images = [name_fn(int(i)) for i in idxs]
                else:
                    seen_labels: list[str] = []
                    for i in idxs:
                        i = int(i)
                        for label in per_image_labels[i]:
                            if label.name not in seen_labels:
                                seen_labels.append(label.name)
                        d.images.append(name_fn(i))
                    d.labels = ", ".join(seen_labels)
                key = f"Cluster-{cid}"  # workflow.go:192
                details[key] = d
                texts[key] = d.labels

        self._apply_naming(details, texts, work_dir, timer)
        return details

    def _apply_naming(
        self,
        details: dict[str, ClusterDetails],
        texts: dict[str, str],
        work_dir: str | None,
        timer: StageTimer,
    ) -> None:
        """Budget + name + assign titles. Naming budget
        (naming.max_clusters): name only the N largest clusters (ties by
        cluster id); the rest keep their label text. The naming service's
        counters of the call join the job's (on a mesh, rank 0's)."""
        budget = self.config.naming.max_clusters
        counters = timer.metrics.counters
        if budget and len(texts) > budget:
            keys = list(texts)
            sizes = np.fromiter((len(details[k].images) for k in keys),
                                np.int64, len(keys))
            ids = np.fromiter((int(k.rsplit("-", 1)[-1]) for k in keys),
                              np.int64, len(keys))
            keep = [keys[i] for i in np.lexsort((ids, -sizes))[:budget]]
            counters["naming_skipped"] = len(texts) - budget
            log.info(
                "naming budget: naming the %d largest of %d clusters "
                "(%d skipped; raise naming.max_clusters to name more)",
                budget, len(texts), counters["naming_skipped"])
            texts = {k: texts[k] for k in keep}

        state_path = os.path.join(work_dir, "naming_state.jsonl") \
            if work_dir else None

        def name():
            return self.naming.name_clusters(texts, state_path=state_path,
                                             counters=counters)

        with timer.span("name/services"):
            if self.mesh is None:
                outputs = name()
            else:  # rank 0 names; its names, or its error, reach every rank
                from imageclust_tpu_torch.core.collectives import on_rank

                outputs = on_rank(name, self.mesh)
        with timer.span("name/assign"):
            for key, outs in outputs.items():
                d = details[key]
                for out in outs:
                    d.set_output(out)
                if d.service_outputs:  # primary = first in display order
                    d.title = d.service_outputs[0].title
                    d.catchy_phrase = d.service_outputs[0].catchy_phrase
