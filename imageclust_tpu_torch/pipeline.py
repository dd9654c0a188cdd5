"""The clustering pipeline on PyTorch: ingest -> label -> decode -> embed ->
fuse -> cluster -> name -> report.

The port of ``imageclust_tpu/pipeline.py`` for jobs up to
``cluster.exact_limit`` images (the small-job branch of ``_run_core``): one
batched forward over the upload on the card, the exact constrained-Ward
engine on the card (K1 per merge), then the same naming and HTML report.
Larger jobs need the bucketed or chain engine and ``run_stream``, which are
not ported yet and raise ``NotImplementedError`` (ROADMAP.md queue 1).

Output shape parity with the reference: {"Cluster-<i>": ClusterDetails}
(workflow.go:192) and a clusters.html report in the work dir.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field

import numpy as np

from imageclust_tpu_torch.cluster import constrained_ward
from imageclust_tpu_torch.config import AppConfig
from imageclust_tpu_torch.data.loader import (
    _read_file,
    decode_images,
    dedup_name,
    sanitize_filename,
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
    without a card; pass ``device="cpu"`` to run on the CPU."""

    def __init__(self, config: AppConfig | None = None, *, device=None,
                 embedder=None):
        from imageclust_tpu_torch.models import create_embedder

        self.config = config or AppConfig()
        self.device = resolve_device(device)
        self.embedder = embedder or create_embedder(self.config.embed,
                                                    device=self.device)
        self.naming = create_naming_service(self.config.naming)
        self._naming_skipped = 0  # set per run by _apply_naming

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
                names, blobs = self._save_uploads(uploads, image_dir)
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
        if len(sources) > cfg.cluster.exact_limit:
            raise NotImplementedError(
                f"{len(sources)} images is above cluster.exact_limit="
                f"{cfg.cluster.exact_limit}: the scale engines and run_stream "
                "are not ported yet (ROADMAP.md queue 1)")
        if cfg.labels.fusion != "onehot":
            if cfg.labels.fusion == "text":
                raise NotImplementedError(
                    "labels.fusion='text' needs the text tower, not ported "
                    "yet (ROADMAP.md queue 1)")
            raise ValueError(  # fail loud: a typo must not change geometry
                f"unknown labels.fusion {cfg.labels.fusion!r} "
                "(expected 'onehot' or 'text')")

        blobs = [
            s if isinstance(s, (bytes, bytearray)) else _read_file(s)
            for s in sources
        ]
        with timer.stage("label"):
            labeler = create_labeler(
                cfg.labels, cache_dir if cfg.labels.cache else None,
                embedder=self.embedder,
            )
            labeling = self._labeling_service(
                labeler, cfg.labels, total=len(blobs))
            per_image_labels = labeling.detect_all(blobs)
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
            if cfg.embed.cache:
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

        with timer.stage("fuse"):
            label_mat = one_hot_matrix(per_image_labels, label_set)
            if cfg.labels.fusion_weight != 1.0:
                label_mat = label_mat * np.float32(cfg.labels.fusion_weight)
            features = combine_embeddings(image_emb, label_mat)

        with timer.stage("cluster"):
            result = constrained_ward(
                features, item_ids,
                min_size=min_size, max_size=max_size,
                update_rule=cfg.cluster.update_rule,
                reassign_dropped=cfg.cluster.reassign_dropped,
                device=self.device,
            )
            metrics.counters["clusters"] = result.n_clusters
            metrics.counters["dropped"] = len(result.dropped)
            metrics.counters["merges"] = len(result.merges)

        with timer.stage("name"):
            details = self._prepare_cluster_details(
                result.cluster_map, item_ids, names, per_image_labels,
                work_dir=work_dir,
            )
            if self._naming_skipped:
                metrics.counters["naming_skipped"] = self._naming_skipped

        with timer.stage("report"):
            # report_routes = (page_route, index_route[, section_route]) for
            # job-scoped pagination links; file-relative defaults otherwise
            routes = tuple(report_routes or ())
            page_route = routes[0] if routes else "clusters_p{page}.html"
            index_route = routes[1] if len(routes) > 1 else "clusters.html"
            section_route = (routes[2] if len(routes) > 2
                             else "clusters_ix{sec}.html")
            html_path = write_report(
                details, work_dir, image_route,
                page_size=cfg.service.report_page_size,
                page_route=page_route, index_route=index_route,
                section_route=section_route)

        id_to_name = dict(zip(item_ids, names))
        dropped_names = [id_to_name[i] for i in result.dropped]
        log.info("pipeline done: %d clusters, %d dropped, stages %s",
                 len(details), len(dropped_names), metrics.stages)
        return PipelineResult(details, html_path, metrics, dropped_names)

    # ------------------------------------------------------------------

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
        self, uploads: list[UploadedImage], image_dir: str
    ) -> tuple[list[str], list[bytes]]:
        """Persist sanitized uploads (handlers.go:86-104 + workflow.go:120-127)
        and return (filenames, raw bytes)."""
        names: list[str] = []
        blobs: list[bytes] = []
        seen: set[str] = set()
        for up in uploads:
            name = dedup_name(sanitize_filename(up.filename) or "image", seen)
            seen.add(name)
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
        work_dir: str | None = None,
    ) -> dict[str, ClusterDetails]:
        """workflow.go:187-229 with deterministic label order, a working
        primary-title assignment, and resumable naming state under the
        job's work dir."""
        id_to_idx = {iid: i for i, iid in enumerate(item_ids)}
        details: dict[str, ClusterDetails] = {}
        texts: dict[str, str] = {}
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

        self._apply_naming(details, texts, work_dir)
        return details

    def _apply_naming(
        self,
        details: dict[str, ClusterDetails],
        texts: dict[str, str],
        work_dir: str | None,
    ) -> None:
        """Budget + name + assign titles. Naming budget
        (naming.max_clusters): name only the N largest clusters (ties by
        cluster id); the rest keep their label text."""
        budget = self.config.naming.max_clusters
        self._naming_skipped = 0
        if budget and len(texts) > budget:
            keys = list(texts)
            sizes = np.fromiter((len(details[k].images) for k in keys),
                                np.int64, len(keys))
            ids = np.fromiter((int(k.rsplit("-", 1)[-1]) for k in keys),
                              np.int64, len(keys))
            keep = [keys[i] for i in np.lexsort((ids, -sizes))[:budget]]
            self._naming_skipped = len(texts) - budget
            log.info(
                "naming budget: naming the %d largest of %d clusters "
                "(%d skipped; raise naming.max_clusters to name more)",
                budget, len(texts), self._naming_skipped)
            texts = {k: texts[k] for k in keep}

        state_path = os.path.join(work_dir, "naming_state.jsonl") \
            if work_dir else None
        outputs = self.naming.name_clusters(texts, state_path=state_path)
        for key, outs in outputs.items():
            d = details[key]
            for out in outs:
                d.set_output(out)
            if d.service_outputs:  # primary = first in display order
                d.title = d.service_outputs[0].title
                d.catchy_phrase = d.service_outputs[0].catchy_phrase
