"""Typed configuration for the whole framework.

The reference scattered its knobs across hardcoded constants (cluster sizes
(3,6) at internal/handlers/handlers.go:111, model path at
internal/workflow/workflow.go:49, AWS regions at workflow.go:44 and
internal/ai/claude-haiku/claude-haiku.go:46, Rekognition params at
workflow.go:129 / internal/embeddings/embeddings.go:208, retries at
workflow.go:211) and shipped a dead config module
(internal/config/config.go:22-52 — never called). Here every knob lives in one
dataclass tree that can be loaded from YAML, overridden by environment
variables, and overridden again programmatically / from the CLI. The
``min/max`` cluster sizes the frontend sends (frontend
ImageUploadForm.jsx:52-53) are honored instead of ignored.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Mapping

__all__ = [
    "ClusterConfig",
    "PreprocessConfig",
    "EmbedConfig",
    "LabelConfig",
    "NamingConfig",
    "ServiceConfig",
    "MeshConfig",
    "AppConfig",
    "load_config",
]

_ENV_PREFIX = "IMAGECLUST_"


@dataclass
class ClusterConfig:
    """Size-constrained Ward clustering knobs.

    Defaults mirror the reference's hardcoded ``NewImageCluster(3, 6, ...)``
    (internal/handlers/handlers.go:111).
    """

    min_size: int = 3
    max_size: int = 6
    # "centroid" recomputes merged-cluster distances from centroids exactly as
    # the reference does (clustering.go:76-96 calls WardDistance on the new
    # centroid); "lance_williams" uses the O(n) Lance-Williams recurrence —
    # identical in exact arithmetic, cheaper at scale. Applies to the exact
    # engine (parity path).
    update_rule: str = "centroid"
    # Update rule for the bucketed engine (already an approximation of the
    # global merge order, so the O(n)-per-merge recurrence is the default).
    scale_update_rule: str = "lance_williams"
    # Number of images above which the pipeline switches from the exact
    # single-matrix engine to the scale engine.
    exact_limit: int = 4096
    # Scale engine for jobs above exact_limit: "bucketed" (k-means buckets +
    # vmapped per-bucket merges; approximates the global merge order, mesh-
    # shardable) or "chain" (nearest-neighbor-chain: the greedy engine's
    # exact partition wherever merge distances are distinct, O(n*d) memory;
    # with a mesh the centroid matrix row-shards over 'data').
    scale_engine: str = "bucketed"
    # Bucket capacity for the scalable engine (images per independently
    # clustered bucket; buckets run vmapped / sharded across devices).
    bucket_size: int = 512
    # Lloyd iterations for the k-means bucketing stage.
    kmeans_iters: int = 8
    # Reference parity keeps False: under-min clusters are silently dropped
    # (clustering.go:268-271). True reassigns those images to the nearest
    # surviving cluster with room instead of losing them. Applies to the
    # exact engine (the parity path).
    reassign_dropped: bool = False
    # The bucketed engine is already a documented approximation of the
    # reference's merge order, so it defaults to NOT losing images: an
    # on-device absorb phase merges under-min clusters into their
    # Ward-nearest neighbor (bounded by max_size) instead of dropping them.
    scale_reassign_dropped: bool = True
    # Residency dtype of the bucketed engine's feature matrix: "float32"
    # (default), "bfloat16" (HALF the HBM — the single-chip envelope
    # doubles to ~2e9 feature floats, e.g. 1.5M x 1000; arithmetic still
    # accumulates f32), or "int8" (half AGAIN, ~4e9 elements — 10M x 1024,
    # the full CLIP joint visual+text width; features quantize once to a
    # symmetric grid whose scale cancels out of the Ward merge order).
    # bfloat16/int8 are precision-caveated NON-parity modes like
    # embed.quantize=int8: assignments can shift near distance ties (int8
    # additionally rounds the features themselves to 8 bits).
    feature_dtype: str = "float32"


@dataclass
class PreprocessConfig:
    """Host-side ingest knobs.

    Device-side preprocessing numerics (resize size, 1/255 scale, mean/std,
    BGR->RGB — parity with BlobFromImage at embeddings.go:96) are properties
    of the selected MODEL, not free config: they live in each embedder's
    ``EmbedderSpec`` (models/registry.py) so a CLIP tower can't silently run
    with ResNet normalization.
    """

    # Host-side decode workers (capped at cpu_count by the loader).
    decode_workers: int = 8


@dataclass
class EmbedConfig:
    """Embedding model selection and execution."""

    # Registry name: "resnet50" (parity with resnet50-v1-7.onnx),
    # "vit_b32", "vit_l14", "siglip_so400m", "siglip_so400m_384" (the port's
    # own: the published SigLIP So400m/14@384 tower).
    model: str = "resnet50"
    # Path to the ONNX checkpoint for resnet50 parity weights; the mirror of
    # the reference strips the blob (.MISSING_LARGE_BLOBS:1) so random init is
    # used when the file is absent.
    onnx_path: str = "resnet50-v1-7.onnx"
    # Orbax checkpoint (e.g. from `imageclust train`); takes precedence over
    # onnx_path when set.
    checkpoint_path: str = ""
    # Classifier head width — must match a restored checkpoint's (a tuned
    # tower from `imageclust train` has len(classes) outputs). With
    # output="logits" this is also the embedding dim.
    num_classes: int = 1000
    # 0 = auto: the tower's measured-best batch on one chip
    # (models/registry.py DEFAULT_BATCH, e.g. resnet50 512, vit_b32 1024).
    batch_size: int = 0
    # "logits" = the 1000-d head the reference reads (layer
    # "resnetv17_dense0_fwd", embeddings.go:140); "pooled" = 2048-d features.
    output: str = "logits"
    dtype: str = "bfloat16"  # compute dtype on the MXU; outputs are float32
    param_dtype: str = "float32"
    # Normalization-layer compute dtype. bfloat16 lets XLA fuse BN/LN into
    # conv/matmul epilogues (~2.7x ResNet throughput on v5e); float32 for
    # strict-precision runs.
    norm_dtype: str = "bfloat16"
    # content-addressed per-image embedding cache (the reference's CacheDir
    # promised this and never did it, embeddings.go:19)
    cache: bool = True
    # ResNet50 space-to-depth stem: raw uint8 input, 7x7/2 kernel rewritten
    # to 4x4/1 over 12 s2d channels with 1/255 + BGR flip folded in —
    # mathematically identical, ~25% faster stem on the MXU.
    s2d_stem: bool = True
    # "" (full precision) or "int8": post-training-quantized serving tower —
    # per-channel int8 weights (BN-folded for resnet50; every encoder Dense
    # for the ViT/SigLIP towers), calibrated activation scales, int32 MXU
    # accumulation. NOT bit-parity with the f32 tower: embeddings shift
    # within quantization error (tests pin cosine on random init); cache
    # tags include it.
    quantize: str = ""
    # Activation-scale statistic for int8 calibration: "absmax" (no
    # clipping inside the calibration sample) or "p999" (clip the top 0.1%
    # for resolution where the mass is — the usual choice on heavy-tailed
    # real-data activations).
    calib_method: str = "absmax"


@dataclass
class LabelConfig:
    """Semantic labeling — parity with internal/rekognition."""

    backend: str = "none"  # "rekognition" | "zero_shot" | "fake" | "none"
    region: str = "us-east-1"  # workflow.go:44
    max_labels: int = 10  # workflow.go:129
    min_confidence: float = 75.0  # workflow.go:129
    # The reference INTENDS to build the label set at confidence 80
    # (embeddings.go:208) but its filename-keyed cache silently reuses the
    # 75-confidence result (rekognition.go:90-97, SURVEY.md §2). Default 0
    # reproduces the observed behavior (same labels for both uses); set 80.0
    # to get the reference's intended stricter label set.
    label_set_min_confidence: float = 0.0
    # 5 MB Rekognition payload cap with iterative downscale
    # (rekognition.go:21, :174-260).
    max_payload_bytes: int = 5 * 1024 * 1024
    cache: bool = True
    # Labeling-stage scaling (labels/service.py — the name_clusters
    # treatment; the reference labels strictly serially, workflow.go:120-147):
    # images labeled in flight at once. 8 keeps a default Rekognition
    # account inside its TPS quota; raise with a quota increase.
    concurrency: int = 8
    # Upper bound on labeler requests/second across the whole job (token
    # bucket, shared by every worker; gates only real backend calls — cache
    # hits are free). 0 = unlimited.
    rate_limit_rps: float = 0.0
    # Per-image attempts before the job aborts (completed images stay in
    # the content-hash cache, so a re-run resumes). The reference has NO
    # labeling retries — one Rekognition failure kills the request
    # (workflow.go:74-97).
    retries: int = 3
    retry_delay_s: float = 1.0
    # Scale applied to the label block before fusion. The reference
    # concatenates raw 0/1 labels against 1000-d logits whose magnitudes
    # dominate the Ward distances (embeddings.go:177-183); weight > 1 makes
    # semantic labels actually influence clustering. 1.0 = reference parity.
    fusion_weight: float = 1.0
    # How the label block is built: "onehot" = the reference's one-hot over
    # the global label set (embeddings.go:166-183, parity default); "text" =
    # BASELINE config 5's joint visual+text formulation — label NAMES
    # embedded by the CLIP-style text tower, confidence-weighted per image
    # (labels/text_fusion.py). Fixed width (text proj_dim) instead of one
    # column per unique label; non-parity; meaningful geometry needs a real
    # text checkpoint.
    fusion: str = "onehot"
    # HuggingFace CLIPTextModel(WithProjection) checkpoint (.pt/.bin/.npz)
    # for the fusion="text" tower; empty = deterministic random init (valid
    # wiring, semantically inert — like the zero-shot demo bank). Pair with
    # IMAGECLUST_BPE_PATH (or the conventional merges file) so token ids
    # match the trained vocabulary.
    text_checkpoint_path: str = ""


@dataclass
class NamingConfig:
    """LLM cluster naming — parity with internal/ai."""

    # Enabled services in display order. The reference enables only
    # "Claude Haiku v3.5" (wrapper.go:36-69); we default to the offline fake
    # so the system works without cloud credentials.
    services: tuple[str, ...] = ("fake",)
    retries: int = 3  # workflow.go:211
    retry_delay_s: float = 2.0  # claude-haiku.go:102
    bedrock_region: str = "us-west-2"  # claude-haiku.go:46
    max_tokens: int = 100  # claude-haiku.go:75
    temperature: float = 0.7  # claude-haiku.go:76
    input_char_limit: int = 1000  # claude-haiku.go:57
    # Clusters named in flight at once (the reference names clusters one
    # by one, workflow.go:187-229 — at the engine's 100k tier that is ~21k
    # sequential LLM round trips). 16 keeps a Bedrock account inside
    # default service quotas; raise it with provisioned throughput.
    cluster_concurrency: int = 16
    # Upper bound on LLM requests/second across all clusters and services
    # (token bucket). 0 = unlimited.
    rate_limit_rps: float = 0.0
    # Naming budget for the million-cluster tail: the bucketed engine's 10M
    # tier emits ~2.28M clusters, and naming each one is millions of LLM
    # round trips nobody asked to pay for. Only the max_clusters LARGEST
    # clusters (ties broken by cluster id, so the set is deterministic) are
    # sent to the naming services; the rest keep their aggregated label
    # text and render under their cluster id — an explicit, documented
    # skip, surfaced in metrics.counters["naming_skipped"]. 0 = unlimited
    # (the reference names everything, workflow.go:187-229; jobs that
    # small never hit the default budget anyway).
    max_clusters: int = 50_000


@dataclass
class ServiceConfig:
    """HTTP service — parity with main.go / internal/handlers."""

    host: str = "0.0.0.0"
    port: int = 8080  # main.go:24
    max_upload_bytes: int = 32 << 20  # handlers.go:71
    static_dir: str = "frontend/build"  # main.go:21
    # Per-job workdirs replace the reference's single global temp dir
    # (handlers.go:26-46), fixing its one-request-clobbers-another bug.
    work_dir: str = ""
    # Retention for finished jobs (pruned after each new job).
    max_jobs: int = 50
    max_job_age_s: float = 7 * 24 * 3600.0
    # clusters.html stays one self-contained file (reference parity,
    # utils.go:23-214) up to this many clusters; bigger jobs paginate into
    # clusters_p{k}.html shards behind an index page — a 100k-image job
    # yields ~21k clusters, a single page a browser cannot open.
    report_page_size: int = 500


@dataclass
class MeshConfig:
    """Device mesh layout for SPMD execution."""

    # Axis sizes; -1 means "all remaining devices".
    data: int = -1
    model: int = 1


@dataclass
class AppConfig:
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
    preprocess: PreprocessConfig = field(default_factory=PreprocessConfig)
    embed: EmbedConfig = field(default_factory=EmbedConfig)
    labels: LabelConfig = field(default_factory=LabelConfig)
    naming: NamingConfig = field(default_factory=NamingConfig)
    service: ServiceConfig = field(default_factory=ServiceConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def replace(self, **sections: Any) -> "AppConfig":
        return dataclasses.replace(self, **sections)


def _coerce(value: str, target_type: Any) -> Any:
    if target_type is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if target_type is int:
        return int(value)
    if target_type is float:
        return float(value)
    if target_type in (tuple, tuple[str, ...]):
        return tuple(v.strip() for v in value.split(",") if v.strip())
    return value


def _apply_mapping(cfg: Any, data: Mapping[str, Any]) -> Any:
    """Recursively apply a nested mapping onto a dataclass tree."""
    updates = {}
    for f in dataclasses.fields(cfg):
        if f.name not in data:
            continue
        value = data[f.name]
        current = getattr(cfg, f.name)
        if dataclasses.is_dataclass(current) and isinstance(value, Mapping):
            updates[f.name] = _apply_mapping(current, value)
        elif isinstance(current, tuple) and isinstance(value, (list, tuple)):
            updates[f.name] = tuple(value)
        else:
            updates[f.name] = value
    return dataclasses.replace(cfg, **updates)


def _apply_env(cfg: AppConfig, environ: Mapping[str, str]) -> AppConfig:
    """Apply IMAGECLUST_<SECTION>_<FIELD>=value environment overrides."""
    for key, raw in environ.items():
        if not key.startswith(_ENV_PREFIX):
            continue
        rest = key[len(_ENV_PREFIX):].lower()
        for f in dataclasses.fields(cfg):
            prefix = f.name + "_"
            if not rest.startswith(prefix):
                continue
            section = getattr(cfg, f.name)
            field_name = rest[len(prefix):]
            for sf in dataclasses.fields(section):
                if sf.name == field_name:
                    current = getattr(section, sf.name)
                    coerced = _coerce(raw, type(current))
                    section = dataclasses.replace(section, **{sf.name: coerced})
                    cfg = dataclasses.replace(cfg, **{f.name: section})
    return cfg


def load_config(
    yaml_path: str | None = None,
    overrides: Mapping[str, Any] | None = None,
    environ: Mapping[str, str] | None = None,
) -> AppConfig:
    """Build the config: defaults <- YAML <- env <- explicit overrides."""
    cfg = AppConfig()
    if yaml_path and os.path.exists(yaml_path):
        import yaml

        with open(yaml_path) as fh:
            data = yaml.safe_load(fh) or {}
        cfg = _apply_mapping(cfg, data)
    cfg = _apply_env(cfg, environ if environ is not None else os.environ)
    if overrides:
        cfg = _apply_mapping(cfg, overrides)
    return cfg
