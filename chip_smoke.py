#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``imageclust_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``imageclust_tpu_torch/csrc`` and drives
the port end to end on the card, phase by phase; each phase prints one JSON
line and raises on any failure:

1. the card (``nvidia-smi`` name and power limit, printed as given) and the
   kernel build;
2. K1 (``merge_update_argmin``) against its plain PyTorch twin on the card
   at n in {128, 256, 1024, 2048, 4096}: random and integer-grid (tied)
   matrices,
   random active/size/birth patterns, ``do_update`` 0 and 1, an
   all-infeasible case — bit-identical (D, dmin, bhi, blo) required; then
   whole exact runs at n in {128, 1024} on normal, integer-grid and
   d = 2 integer-grid (heavy ties) features, K1's loop steps (its per-row
   cache, the fused bookkeeping) against the twin steps on a copy of the
   state: (dmin, bhi, blo) bit-identical at every step, final D, log,
   births, sizes and active too, with the rows rescanned per merge; then
   the times of a call without a loop (one full scan) and of a cached call
   in a loop's steady state (CUDA events, warm, median of 25; the
   profiler's kernel time) beside their bounds (bytes moved over
   3.35 TB/s);
3. the exact engine (``constrained_ward``) at n = 4096, d = 1000 on
   integer-grid features and on Gaussian blobs: the K1 loop in CUDA graphs
   against the twin's loop run step by step, identical merge logs and
   clusters required; ms per merge, the device-busy share, K1's summed
   device time, the rows rescanned per merge and the loop's peak device
   memory;
4. the server (stdlib HTTP) in-process with full-width ResNet50 (bf16, s2d
   stem, seeded random init) and fake naming: three ``POST /api/cluster``
   (18 images in 3 colour groups, 200 images, the 18 again with
   ``?async=1``), then ``/api/result``, ``/api/view``, ``/api/image`` and
   ``/healthz``;
5. ``cli run`` on 2000 BMPs in a temp directory (below ``exact_limit``);
6. K3 (``merge_update_argmin_batched``) against its twin on the card: C in
   {1, 8, 261} buckets of B in {128, 512}, random and integer-grid
   matrices, mixed ``do_update``, ``absorb_min`` -1 and 3, an all-infeasible
   bucket; bit-identical (D, dmin, bhi, blo) required; then whole lockstep
   chunks (both phases, both rules, normal, integer-grid and d = 2 tied
   features, B in {128, 200, 512}, C up to 261), K3's loop steps (its
   per-bucket row cache, the fused bookkeeping) against the twin steps on
   a copy of the state: the whole state bit-identical after every
   iteration, with the rows rescanned per bucket and call; then the times
   of a call without a loop (one full scan) and of a cached call after 100
   iterations, at C = 261, B = 512 (a 100,000-image job's one chunk),
   beside their bounds;
7. K2 (``merge_loop_whole``) against its twin and against the K3 lockstep
   loop under Lance-Williams: C in {3, 64, 256}, B in {128, 512}, counts
   mixing 0.75 B, 37, 5 and 0, absorb on and off, normal, integer-grid and
   d = 2 integer-grid (heavy ties) features; C = 2, B = 4096 with a full
   bucket, normal and tied, absorb on; identical log, step, births, sizes,
   active and final D required; times at C = 256, B = 512 with 384 items a bucket (CUDA events
   around a burst, the profiler beside them) against the bound of one read
   of the matrices, with the full-scan design's pair visits and the longest
   bucket's merge count beside it;
8. the bucketed engine (``constrained_ward_bucketed``) at n = 100,000,
   d = 1000 on seeded normal features, Lance-Williams (K2) and centroid
   (K3 in CUDA graph replays), each also with the kernels swapped for
   their twins (the lockstep loop then runs the twin step eagerly):
   identical merge logs and clusters, sizes in [3, 6], no image lost; K2's
   summed device time (CUDA events around each call) beside the
   bucket-merges phase; for the centroid rule the lockstep loop's seconds,
   its peak device memory, and one iteration split into K3, the float work
   and the gaps (torch.profiler over a third run);
9. ``cli run`` on 4500 BMPs (above ``exact_limit``): streamed ingest, the
   bucketed engine on K2, the report;
10. ``Pipeline.run_stream`` on 16,384 images made on the card as CUDA
    ``uint8`` chunks, 49 K6 launches a ResNet50 batch;
11. K5 (``short_seq_attention``) against its twin on the card at (B, T, H,
    Dh) in {(1024, 50, 12, 64), (7, 128, 16, 64), (5, 17, 4, 32),
    (3, 1, 1, 64)}, bf16 (allclose at 0.02) and f32 (at 1e-5); times at
    ViT-B/32's (1024, 50, 12, 64) bf16 beside the bound and
    ``scaled_dot_product_attention`` (a yardstick the port never calls);
12. the full-width ViT-B/32 tower (bf16, batch 1024, seeded random init)
    on 4096 noise images through ``Embedder.embed``, once on K5 and once
    with ``models.vit.attention`` swapped for the twin: per-row cosine
    >= ``VIT_COS_FLOOR``, 12 K5 launches per batch, images/s; then
    ``Embedder.embed_blob`` on 256 of the images preprocessed on the host
    into a float32 NCHW blob, per-row cosine against ``embed``'s rows >=
    ``BLOB_COS_FLOOR``;
13. the server of phase 4 with ``embed.model=vit_b32``;
14. ``cli run --model vit_b32`` on 4500 BMPs (streamed, the bucketed
    engine on K2), 12 K5 launches per batch of 1024;
15. ``vit_b16``, ``vit_l14``, ``vit_l14_336`` and ``siglip_so400m`` at full
    width on 256 images each: finite (256, proj_dim) output, no K5 launch
    (their sequences are longer than 128), images/s;
16. K4 (``pref_topk_block``) against its twin on the card: a 2M-row job's
    summarize pass (2,000,000 x 5209 centroids at d = 512 in bf16 and f32,
    d = 1024 in int8; every row compared), small shapes, ties
    across tiles, k = 5 < kk, an odd width (d = 1037), and the
    streaming-row path at 262,144 x 4100 (bf16 d = 1000, int8 d = 2000,
    f32 d = 1000); integer-grid inputs bit-identical, normal inputs equal
    up to near ties; times of each dtype and row path (CUDA events around
    a burst, the profiler beside them) beside their bounds, the twin's and
    a ``torch.matmul`` + ``torch.topk`` yardstick (bf16 and f32);
17. the bucketed engine at n = 1,600,000 (4167 buckets: one K4 launch) on
    seeded normal features in int8 (d = 1024) and f32 (d = 512; bf16 at
    d = 512 is phase 18's engine run): sizes in [3, 6], no image lost; the
    int8 run identical to a run with every kernel swapped for its twin,
    the f32 assignments' share that matches a twin summarize on the same
    centroids at least ``ASSIGN_MATCH_FLOOR``; K2's summed device time
    beside bucket-merges;
18. ``Pipeline.run_stream`` on 1,600,000 images made on the card, with
    ``embed.model=vit_b32`` (full width, its depth cut to
    ``STREAM_VIT_DEPTH`` = 2 blocks) and ``cluster.feature_dtype=bfloat16``
    (4167 buckets): 2 K5 launches a batch, one K4 launch, the naming
    budget;
19. ONNX at full width: the seeded ResNet50 (1000 classes) exported twice
    through the port's exporter into ``$IMAGECLUST_SMOKE_OUT`` (equal
    sha256), loaded through ``embed.onnx_path`` (weights bit-identical to
    the seeded ones), 256 images through both towers (max abs difference,
    per-row cosine >= ``ONNX_COS_FLOOR``), the seeded tower's
    ``Embedder.embed_blob`` on those images as a host-made float32 blob
    against its ``embed`` (as in phase 12), then one 200-image
    ``POST /api/cluster`` and a 500-image ``cli run`` from the file (which
    is deleted after);
20. the int8 PTQ towers at full width, ResNet50 and ViT-B/32: calibration
    seconds, images/s on 4096 images beside the bf16 tower's (turns bf16,
    int8, int8, bf16), per-row cosine of int8 against bf16; ViT-B/32's int8
    tower on K5 (12 launches a batch) against the same tower on the twin's
    attention, per-row cosine >= ``VIT_COS_FLOOR``; one 200-image
    ``POST /api/cluster`` with ``embed.model=vit_b32`` and
    ``embed.quantize=int8`` (12 K5 launches), and a 500-image ``cli run``
    with ``embed.quantize=int8`` (ResNet50);
21. the CLIP ViT-B/32 text tower at full width (vocab 49,408, width 512,
    depth 12, heads 8, context 77, proj 512) from a seeded HF-named ``.pt``
    in ``$IMAGECLUST_SMOKE_OUT`` through ``TextEncoder.from_checkpoint``
    (the hashing tokenizer: no merges file in the repository): the card
    against the same weights on the CPU (per-row cosine >=
    ``TEXT_COS_FLOOR``, max abs difference), names/s through ``encode`` on
    4096 names, one 256-row batch's device ms, no K5 launch; a zero-shot
    bank over the builtin vocabulary with ``vit_b32`` (unit rows);
22. ``cli bank --model vit_b32`` on three colour directories drawn like
    phase 4's groups, then the server with ``embed.model=vit_b32``,
    ``labels.backend=zero_shot`` (that bank), ``labels.fusion=text`` and
    the phase-21 checkpoint: one 18-image request, labels fired, colour
    groups recovered, K1 in its window, 12 K5 launches;
23. ``Pipeline.run_stream`` on 1,600,000 images as in phase 18, with
    ``labels.backend=zero_shot`` (a ``cli bank`` over four of the job's own
    colour bases) and ``labels.fusion=text``: BASELINE config 5's joint
    features, 512 + 512 bf16 columns into the engine, 2 K5 launches a
    batch (the tower and the bank's at 2 blocks, as in phase 18), one K4
    launch, labels fired; then K4 on this job's centroids against its twin
    at bf16 d = 1024, every differing pick a near tie of the float32 score;
24. the NN-chain engine (``constrained_ward_chain``): at n = 4096, d = 512
    (seeded Gaussian features, the JAX spot check's shape) the same
    partition and dropped set as the exact engine on K1 under the centroid
    rule; at n = 10,000, d = 64 the sequential chain (CUDA graph replays)
    gives the card's rounds' partition, with its steps per second, and on
    the first 5000 rows the rounds on the CPU give the card's; the rounds
    on phase 8's 100,000 x 1000 features: sizes in [3, 6], no image lost,
    the caller's features unchanged, wall s, recompute and merge rounds
    with their seconds, the loop's peak device memory, and the agreement
    (ARI, NMI, pair recall and precision) of the bucketed engine's
    partition with the chain's;
25. ``cli run --model vit_b32 --set cluster.scale_engine=chain`` on phase
    14's 4500 BMPs (12 K5 launches a batch, no K1-K4 launch) and its
    agreement with phase 14's bucketed partition; ``Pipeline.run_stream``
    on 100,000 images made on the card with ``vit_b32`` and the chain
    engine (BASELINE config 3's job size with ViT-B/32 in place of
    ViT-L/14@336);
26. the quality scoreboards (``cluster/quality.py``): residency (bf16 and
    int8 against f32, sep = 1) at tests/test_agreement.py's size (n = 2000,
    d = 64), held to all its floors, and at n = 100,000, d = 256 (BASELINE
    round 5's size), held to the seed yardstick, NMI and truth floors (the
    JAX package's own rows there sit under the ARI and F1 floors, which
    the line prints as missed); text fusion against one-hot at
    n = 20,000, d = 256; int8 PTQ against bf16 towers for ResNet50 and
    ViT-B/32 on 2048 images; every row on its own line, with the K2 (and
    K5) launches of each;
27. fine-tuning at full width (``models/finetune.py``): the committed
    Orbax fixture (tests/data/orbax_small, written by the JAX package:
    OCDBT, zstd with compressed blocks) read bit for bit, with the libzstd
    found; 8 labelled folders of 64 seeded colour-block BMPs at 224 x 224;
    a seeded ResNet50 exported to ONNX and the tower warm-started from it;
    ``finetune_resnet50`` (stage layers 3, 4, 6, 3, bf16, batch 64, AdamW
    1e-3) for 2 epochs, each epoch's loss (it must fall) and images/s after
    its first step, the peak memory; a second run with ``epochs=3`` that
    resumes at epoch 2 and runs one epoch; the train step in ms (CUDA
    events) with its peak memory and a profiler split into convolutions
    and the rest, with the top kernels; the step at batch 8 on the card
    against the CPU from the tuned weights and one batch (float32,
    TF32 off: loss rtol 1e-4, gradients relative L2 1e-3, batch_stats rtol
    1e-4; bf16: loss rtol 1e-2, gradient cosines >= 0.99); 256 images through
    ``embed.checkpoint_path`` bit-identical to the in-memory tuned tower;
    an 18-image server request from the checkpoint with its K1 launches;
    one ``cli train`` subprocess for one epoch and its JSON line.
28. the mesh (``core/mesh.py``, ``parallel/``): ranks started by
    ``launch_processes(device="cuda")``, (a) one rank over NCCL, (b) two
    ranks sharing the card over gloo, each against the single card: the
    exact engine at 512 x 1000, the bucketed engine at 100,000 x 1000
    under both rules (K2 and K3 on every rank), over gloo also the
    chain's rounds at 4096 x 512, the sequential chain at 200 x 64,
    ``run_paths`` on 4500 BMPs and the full-width train step at batch 64
    at (data=2, model=1) and (data=1, model=2), at seeded and tuned
    weights, each beside the float64 gradient.
29. the cloud backends and ``cli verify``: a local ``http.server`` plays the
    container credentials endpoint and IMDSv2, reached by
    ``resolve_credentials`` through the port's real ``urllib`` transport;
    a stub at that transport's seam answers Rekognition, Bedrock (Claude,
    Nova) and OpenAI, recomputing every SigV4 signature from the
    credentials served and refusing a wrong one, with one 429 before a
    success for Rekognition, Claude and OpenAI and a 403 on every Nova
    request of the clusters labelled ``Colour g00`` (they end in the
    fallback pair); one 200-image ``Pipeline.run`` (full-width ResNet50,
    ``labels.backend=rekognition``, namers Claude Haiku, Nova Micro and
    GPT-3.5) on the card: the labels in its cache equal the canned ones
    image by image, the names are the stub's titles in display order, K1
    in its window, sizes in [3, 6], no image lost; the same job again on
    its label cache sends no Rekognition request; the payload shrink of an
    18 MB BMP (a JPEG at most 2048 px where cv2 is importable, else the
    ValueError naming cv2); ``cli verify --clip-text`` (PASS) on the
    phase-21 checkpoint and ``--onnx`` on a seeded export (PASS with cv2,
    else exit 2 naming cv2), both with ``--device cuda``.
30. the benchmark harness (``imageclust_tpu_torch/bench.py``, ``cli
    bench``) in this process, each mode once at a small size: e2e and
    e2e-stream on 4096 images (ResNet50, batch 512), cluster-only auto at
    4096 x 64 (the exact engine, K1) and bucketed at 100,000 x 64 (K2),
    embed-only for ``resnet50`` and ``vit_b32`` on 4096 images, decode on
    1000 JPEGs (the RuntimeError naming cv2 where cv2 is missing), quality
    at 5000 x 64 without towers; each mode's result line is a phase line,
    held to bench.py's metric name, a positive value, ``vs_baseline``
    null exactly in the four modes that divide by the TPU north star,
    the card as ``nvidia-smi`` names it, the e2e features on the card
    and the K1, K2 and K5 launches of the modes that reach them.
31. K6 (``bn_act``, the ResNet50 tower's inference BatchNorm, residual and
    ReLU) against its twin on the card, bit for bit, at every shape of
    the tower at batch 512 with its residual kind (and, at the stem and
    stage 3's output, every residual kind in the other dtype pairs); the
    full-width bf16 tower (s2d stem, batch 512) on K6 against the same
    tower on the twin: logits bit-identical, 49 launches a batch, ms a
    batch, peak memory and a profiler split; K6's times at each shape
    beside its bound (bytes over 3.35 TB/s) and the twin's.

Each launch counter is set to 0 just before the job that reads it and read
just after. K1: every exact job's launches lie in [merges, merges + K],
K = ``FOUND_READ_EVERY`` (the steps of one CUDA graph replay: the loop
reads ``found`` after each, so the last replay may run gated no-op
steps; a replay counts the K1 launches captured in it). K2: one launch per chunk the
bucket dispatcher formed. K3: each lockstep phase launches between its
iterations + 1 and its iterations + K times (64 iterations a CUDA graph
replay, one host read of the chunk's "a bucket ran" flag after each). K4: one launch per job with
k >= 4096 buckets on the card, none below. The line before the last is
the ``{"kernels": [...]}`` summary (K1's launches from the server phase
and phase 29's first job, K2's
and K3's from the 100,000-image engine runs, K5's from the ViT server
phase and the int8 ViT server request of phase 20, each with phase 30's
launches of it added, K4's from the
1.6M-image ``run_stream``; phases 21-27 print their launches on their
own lines); the last line is
``{"ok": true, "device": {...}}``. Long outputs (the nvcc log, the CLI
job's result) go to ``$IMAGECLUST_SMOKE_OUT`` (default ``build/chip_smoke``).
Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository. ``--phases 11,12`` runs only the named phases
after the build (a development run: no summary, no result line).
"""

from __future__ import annotations

import contextlib
import hashlib
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
K1_KERNEL = ("merge_update_argmin_kernel",)  # K1's name in a profile
K3_KERNEL = ("lockstep_step_kernel",)  # K3's
TIMING_REPS = 25
DEVICE = "cuda"
ENGINE_N = 4096     # phase 3: the exact engine's largest padded size
CLI_GROUPS = 400    # phase 5: 400 groups x 5 = 2000 images (< exact_limit)
SERVER_GROUPS = 40  # phase 4: 40 groups x 5 = 200 images in one request
BIG_N, BIG_D = 100_000, 1000  # phase 8: the bucketed engine's job
# phase 6: K3 at the 100,000-image job's one chunk (261 buckets of 512
# slots, 384 items each), its cached call timed after 100 iterations
K3_C, K3_B, K3_ITEMS, K3_WARM_ITERS = 261, 512, 384, 100
SPIN_CYCLES = 200_000  # about 0.1 ms of device spin ahead of a queued call
BIG_CLI_GROUPS = 900  # phase 9: 900 groups x 5 = 4500 images (> 4096)
STREAM_N = 16_384      # phase 10
FP32_OPS_PER_S = 67e12  # H100 SXM data sheet, FP32 outside the tensor cores
# K2's work on these inputs: one scan of each bucket's active pairs, per
# (row, column) pair: bounds, diagonal and activity tests, a size add and
# compare, the absorb test, two birth loads, max, min and the lexicographic
# compare; then per merge and slot: dvec's nine operations and one candidate
# folded into the slot's cached minimum, a pair's work
# (csrc/merge_loop_whole.cu)
K2_OPS_PER_PAIR = 12
K2_OPS_PER_MERGE_SLOT = 9 + K2_OPS_PER_PAIR
BF16_OPS_PER_S = 989e12  # H100 SXM data sheet, dense bf16 tensor cores
VIT_B32_DEPTH = 12      # encoder blocks of ViT-B/32: one K5 launch each
VIT_N = 4096            # phase 12: images through the full-width ViT-B/32
VIT_COS_FLOOR = 0.999   # phase 12: per-row cosine, K5 run vs twin run
VIT_CLI_GROUPS = 900    # phase 14: 900 groups x 5 = 4500 images
OTHER_TOWER_N = 256     # phase 15: images per tower
# phase 11: K5's shapes (B, T, H, Dh): ViT-B/32 at batch 1024, the longest
# sequence and the odd sizes the wrapper takes
K5_SHAPES = ((1024, 50, 12, 64), (7, 128, 16, 64), (5, 17, 4, 32),
             (3, 1, 1, 64))
K5_TOL = {"bfloat16": 0.02, "float32": 1e-5}  # tests/test_attention.py
INT8_OPS_PER_S = 1979e12  # H100 SXM data sheet, dense int8 tensor cores
# phase 16: K4 at a 2M-row job's summarize pass (k = ceil(2M / 384) buckets),
# every row held against the twin; then small shapes, ties across tiles
# (n, k, d, duplicated centroids), k = 5 < kk and an odd width (zero-padded
# centroids for TMA, byte-wise row copies; bf16 rows stream)
K4_N, K4_K, K4_KK = 2_000_000, 5209, 8
K4_SMALL = ((600, 19, 48, False), (16, 384, 128, False),
            (8, 256, 128, True), (300, 5, 64, False), (513, 389, 1037, False))
# phase 16: the streaming-row path of the tensor-core kernel at a mid size
# (rows wider than 1 KB stream beside the centroid slabs: bf16 d = 1000,
# int8 d = 2000); f32 has one row path, timed at d = 1000 beside them
K4_STREAM_N, K4_STREAM_K = 262_144, 4100
K4_STREAM_D = {"bfloat16": 1000, "int8": 2000, "float32": 1000}
K4_KERNELS = ("pref_topk",)  # K4's kernels' names in a profile
K4_NEAR_TIE = 1e-5  # relative, float64 distances of differing picks
# phase 17: least share of f32/bf16 k-means assignments equal to a twin
# summarize's on the same centroids (they may differ only at near ties)
ASSIGN_MATCH_FLOOR = 0.9999
ENGINE_K4_N = 1_600_000  # phase 17: 4167 buckets, the K4 path
STREAM_BIG_N = 1_600_000  # phase 18: 4167 buckets (>= 4096 from 1,572,864)
# phases 18 and 23: ViT-B/32 at full width with its encoder cut from 12
# blocks to 2 (seeded random weights), so that the 1.6M-image streams
# spend their time in the stages after the tower
STREAM_VIT_DEPTH = 2
ONNX_SEED = 0          # phase 19: the seeded tower written to ONNX
ONNX_EMBED_N = 256     # phase 19: images through the seeded and loaded towers
ONNX_COS_FLOOR = 0.99999  # phase 19: per-row cosine, loaded vs seeded
# phases 12 and 19: per-row cosine of ``Embedder.embed_blob`` on a blob
# preprocessed on the host against ``Embedder.embed`` on the same uint8
# images (the bf16 floor of tests/test_torch_resnet50.py and _vit.py)
BLOB_N = 256
BLOB_COS_FLOOR = 0.99
INT8_N = 4096          # phase 20: images through each int8 and bf16 tower
INT8_CLI_GROUPS = 100  # phases 19-20: 100 groups x 5 = 500 images, cli run
TEXT_SEED = 21          # phase 21: the seeded CLIP text tower
TEXT_N = 4096           # phase 21: names through TextEncoder.encode
TEXT_CPU_N = 64         # phase 21: names through the card and the CPU tower
TEXT_COS_FLOOR = 0.99999  # phase 21: per-row cosine, card vs CPU
BANK_IMAGES_PER_LABEL = 4  # phases 22-23: BMPs per label directory
# phase 24: the chain engine against the exact engine (K1) at the JAX spot
# check's shape, the sequential chain against the rounds, then the rounds
# on phase 8's features
CHAIN_GREEDY_N, CHAIN_GREEDY_D = 4096, 512
CHAIN_SEQ_N, CHAIN_SEQ_D = 10_000, 64
CHAIN_CPU_N = 5_000  # the rounds on the card against the CPU, at CHAIN_SEQ_D
CHAIN_STREAM_N = 100_000  # phase 25: run_stream, BASELINE config 3's size
# phases 18, 23 and 25: the streamed jobs name their largest clusters only
# (naming.max_clusters; the default 50,000 kept the fake namer on the host
# for 23-56 s a job)
STREAM_NAMING_BUDGET = 1_000
# phase 26: the scoreboards' sizes (residency: tests/test_agreement.py's
# size, where its floors were set, and BASELINE.md round 5's `bench.py
# --quality` size) and tests/test_agreement.py's floors. At 100,000 x 256
# the JAX package recorded ARI 0.244 (bf16) and 0.182 (int8) against a
# 0.049 seed yardstick (BASELINE.md round 5), under the ARI and F1 floors:
# there the run is held to the yardstick, NMI and truth floors and prints
# the other two
SCORE_RESIDENCY_FLOORS = (2000, 64)
SCORE_RESIDENCY = (100_000, 256)
SCORE_FUSION = (20_000, 256)
SCORE_PTQ_N = 2048
QUALITY_FLOORS = {"ari": 0.30, "same_pair_f1": 0.30, "nmi": 0.80,
                  "truth_ari_below_f32": 0.05}
# phase 27: fine-tuning at full width: 8 classes x 64 BMPs at 224, batch 64,
# two epochs at lr 1e-3 (bf16), the card-vs-CPU step at batch 8, and 256
# images through the served checkpoint
FT_CLASSES, FT_PER_CLASS = 8, 64
FT_BATCH, FT_EPOCHS, FT_LR = 64, 2, 1e-3
FT_CHECK_BATCH = 8
FT_SERVE_N = 256
# phase 30: the benchmark harness's modes in-process, cut to run in about
# 40 s (the full-size runs are `python -m imageclust_tpu_torch.cli bench`)
BENCH_E2E_N = 4096      # e2e and e2e-stream images (ResNet50)
BENCH_E2E_BATCH = 512   # e2e: bench.py's --batch 0 for the e2e benches
BENCH_CLUSTER = ((4096, "auto"), (100_000, "bucketed"))  # cluster-only
BENCH_D = 64            # cluster-only and quality feature width
BENCH_EMBED_N = 4096    # embed-only images per tower
BENCH_DECODE_N = 1000   # decode: JPEG copies (cv2)
BENCH_QUALITY_N = 5000  # quality: residency and fusion rows, no towers

_JOBS: dict = {}  # cli_run_big results by tag, for phase 25's agreement


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


def burst_ms(fn, reps: int = TIMING_REPS, warm: int = 3) -> float:
    """Device time per call of ``fn`` from CUDA events around ``reps``
    back-to-back calls (the card stays busy while the host's per-call work
    is shorter than the kernel)."""
    import torch

    for _ in range(warm):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


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
    # 128, 256 and 2048 are the padded sizes of the main path's jobs
    # (18, 200 and 2000 images), 4096 the exact engine's largest; 1024
    # sits between
    for n in (128, 256, 1024, 2048, 4096):
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

    # the loop's calls: the kernel's cached steps against the twin steps
    # on a copy of the state, over whole exact runs
    sequences = []
    for n in (128, 1024):  # phase 3 runs the engine at 4096
        for data, rule in (("normal", "centroid"), ("integer_grid", "centroid"),
                           ("grid_d2", "lance_williams")):
            sequences.append(_k1_sequence(n, data, rule))
    emit({"phase": "k1_cached_parity", "runs": sequences,
          "parity": "bit-identical: (dmin, bhi, blo) every step; final D, "
                    "log, births, sizes, active, ctl"})

    timings = {}
    for n in (1024, 4096):
        # the stateless call (one full scan) at the main path's heaviest
        # state: every slot active, update pending
        D, dvec, births, sizes, active = _k1_state(gen, n, dev, False, 1.0)
        args = (dvec, torch.tensor([n // 2], dtype=torch.int32, device=dev),
                torch.ones(1, dtype=torch.int32, device=dev), births, sizes,
                active, 6)
        call = lambda: mk.merge_update_argmin(D, *args)  # noqa: E731
        plain = lambda: mk.merge_update_argmin_plain(D, *args)  # noqa: E731
        # wall time of a call, the wrapper's host work included, and the
        # device time of the kernel alone
        full_call_ms = cuda_ms(call)
        full_plain_ms = cuda_ms(plain)
        full_ms = device_ms(call, K1_KERNEL)
        full_plain_device_ms = device_ms(plain)
        n_act = int(active.sum())
        # each active row of D read once, one row + one column written,
        # dvec/births/sizes/active read once
        full_bytes = n_act * n * 4 + 2 * n * 4 + 4 * n * 4
        cached = _k1_cached_times(n)
        timings[n] = dict(ms=cached["device_ms"],
                          plain_ms=cached["plain_device_ms"],
                          call_ms=cached["call_ms"],
                          bound_ms=cached["bound_ms"],
                          rescans_per_call=cached["rescans_per_call"],
                          full_scan_ms=full_ms, full_scan_call_ms=full_call_ms,
                          full_scan_plain_ms=full_plain_device_ms,
                          full_scan_bound_ms=full_bytes / HBM_BYTES_PER_S * 1e3)
        emit({"phase": "k1_time", "n": n, "card": card,
              "full_scan": {"kernel_device_ms": full_ms,
                            "kernel_call_ms": full_call_ms,
                            "plain_ms": full_plain_ms,
                            "plain_device_ms": full_plain_device_ms,
                            "bound_ms": timings[n]["full_scan_bound_ms"],
                            "bytes": full_bytes},
              "cached": cached, "bound_by": "bytes",
              "timing": f"*call_ms / plain_ms: CUDA events, median of "
                        f"{TIMING_REPS} warm calls; *device_ms: "
                        f"torch.profiler kernel time, mean of {TIMING_REPS}"})
    return max_err, timings


def _loop_features(n, data, d, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    if data == "normal":
        return rng.normal(size=(n, d)).astype(np.float32)
    if data == "integer_grid":
        return rng.integers(-2, 3, (n, d)).astype(np.float32)
    if data == "grid_d2":
        return rng.integers(-3, 4, (n, 2)).astype(np.float32)
    # "gaussian_blobs": groups of 5 around seeded centres, a photo job's look
    centres = rng.normal(size=(-(-n // 5), d)).astype(np.float32) * 4.0
    return (np.repeat(centres, 5, axis=0)[:n]
            + rng.normal(size=(n, d)).astype(np.float32))


def _loop_states(n, data, d=64):
    """Two copies of an exact loop's initial state on n items (n_pad = n)
    and its step limit."""
    import torch

    from imageclust_tpu_torch.cluster import ward

    x = torch.from_numpy(_loop_features(n, data, d, n)).to(DEVICE)
    limit = n - ward.calculate_optimal_clusters(n, 3, 6)
    return [ward._loop_state(x, n, limit, 6) for _ in range(2)], limit


def _k1_sequence(n, data, rule):
    """A whole exact run with K1's loop steps and, on a copy of the state,
    the twin's steps, both eager: (dmin, bhi, blo) compared at every step
    on the card, the final state at the end."""
    import torch

    from imageclust_tpu_torch.cluster import ward
    from imageclust_tpu_torch.ops import merge_kernels as mk

    ((st_k, c_k), (st_p, c_p)), limit = _loop_states(n, data)
    i32 = torch.int32
    bad = torch.zeros((), dtype=torch.int64, device=DEVICE)
    for _ in range(limit + 2):  # two gated no-op steps past the limit
        mk.merge_step(st_k)
        mk.merge_step_plain(st_p)
        bad += (st_k.out_d.view(i32) != st_p.out_d.view(i32)).sum()
        bad += (st_k.out_pair != st_p.out_pair).sum()
        ward._float_step(st_k, c_k, rule)
        ward._float_step(st_p, c_p, rule)
    torch.cuda.synchronize()
    same = {name: _same_bits(getattr(st_k, name), getattr(st_p, name))
            for name in ("D", "log", "births", "sizes", "active")}
    same["ctl"] = torch.equal(st_k.ctl[:mk.CTL_FILLED + 1],
                              st_p.ctl[:mk.CTL_FILLED + 1])
    steps = int(st_k.ctl[mk.CTL_STEP])
    if int(bad) or not all(same.values()) or steps != limit:
        raise AssertionError(f"K1 cached steps != twin steps at n={n} "
                             f"{data}: {int(bad)} step mismatches, {same}, "
                             f"{steps} of {limit} merges")
    return {"n": n, "data": data, "rule": rule, "merges": steps,
            # every merge but the last is followed by one cached call
            "rows_rescanned_per_merge":
                int(st_k.ctl[mk.CTL_RESCAN_TOTAL]) / max(steps - 1, 1),
            "rows_rescanned_max": int(st_k.ctl[mk.CTL_RESCAN_MAX])}


def _k1_cached_times(n):
    """K1's cached call in a loop's steady state (normal d = 64 data, the
    centroid rule, after n / 4 merges), eager steps: call ms (CUDA events
    around the wrapper), device ms (torch.profiler), the twin step's times
    on a copy of the state in step with it, and the bound of what a cached
    call moves."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from imageclust_tpu_torch.cluster import ward
    from imageclust_tpu_torch.ops import merge_kernels as mk

    ((st, cents), (sp, cp)), _ = _loop_states(n, "normal")
    for _ in range(n // 4):
        for state, c, step in ((st, cents, mk.merge_step),
                               (sp, cp, mk.merge_step_plain)):
            step(state)
            ward._float_step(state, c, "centroid")
    torch.cuda.synchronize()

    def timed(state, c, step):
        events = []
        for _ in range(TIMING_REPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            step(state)
            b.record()
            ward._float_step(state, c, "centroid")
            events.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in events)

    def profiled(state, c, step, match):
        # the float work runs outside the window, unprofiled
        total_us = 0.0
        for _ in range(TIMING_REPS):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                step(state)
                torch.cuda.synchronize()
            total_us += _kernel_us(prof, match)
            ward._float_step(state, c, "centroid")
        return total_us / TIMING_REPS / 1e3 if total_us else None

    r0 = int(st.ctl[mk.CTL_RESCAN_TOTAL])
    call_ms = timed(st, cents, mk.merge_step)
    rescans = (int(st.ctl[mk.CTL_RESCAN_TOTAL]) - r0) / TIMING_REPS
    device = profiled(st, cents, mk.merge_step, K1_KERNEL)
    plain_call_ms = timed(sp, cp, mk.merge_step_plain)
    plain_device = profiled(sp, cp, mk.merge_step_plain, ())
    # row and column sa written, the rescanned rows read, the cache (16
    # bytes a row), births/sizes/active and dvec read once
    nbytes = 2 * n * 4 + rescans * n * 4 + 16 * n + 12 * n + 4 * n
    return {"device_ms": device or call_ms, "call_ms": call_ms,
            "plain_device_ms": plain_device or plain_call_ms,
            "plain_call_ms": plain_call_ms, "rescans_per_call": rescans,
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "merges_before": n // 4}


def phase_engine(card: str):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from imageclust_tpu_torch.cluster import ward
    from imageclust_tpu_torch.ops import merge_kernels as mk

    n, d = ENGINE_N, 1000
    kw = dict(min_size=3, max_size=6, update_rule="centroid",
              reassign_dropped=False, mesh=None, device=DEVICE)
    for data in ("integer_grid", "gaussian_blobs"):
        x = _loop_features(n, data, d, 7)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        mk.launches = 0
        t0 = time.perf_counter()
        with _stage_timer(ward, ("_merge_loop", "_loop_state",
                                 "_run_graphed")) as (stages_s, returned):
            run_graphed = ward._run_graphed
            graphed_peak, before = [], []

            def peak_of_graphed(*args, **kwargs):
                # the graphed steps' own peak: the graph pool and the state
                torch.cuda.synchronize()
                before.append(torch.cuda.max_memory_allocated())
                torch.cuda.reset_peak_memory_stats()
                at = torch.cuda.memory_allocated()
                run_graphed(*args, **kwargs)
                graphed_peak.append(torch.cuda.max_memory_allocated() - at)

            ward._run_graphed = peak_of_graphed
            got = ward._constrained_ward(x, None, merge_step=mk.merge_step,
                                         **kw)
        total_s = time.perf_counter() - t0
        peak = max(before + [torch.cuda.max_memory_allocated()]) - base
        launches = mk.launches
        ctl = returned["_loop_state"][0][0].ctl  # the loop's MergeState
        rescanned = int(ctl[mk.CTL_RESCAN_TOTAL])
        rescan_max = int(ctl[mk.CTL_RESCAN_MAX])
        t0 = time.perf_counter()
        ref = ward._constrained_ward(x, None, merge_step=mk.merge_step_plain,
                                     eager=True, **kw)
        plain_s = time.perf_counter() - t0
        merges = len(got.merges)
        if not (np.array_equal(got.merges, ref.merges)
                and got.cluster_map == ref.cluster_map
                and got.dropped == ref.dropped):
            raise AssertionError(f"exact engine: graphed K1 loop != eager "
                                 f"twin loop at n={n} on {data}")
        _check_launches("engine", launches, merges)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ward._constrained_ward(x, None, merge_step=mk.merge_step, **kw)
            torch.cuda.synchronize()
        all_us = _kernel_us(prof)
        k1_us = _kernel_us(prof, K1_KERNEL)
        k1_events = sum(e.count for e in prof.key_averages()
                        if any(m in e.key for m in K1_KERNEL))
        emit({"phase": "exact_engine", "card": card, "n": n, "d": d,
              "data": data, "merges": merges, "k1_launches": launches,
              "ms_per_merge": total_s * 1e3 / max(merges, 1),
              "total_s": total_s, "eager_twin_total_s": plain_s,
              # host clock; _merge_loop holds the other two and ends with
              # the copies to the host, _run_graphed with a read of `found`
              "stages_s": stages_s,
              "clusters": got.n_clusters, "logs_identical": True,
              # every merge but the last is followed by one cached call
              "rows_rescanned_per_merge": rescanned / max(merges - 1, 1),
              "rows_rescanned_max": rescan_max,
              # the engine's peak above what was allocated before it
              # (set by the Gram product's temporaries), and the peak
              # while the graphed steps ran, above what they started with
              "peak_device_bytes": peak,
              "graphed_steps_peak_bytes": graphed_peak[0],
              "profile": {"device_s": all_us / 1e6,
                          "k1_device_s": k1_us / 1e6,
                          "k1_events": k1_events,
                          "device_busy_share": all_us / 1e6 / total_s,
                          # nearly all device time is the steps' (the Gram
                          # product is about 1 ms)
                          "device_busy_share_of_graphed_steps":
                              all_us / 1e6 / stages_s["_run_graphed"],
                          "k1_share_of_wall": k1_us / 1e6 / total_s}})


@contextlib.contextmanager
def _stage_timer(module, names):
    """Host seconds spent in ``module``'s functions ``names`` while the
    block runs, and what each call returned (each wrapped, then
    restored)."""
    spent = dict.fromkeys(names, 0.0)
    returned = {name: [] for name in names}
    saved = {name: getattr(module, name) for name in names}

    def wrap(name, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kw)
            finally:
                spent[name] += time.perf_counter() - t0
            returned[name].append(out)
            return out
        return timed

    for name in names:
        setattr(module, name, wrap(name, saved[name]))
    try:
        yield spent, returned
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


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


def phase_server(card: str, model: str = "resnet50", embed_kw=None,
                 which=("18_images", "200_images", "18_images_async"),
                 name: str = "server", labels_kw=None):
    """The server with ``embed.model=model`` (and ``embed_kw``, and the
    label config ``labels_kw``): the requests named in ``which``, then the
    GET routes. Returns the main path's launches and the requests."""
    import numpy as np

    from imageclust_tpu_torch.config import (
        AppConfig,
        EmbedConfig,
        LabelConfig,
        ServiceConfig,
    )
    from imageclust_tpu_torch.ops import attention as at
    from imageclust_tpu_torch.ops import merge_kernels as mk
    from imageclust_tpu_torch.pipeline import Pipeline
    from imageclust_tpu_torch.service.app import create_server

    work = Path(tempfile.mkdtemp(prefix="imageclust_smoke_jobs_"))
    cfg = AppConfig(service=ServiceConfig(work_dir=str(work)),
                    embed=EmbedConfig(model=model, **(embed_kw or {})),
                    labels=LabelConfig(**(labels_kw or {})))
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
        mk.launches = at.launches = 0
        for label, (names, blobs, groups), query in (
                (label, batch, query) for label, batch, query in (
                    ("18_images", small, ""), ("200_images", big, ""),
                    ("18_images_async", small, "?async=1"))
                if label in which):
            body, ctype = _multipart(names, blobs, {"minClusterSize": 3,
                                                    "maxClusterSize": 6})
            if len(body) > cfg.service.max_upload_bytes:
                raise AssertionError(f"{label}: request is {len(body)} bytes")
            before, k5_before = mk.launches, at.launches
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
                "unique_labels": data["metrics"]["counters"].get(
                    "unique_labels"),
                "k1_launches": mk.launches - before,
                "k5_launches": at.launches - k5_before})
        main_path_launches = {"k1": mk.launches, "k5": at.launches}
        for path in (f"/api/result?job={job}", "/api/view",
                     f"/api/image/{names[0]}", "/healthz"):
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
    if model.startswith("vit"):
        # 12 encoder blocks, one K5 launch each, per embedded batch
        k5 = main_path_launches["k5"]
        if not (k5 > 0 and k5 % VIT_B32_DEPTH == 0):
            raise AssertionError(f"server {model}: {k5} K5 launches")
    elif main_path_launches["k5"]:
        raise AssertionError(f"server {model}: K5 launched")
    emit({"phase": name, "card": card, "model": model,
          "embed": embed_kw or {}, "labels": labels_kw or {},
          "embedder_tag": pipeline.embedder.tag,
          "pipeline_build_s": build_s, "requests": requests,
          "healthz": health, "launches": main_path_launches})
    return {**main_path_launches, "requests": requests}


def phase_cli(card: str, groups: int = CLI_GROUPS, extra=(),
              name: str = "cli_run"):
    """``cli run`` on ``groups`` x 5 BMPs (below ``exact_limit``), with the
    ``extra`` arguments."""
    import numpy as np

    from imageclust_tpu_torch import cli
    from imageclust_tpu_torch.ops import merge_kernels as mk

    tmp = Path(tempfile.mkdtemp(prefix="imageclust_smoke_cli_"))
    try:
        rng = np.random.default_rng(5)
        names, blobs, _ = group_images(rng, groups, 5, "c")
        img_dir = tmp / "images"
        img_dir.mkdir()
        for fname, blob in zip(names, blobs):
            (img_dir / fname).write_bytes(blob)
        out = io.StringIO()
        mk.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["run", "--images", str(img_dir), "--device",
                           DEVICE, "--out", str(tmp / "work"), *extra])
        wall_s = time.perf_counter() - t0
        launches = mk.launches
        if rc != 0:
            raise AssertionError(f"cli run exited {rc}")
        result = json.loads(out.getvalue())
        OUT.mkdir(parents=True, exist_ok=True)
        (OUT / f"{name}_result.json").write_text(out.getvalue())
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
    emit({"phase": name, "card": card, "images": n, "args": list(extra),
          "wall_s": wall_s,
          "stages_s": result["metrics"]["stages_s"],
          "embed_images_per_s": result["metrics"].get("images_per_sec_embed"),
          "clusters": len(result["clusters"]), "merges": merges,
          "k1_launches": launches,
          "output": os.path.relpath(OUT / f"{name}_result.json", REPO)})


# -- the scale path (phases 6-10) ----------------------------------------------

def _zero_counters():
    from imageclust_tpu_torch.cluster import sharded
    from imageclust_tpu_torch.ops import attention as at
    from imageclust_tpu_torch.ops import bn_act as ba
    from imageclust_tpu_torch.ops import bucket_kernels as bk
    from imageclust_tpu_torch.ops import merge_kernels as mk
    from imageclust_tpu_torch.ops import pref_kernels as pk

    mk.launches = mk.batched_launches = bk.launches = at.launches = 0
    pk.launches = ba.launches = 0
    sharded.chunks_dispatched = 0
    sharded.lockstep_iterations = sharded.lockstep_phases = 0


def _counters() -> dict:
    from imageclust_tpu_torch.cluster import sharded
    from imageclust_tpu_torch.ops import attention as at
    from imageclust_tpu_torch.ops import bn_act as ba
    from imageclust_tpu_torch.ops import bucket_kernels as bk
    from imageclust_tpu_torch.ops import merge_kernels as mk
    from imageclust_tpu_torch.ops import pref_kernels as pk

    return {"k1": mk.launches, "k2": bk.launches, "k3": mk.batched_launches,
            "k4": pk.launches, "k5": at.launches, "k6": ba.launches,
            "chunks": sharded.chunks_dispatched,
            "lockstep_iterations": sharded.lockstep_iterations,
            "lockstep_phases": sharded.lockstep_phases}


def _check_scale_launches(what: str, c: dict, rule: str,
                          k4: int = 0) -> None:
    """K2: one launch per chunk. K3: each lockstep phase launches between
    its iterations + 1 and its iterations + K times (its first iteration,
    then whole graph replays of K until one ends with an iteration that ran
    no bucket). K4: ``k4`` launches (one summarize pass at k >= 4096
    buckets, none below)."""
    from imageclust_tpu_torch.cluster.ward import FOUND_READ_EVERY

    if c["k4"] != k4:
        raise AssertionError(f"{what}: {c['k4']} K4 launches, want {k4}")
    if rule == "lance_williams":
        ok = c["k2"] == c["chunks"] > 0 and c["k3"] == 0
    else:
        lo = c["lockstep_iterations"] + c["lockstep_phases"]
        hi = c["lockstep_iterations"] + FOUND_READ_EVERY * c[
            "lockstep_phases"]
        ok = c["k2"] == 0 and c["chunks"] > 0 and lo <= c["k3"] <= hi
    if not ok:
        raise AssertionError(f"{what}: launch counts {c} for {rule}")


def _same_bits(a, b) -> bool:
    import torch

    if a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return bool(torch.equal(a, b))


def _k3_state(gen, C, B, dev, integer_grid, frac_active=0.8):
    import torch

    if integer_grid:
        d = torch.randint(0, 5, (C, B, B), generator=gen).float()
        dvec = torch.randint(0, 5, (C, B), generator=gen).float()
    else:
        d = torch.rand((C, B, B), generator=gen)
        dvec = torch.rand((C, B), generator=gen)
    d = ((d + d.transpose(1, 2)) / 2).contiguous()
    births = torch.stack([torch.randperm(2 * B, generator=gen)[:B]
                          for _ in range(C)]).to(torch.int32)
    sizes = torch.randint(1, 4, (C, B), generator=gen).to(torch.int32)
    active = (torch.rand((C, B), generator=gen) < frac_active).to(
        torch.int32)
    active[:, :2] = 1
    if C > 1 and frac_active < 1:
        active[-1] = 0  # a bucket where every pair is infeasible
    sa = torch.randint(0, B, (C,), generator=gen).to(torch.int32)
    do = torch.randint(0, 2, (C,), generator=gen).to(torch.int32)
    return [t.to(dev) for t in (d, dvec, sa, do, births, sizes, active)]


def phase_k3(card: str):
    import torch

    from imageclust_tpu_torch.ops import merge_kernels as mk

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(6)
    cases = 0
    for C in (1, 8, 261):
        for B in (128, 512):
            for grid in (False, True):
                D, dvec, sa, do, births, sizes, active = _k3_state(
                    gen, C, B, dev, grid)
                for amin in (-1, 3):
                    for max_size in (0, 6):  # 0: all infeasible
                        dk, dp = D.clone(), D.clone()
                        args = (dvec, sa, do, births, sizes, active,
                                max_size, amin)
                        got = mk.merge_update_argmin_batched(dk, *args)
                        want = mk.merge_update_argmin_batched_plain(dp, *args)
                        torch.cuda.synchronize()
                        if not all(_same_bits(g, w)
                                   for g, w in zip(got, want)):
                            raise AssertionError(
                                f"K3 != twin at C={C} B={B} grid={grid} "
                                f"amin={amin} max={max_size}")
                        if max_size == 0 and not bool(
                                torch.isinf(got[1]).all()):
                            raise AssertionError("K3 all-infeasible case "
                                                 "found a pair")
                        if C > 1 and not bool(torch.isinf(got[1][-1])):
                            raise AssertionError("K3 infeasible bucket")
                        cases += 1
    emit({"phase": "k3_parity", "cases": cases, "parity": "bit-identical",
          "max_abs_err": 0.0})

    # the loop's calls: the kernel's cached lockstep steps against the twin
    # steps on a copy of the state, over whole chunks and both phases
    runs = [_k3_sequence(C, B, data, rule, counts)
            for C, B, data, rule, counts in (
                (8, 128, "normal", "centroid", None),
                (8, 128, "grid", "lance_williams", None),
                (8, 128, "ties", "centroid", [128, 96, 37, 5, 0, 1, 64, 2]),
                (8, 128, "ties", "lance_williams", None),
                (3, 200, "grid", "centroid", [200, 150, 7]),
                (32, 512, "ties", "lance_williams", None),
                (K3_C, K3_B, "normal", "centroid", [K3_ITEMS] * K3_C))]
    emit({"phase": "k3_cached_parity", "runs": runs,
          "parity": "bit-identical: the whole state (D, births, sizes, "
                    "active, dvec, log, the pair and its sizes, proceed, "
                    "dmin/bhi/blo, the control words, the chunk's flags) "
                    "after every iteration"})

    # a 100,000-image job's one chunk: every slot active, updates pending
    C, B = K3_C, K3_B
    D, dvec, sa, do, births, sizes, active = _k3_state(gen, C, B, dev, False,
                                                       1.0)
    do = torch.ones_like(do)
    args = (dvec, sa, do, births, sizes, active, 6, -1)
    call = lambda: mk.merge_update_argmin_batched(D, *args)  # noqa: E731
    plain = lambda: mk.merge_update_argmin_batched_plain(D, *args)  # noqa
    call_ms = cuda_ms(call)
    plain_ms = cuda_ms(plain)
    dev_ms = device_ms(call, K3_KERNEL)
    plain_dev_ms = device_ms(plain)
    n_act = int(active.sum())
    # each active row of every D read once, one row + one column written per
    # bucket, dvec/births/sizes/active read once, sa/do and outputs
    bytes_moved = n_act * B * 4 + C * 2 * B * 4 + 4 * C * B * 4 + 5 * C * 4
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    cached = _k3_cached_times()
    emit({"phase": "k3_time", "card": card, "C": C, "B": B,
          "full_scan": {"device_ms": dev_ms, "call_ms": call_ms,
                        "plain_ms": plain_ms, "plain_device_ms": plain_dev_ms,
                        "bound_ms": bound_ms, "bytes": bytes_moved},
          "cached": cached, "bound_by": "bytes",
          "timing": f"*call_ms / plain_ms: CUDA events, median of "
                    f"{TIMING_REPS} warm calls; cached device_ms: CUDA events "
                    f"around each call queued behind a device spin, median "
                    f"of {TIMING_REPS}; other *device_ms: torch.profiler "
                    f"kernel time, mean of {TIMING_REPS}"})
    return 0.0, {"ms": cached["device_ms"], "call_ms": cached["call_ms"],
                 "plain_ms": cached["plain_device_ms"],
                 "bound_ms": cached["bound_ms"], "bound_by": "bytes",
                 "rescans_per_bucket_call": cached["rescans_per_bucket_call"],
                 "full_scan_ms": dev_ms or call_ms,
                 "full_scan_call_ms": call_ms,
                 "full_scan_plain_ms": plain_dev_ms or plain_ms,
                 "full_scan_bound_ms": bound_ms}


def _k3_loop_states(C, B, data, counts=None, d=16, seed=0):
    """Two copies of a lockstep chunk's initial state on the card:
    [(LockstepState, centroids)] * 2, and the chunk's counts."""
    import torch

    from imageclust_tpu_torch.cluster import sharded

    gen = torch.Generator().manual_seed(seed + C + B)
    x, bidx, ct, tg = _k2_inputs(gen, C, B, data, d=d, counts=counts)
    return [sharded._lockstep_state(x, bidx, ct, tg) for _ in range(2)], ct


def _lockstep_diff(a, b):
    """Count of differing bits-equal entries between two LockstepStates, as
    a device tensor (no host synchronisation)."""
    import torch

    from imageclust_tpu_torch.ops import merge_kernels as mk

    bad = torch.zeros((), dtype=torch.int64, device=a.D.device)
    for name in ("D", "births", "sizes", "active", "dvec", "log", "pair",
                 "pair_f", "proceed", "out_d", "out_pair"):
        ta, tb = getattr(a, name), getattr(b, name)
        if ta.dtype == torch.float32:
            ta, tb = ta.view(torch.int32), tb.view(torch.int32)
        bad += (ta != tb).sum()
    bad += (a.ctl[:, :mk.LCTL_TICKET + 1] != b.ctl[:, :mk.LCTL_TICKET + 1]).sum()
    bad += (a.flags[:mk.LFLAG_TICKET + 1]
            != b.flags[:mk.LFLAG_TICKET + 1]).sum()
    return bad


def _k3_sequence(C, B, data, rule, counts=None):
    """A whole chunk (both phases, and gated no-op iterations past each
    phase's end) with K3's lockstep steps and, on a copy of the state, the
    twin's steps, both eager: the whole state compared after every
    iteration; the rows a cached call rescans per bucket."""
    import torch

    from imageclust_tpu_torch.cluster import sharded
    from imageclust_tpu_torch.ops import merge_kernels as mk

    ((st_k, c_k), (st_p, c_p)), _ = _k3_loop_states(C, B, data, counts)
    bad = torch.zeros((), dtype=torch.int64, device=DEVICE)
    iterations = 0
    for amin in (-1, 3):
        st_k.begin_phase(amin)
        st_p.begin_phase(amin)
        idle = 0
        while idle < 3 and iterations < 4 * B:
            mk.lockstep_step(st_k, 6)
            mk.lockstep_step_plain(st_p, 6)
            bad += _lockstep_diff(st_k, st_p)
            sharded._lockstep_float(st_k, c_k, rule)
            sharded._lockstep_float(st_p, c_p, rule)
            iterations += 1
            idle = 0 if int(st_k.flags[mk.LFLAG_ANY_RAN]) else idle + 1
    torch.cuda.synchronize()
    merges = int(st_k.ctl[:, mk.LCTL_STEP].sum())
    if int(bad) or merges == 0:
        raise AssertionError(f"K3 cached steps != twin steps at C={C} B={B} "
                             f"{data} {rule}: {int(bad)} differing entries, "
                             f"{merges} merges")
    cached_calls = int(st_k.ctl[:, mk.LCTL_CACHED_CALLS].sum())
    return {"C": C, "B": B, "data": data, "rule": rule,
            "iterations": iterations, "merges": merges,
            "cached_bucket_calls": cached_calls,
            "rows_rescanned_per_bucket_call":
                int(st_k.ctl[:, mk.LCTL_RESCAN_TOTAL].sum())
                / max(cached_calls, 1),
            "rows_rescanned_max": int(st_k.ctl[:, mk.LCTL_RESCAN_MAX].max())}


def _k3_cached_times():
    """K3's cached lockstep call in a 100,000-image job's chunk (C = 261,
    B = 512, 384 items a bucket, normal d = 64 data, the centroid rule)
    after K3_WARM_ITERS iterations, eager steps: call ms (CUDA events
    around the wrapper), device ms (CUDA events around the call queued
    behind a device spin, so the host's launch falls outside the window),
    the profiler's kernel time beside it (it loses or under-reads these
    one-call sessions after earlier phases' profiler sessions), the twin
    step's times on a copy of the state in step with it, and the bound of
    what a cached call moves."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from imageclust_tpu_torch.cluster import sharded
    from imageclust_tpu_torch.ops import merge_kernels as mk

    ((st, cents), (sp, cp)), _ = _k3_loop_states(
        K3_C, K3_B, "normal", [K3_ITEMS] * K3_C, d=64)
    for state in (st, sp):
        state.begin_phase(-1)
    steps = ((st, cents, mk.lockstep_step), (sp, cp, mk.lockstep_step_plain))
    for _ in range(K3_WARM_ITERS):
        for state, c, step in steps:
            step(state, 6)
            sharded._lockstep_float(state, c, "centroid")
    torch.cuda.synchronize()

    def timed(state, c, step, queued=False):
        events = []
        for _ in range(TIMING_REPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            if queued:
                torch.cuda._sleep(SPIN_CYCLES)
            a.record()
            step(state, 6)
            b.record()
            sharded._lockstep_float(state, c, "centroid")
            events.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in events)

    def profiled(state, c, step, match):
        # the float work runs outside the window, unprofiled
        total_us = 0.0
        for _ in range(TIMING_REPS):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                step(state, 6)
                torch.cuda.synchronize()
            total_us += _kernel_us(prof, match)
            sharded._lockstep_float(state, c, "centroid")
        return total_us / TIMING_REPS / 1e3 if total_us else None

    ctl = st.ctl
    r0 = int(ctl[:, mk.LCTL_RESCAN_TOTAL].sum())
    n0 = int(ctl[:, mk.LCTL_CACHED_CALLS].sum())
    call_ms = timed(st, cents, mk.lockstep_step)
    rescans = ((int(ctl[:, mk.LCTL_RESCAN_TOTAL].sum()) - r0)
               / max(int(ctl[:, mk.LCTL_CACHED_CALLS].sum()) - n0, 1))
    running = int(st.proceed.sum())
    device = timed(st, cents, mk.lockstep_step, queued=True)
    profiler = profiled(st, cents, mk.lockstep_step, K3_KERNEL)
    plain_call_ms = timed(sp, cp, mk.lockstep_step_plain)
    plain_device = profiled(sp, cp, mk.lockstep_step_plain, ())
    B = K3_B
    # per running bucket: row and column sa written, the rescanned rows
    # read, the cache (16 bytes a row), births/sizes/active and dvec read
    # once; the control word and outputs are noise
    nbytes = running * (2 * B * 4 + rescans * B * 4 + 16 * B + 12 * B
                        + 4 * B)
    return {"device_ms": device, "profiler_device_ms": profiler,
            "call_ms": call_ms,
            "plain_device_ms": plain_device or plain_call_ms,
            "plain_call_ms": plain_call_ms,
            "rescans_per_bucket_call": rescans, "running_buckets": running,
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "iterations_before": K3_WARM_ITERS}


def _k2_inputs(gen, C, B, data, d=16, counts=None):
    """(features, bucket index, counts, targets) on the card; ``data`` is
    "normal", "grid" (integer grid) or "ties" (d = 2 integer grid: many
    exact ties)."""
    import numpy as np
    import torch

    from imageclust_tpu_torch.cluster import sharded

    if data == "normal":
        x = torch.randn((C * B, d), generator=gen)
    else:
        x = torch.randint(-3, 4, (C * B, 2 if data == "ties" else d),
                          generator=gen).float()
    if counts is None:
        counts = np.resize([int(0.75 * B), 37, 5, 0], C)
    counts = np.asarray(counts, np.int32)
    targets = np.array([sharded._bucket_target(int(c), 3, 6) if c else 0
                        for c in counts], np.int32)
    dev = torch.device(DEVICE)
    bidx = torch.arange(C * B, dtype=torch.int32).reshape(C, B).to(dev)
    return (x.to(dev), bidx, torch.from_numpy(counts).to(dev),
            torch.from_numpy(targets).to(dev))


def _k2_bound(C, B, counts, steps):
    """(bound ms, bound_by, bytes, ops) of K2 on these inputs: each bucket
    matrix read once, counts and targets read, log, step and state written
    once; one scan of each bucket's active pairs plus O(B) per merge."""
    bytes_moved = (C * B * B * 4 + 2 * C * 4 + C * (B - 1) * 3 * 4 + C * 4
                   + 3 * C * B * 4)
    ops = (sum(int(c) ** 2 for c in counts) * K2_OPS_PER_PAIR
           + int(sum(steps)) * B * K2_OPS_PER_MERGE_SLOT)
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms), "operations" if ops_ms > bytes_ms
            else "bytes", bytes_moved, ops)


def phase_k2(card: str):
    import torch

    from imageclust_tpu_torch.cluster import sharded
    from imageclust_tpu_torch.ops import bucket_kernels as bk

    gen = torch.Generator().manual_seed(7)
    shapes = [(C, B, None, ("normal", "grid", "ties"), (0, 3))
              for C in (3, 64, 256) for B in (128, 512)]
    # the widest bucket, full, under the engine's absorb (its twin runs
    # thousands of trips: two cases keep the phase short)
    shapes.append((2, 4096, [4096, 3072], ("normal", "ties"), (3,)))
    cases = 0
    for C, B, counts, datas, amins in shapes:
        for data in datas:
            x, bidx, ct, tg = _k2_inputs(gen, C, B, data, counts=counts)
            D = sharded.pairwise_ward_singleton(
                sharded._gather_buckets(x, bidx))
            for amin in amins:
                dk, dw = D.clone(), D.clone()
                got = bk.merge_loop_whole(dk, ct, tg, 6, amin)
                want = bk.merge_loop_whole_plain(dw, ct, tg, 6, amin)
                lock = sharded._bucket_chunk_fused(
                    x, bidx, ct, tg, 6, 3, "lance_williams",
                    absorb=amin > 0)
                torch.cuda.synchronize()
                if not (all(_same_bits(g, w) and _same_bits(g, k)
                            for g, w, k in zip(got, want, lock))
                        and _same_bits(dk, dw)):
                    raise AssertionError(
                        f"K2 / twin / K3 loop differ at C={C} B={B} "
                        f"data={data} absorb={amin}")
                if int(got[1].sum()) == 0:
                    raise AssertionError("K2 case merged nothing")
                cases += 1
            del D, dk, dw
    emit({"phase": "k2_parity", "cases": cases,
          "parity": "bit-identical (K2, twin, K3 lockstep loop; final D "
                    "K2 vs twin)", "max_abs_err": 0.0})

    C, B, per = 256, 512, 384
    x, bidx, ct, tg = _k2_inputs(gen, C, B, "normal", d=64,
                                 counts=[per] * C)
    D0 = sharded.pairwise_ward_singleton(sharded._gather_buckets(x, bidx))
    reps, warm = TIMING_REPS, 3
    # every call takes a fresh copy (K2 updates D in place), as cold in L2
    # as the engine's freshly built matrices
    pool = [D0.clone() for _ in range(3 * (reps + warm) + 2)]
    call = lambda: bk.merge_loop_whole(pool.pop(), ct, tg, 6, 3)  # noqa
    call_ms = cuda_ms(call, reps, warm)
    dev_ms = burst_ms(call, reps, warm)
    prof_ms = device_ms(call, ("merge_loop_whole_kernel",), reps)
    del pool
    plain_reps = 3
    plain_ms = cuda_ms(
        lambda: bk.merge_loop_whole_plain(D0.clone(), ct, tg, 6, 3),
        plain_reps, 1)
    log, step, *_ = bk.merge_loop_whole(D0.clone(), ct, tg, 6, 3)
    steps = step.cpu().numpy().astype(int)
    bound_ms, bound_by, bytes_moved, ops = _k2_bound(C, B, [per] * C, steps)
    # the full-scan design's pair visits: every merge scanned active^2 pairs
    full_scan_pairs = sum(sum((per - j) ** 2 for j in range(s))
                          for s in steps)
    emit({"phase": "k2_time", "card": card, "C": C, "B": B,
          "items_per_bucket": per, "merges": int(steps.sum()),
          "serial_trips": int(steps.max()),
          "device_ms": dev_ms, "profiler_device_ms": prof_ms,
          "call_ms": call_ms, "plain_ms": plain_ms,
          "bound_ms": bound_ms, "bound_by": bound_by,
          "bytes": bytes_moved, "ops": ops,
          "full_scan_pairs": full_scan_pairs,
          "timing": f"device_ms: CUDA events around {reps} back-to-back "
                    f"calls, per call; call_ms: CUDA events, median of {reps} "
                    f"warm calls; profiler_device_ms: torch.profiler kernel "
                    f"time, mean of {reps}; plain_ms: the twin, {plain_reps} "
                    f"calls; ops at {FP32_OPS_PER_S:.3g}/s"})
    return 0.0, {"ms": dev_ms, "call_ms": call_ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by}


@contextlib.contextmanager
def _k2_timed():
    """The bucketed engine with each K2 call timed by CUDA events; yields a
    dict whose "device_s" holds their sum once the block has ended."""
    import torch

    from imageclust_tpu_torch.cluster import sharded

    saved = sharded.merge_loop_whole
    pairs = []

    def timed(*args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = saved(*args, **kw)
        b.record()
        pairs.append((a, b))
        return out

    rec = {}
    sharded.merge_loop_whole = timed
    try:
        yield rec
    finally:
        sharded.merge_loop_whole = saved
    torch.cuda.synchronize()
    rec["device_s"] = sum(a.elapsed_time(b) for a, b in pairs) / 1e3
    rec["calls"] = len(pairs)


@contextlib.contextmanager
def _twins():
    """The bucketed engine with K2, K3 (the lockstep step) and K4 swapped
    for their plain twins on the card, to hold the kernel run against."""
    from imageclust_tpu_torch.cluster import sharded
    from imageclust_tpu_torch.ops import bucket_kernels as bk
    from imageclust_tpu_torch.ops import merge_kernels as mk
    from imageclust_tpu_torch.ops import pref_kernels as pk

    saved = (sharded.merge_loop_whole, sharded.lockstep_step,
             sharded.pref_topk_block)
    sharded.merge_loop_whole = bk.merge_loop_whole_plain
    sharded.lockstep_step = mk.lockstep_step_plain  # the loop then runs eager
    sharded.pref_topk_block = pk.pref_topk_block_plain
    try:
        yield
    finally:
        (sharded.merge_loop_whole, sharded.lockstep_step,
         sharded.pref_topk_block) = saved


def _check_columnar(what: str, res, n: int, lo: int = 3, hi: int = 6):
    import numpy as np

    sizes = np.diff(res._offsets)
    if len(sizes) and not (sizes.min() >= lo and sizes.max() <= hi):
        raise AssertionError(f"{what}: cluster sizes {sizes.min()}.."
                             f"{sizes.max()}")
    if int(sizes.sum()) + len(res._dropped_idx) != n:
        raise AssertionError(f"{what}: images lost")
    return sizes


@contextlib.contextmanager
def _lockstep_timed(profiled: bool = False):
    """The bucketed engine with each lockstep phase (``_lockstep_phase``)
    timed on the host clock, synchronised before and after, and its peak
    device memory above what it started with (the state, the eager first
    iteration's temporaries and the CUDA graph's pool), with the host
    seconds spent capturing and instantiating CUDA graphs (from entering
    ``torch.cuda.graph`` to leaving it); with ``profiled`` each phase also
    runs under torch.profiler: K3's device time and launches, and every
    other kernel's (the float work). Yields a dict filled as the phases
    run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from imageclust_tpu_torch.cluster import sharded

    saved = sharded._lockstep_phase
    saved_graph = torch.cuda.graph
    rec = {"loop_s": 0.0, "phases": 0, "peak_bytes": 0, "k3_device_s": 0.0,
           "other_device_s": 0.0, "k3_events": 0, "capture_s": 0.0,
           "captures": 0}

    class timed_graph(saved_graph):
        def __enter__(self):
            self._t0 = time.perf_counter()
            return super().__enter__()

        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            rec["capture_s"] += time.perf_counter() - self._t0
            rec["captures"] += 1
            return out

    def timed(*args, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        at = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with (profile(activities=[ProfilerActivity.CUDA]) if profiled
              else contextlib.nullcontext()) as prof:
            out = saved(*args, **kw)
            torch.cuda.synchronize()
        rec["loop_s"] += time.perf_counter() - t0
        rec["peak_bytes"] = max(rec["peak_bytes"],
                                torch.cuda.max_memory_allocated() - at)
        rec["phases"] += 1
        if profiled:
            k3_us = _kernel_us(prof, K3_KERNEL)
            rec["k3_device_s"] += k3_us / 1e6
            rec["other_device_s"] += (_kernel_us(prof) - k3_us) / 1e6
            rec["k3_events"] += sum(e.count for e in prof.key_averages()
                                    if any(m in e.key for m in K3_KERNEL))
        return out

    sharded._lockstep_phase = timed
    torch.cuda.graph = timed_graph
    try:
        yield rec
    finally:
        sharded._lockstep_phase = saved
        torch.cuda.graph = saved_graph


def _lockstep_split(timed: dict, prof: dict, launches: int) -> dict:
    """One lockstep iteration of the centroid run split into K3's device
    time, the float work's (every other kernel in the loop) and the rest of
    the loop's wall time (gaps: host work, launch and graph overheads)."""
    if not prof["k3_events"]:
        return {"note": "the profiler recorded no K3 event"}
    k3_ms = prof["k3_device_s"] * 1e3 / prof["k3_events"]
    float_ms = prof["other_device_s"] * 1e3 / prof["k3_events"]
    wall_ms = timed["loop_s"] * 1e3 / max(launches, 1)
    return {"iteration_ms": wall_ms, "k3_ms": k3_ms, "float_work_ms": float_ms,
            "gaps_ms": wall_ms - k3_ms - float_ms,
            "graph_capture_ms": timed["capture_s"] * 1e3 / max(launches, 1),
            "k3_events_profiled": prof["k3_events"],
            "device_busy_share": (prof["k3_device_s"] + prof["other_device_s"])
            / timed["loop_s"]}


def phase_engine_100k(card: str):
    import numpy as np
    import torch

    from imageclust_tpu_torch.cluster import constrained_ward_bucketed

    os.environ["IMAGECLUST_CLUSTER_PROFILE"] = "1"  # the phase timer
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    x = torch.randn((BIG_N, BIG_D), generator=gen, device=DEVICE)
    launches = {}
    for rule in ("lance_williams", "centroid"):
        kw = dict(min_size=3, max_size=6, update_rule=rule, device=DEVICE)
        _zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _k2_timed() as k2, _lockstep_timed() as loop:
            res = constrained_ward_bucketed(x, **kw)
        wall_s = time.perf_counter() - t0
        c = _counters()
        _check_scale_launches(f"engine {rule}", c, rule)
        launches["k2" if rule == "lance_williams" else "k3"] = c[
            "k2" if rule == "lance_williams" else "k3"]
        sizes = _check_columnar(f"engine {rule}", res, BIG_N)
        with _twins(), _lockstep_timed() as twin_loop:
            t0 = time.perf_counter()
            ref = constrained_ward_bucketed(x, **kw)
            twin_s = time.perf_counter() - t0
        if not (np.array_equal(res.merges, ref.merges)
                and np.array_equal(res._members, ref._members)
                and np.array_equal(res._offsets, ref._offsets)
                and list(res._dropped_idx) == list(ref._dropped_idx)):
            raise AssertionError(f"engine {rule}: kernel run != twin run")
        rec = {"phase": "bucketed_engine", "card": card, "n": BIG_N,
               "d": BIG_D, "update_rule": rule, "wall_s": wall_s,
               "phases_s": res.phases_s, "k2_device_s": k2["device_s"],
               "k2_calls": k2["calls"], "twin_wall_s": twin_s,
               "twin_phases_s": ref.phases_s, "host_paths": res.host_paths,
               "buckets": res.n_buckets,
               "clusters": int(len(sizes)), "dropped": len(res._dropped_idx),
               "merges": int(len(res.merges)),
               "merges_sha256": hashlib.sha256(
                   np.ascontiguousarray(res.merges).tobytes()).hexdigest(),
               "size_histogram": np.bincount(sizes).tolist(),
               "launches": c, "logs_identical_to_twin_run": True}
        if rule == "centroid":
            # a third run under the profiler, phase by phase: the split of
            # one iteration (the runs are deterministic, so it launches K3
            # as often as the first)
            with _lockstep_timed(profiled=True) as prof:
                constrained_ward_bucketed(x, **kw)
            rec["lockstep"] = {
                "loop_s": loop["loop_s"], "phases": loop["phases"],
                "peak_device_bytes": loop["peak_bytes"],
                "graph_capture_s": loop["capture_s"],
                "graph_captures": loop["captures"],
                "twin_loop_s": twin_loop["loop_s"],
                "iterations_with_a_bucket_running": c["lockstep_iterations"],
                "k3_launches": c["k3"],
                "split": _lockstep_split(loop, prof, c["k3"]),
                "timing": "loop_s: host clock around each lockstep phase, "
                          "synchronised; split: torch.profiler kernel time "
                          "of a third run, per K3 launch; gaps = loop_s per "
                          "launch - K3 - float work, graph_capture_ms the "
                          "share of the gaps spent capturing and "
                          "instantiating the graphs"}
        emit(rec)
    del os.environ["IMAGECLUST_CLUSTER_PROFILE"]
    return launches


def phase_cli_big(card: str, groups: int = BIG_CLI_GROUPS,
                  model: str = "resnet50", extra=()):
    """``cli run`` on ``groups`` x 5 BMPs (above ``exact_limit``) with the
    ``extra`` arguments; ``--set cluster.scale_engine=chain`` among them
    runs the chain engine (no K1-K4 launch). Returns the job's result and
    the image names."""
    import numpy as np

    from imageclust_tpu_torch import cli
    from imageclust_tpu_torch.models.registry import DEFAULT_BATCH
    from imageclust_tpu_torch.ops import attention as at

    engine = ("chain" if "cluster.scale_engine=chain" in extra
              else "bucketed")
    tag = model if engine == "bucketed" else f"{model}_{engine}"
    tmp = Path(tempfile.mkdtemp(prefix="imageclust_smoke_cli_big_"))
    try:
        rng = np.random.default_rng(9)
        names, blobs, _ = group_images(rng, groups, 5, "s")
        img_dir = tmp / "images"
        img_dir.mkdir()
        for name, blob in zip(names, blobs):
            (img_dir / name).write_bytes(blob)
        del blobs
        out = io.StringIO()
        _zero_counters()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["run", "--images", str(img_dir), "--device",
                           DEVICE, "--out", str(tmp / "work"),
                           "--model", model, *extra])
        wall_s = time.perf_counter() - t0
        c = _counters()
        if rc != 0:
            raise AssertionError(f"cli run exited {rc}")
        result = json.loads(out.getvalue())
        OUT.mkdir(parents=True, exist_ok=True)
        (OUT / f"cli_big_{tag}_result.json").write_text(out.getvalue())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _check_sizes(result["clusters"])
    if engine == "chain":
        if c["k1"] or c["k2"] or c["k3"] or c["k4"]:
            raise AssertionError(f"cli big chain: merge kernels ran {c}")
    else:
        _check_scale_launches("cli big", c, "lance_williams")
    n = len(names)
    # the stream embeds ceil(n / batch) chunks; K5 runs in each ViT-B/32
    # block of each chunk and never in ResNet50
    batches = -(-n // DEFAULT_BATCH[model])
    want_k5 = VIT_B32_DEPTH * batches if model == "vit_b32" else 0
    if c["k5"] != want_k5:
        raise AssertionError(f"cli big {model}: {c['k5']} K5 launches, "
                             f"want {want_k5}")
    placed = sum(len(cl["images"]) for cl in result["clusters"].values())
    if placed + len(result["dropped"]) != n:
        raise AssertionError("cli big: images lost")
    emit({"phase": "cli_run_big", "card": card, "model": model, "images": n,
          "engine": engine, "args": list(extra),
          "wall_s": wall_s, "stages_s": result["metrics"]["stages_s"],
          "embed_images_per_s": result["metrics"].get("images_per_sec_embed"),
          "clusters": len(result["clusters"]),
          "dropped": len(result["dropped"]), "launches": c,
          "output": os.path.relpath(OUT / f"cli_big_{tag}_result.json",
                                    REPO)})
    _JOBS[tag] = (result, names)
    return result, names


def phase_stream(card: str):
    import torch

    from imageclust_tpu_torch.config import AppConfig, LabelConfig
    from imageclust_tpu_torch.pipeline import Pipeline

    gen = torch.Generator(device=DEVICE).manual_seed(10)
    dev = torch.device(DEVICE)
    groups = STREAM_N // 4
    bases = torch.randint(0, 256, (groups, 3), generator=gen, device=dev)

    def chunks(batch):
        for s in range(0, STREAM_N, batch):
            e = min(s + batch, STREAM_N)
            g = torch.arange(s, e, device=dev) // 4
            noise = torch.randint(0, 21, (e - s, 224, 224, 3), generator=gen,
                                  device=dev, dtype=torch.int16)
            img = bases[g][:, None, None, :] - 10 + noise
            yield img.clamp(0, 255).to(torch.uint8)

    cfg = AppConfig(labels=LabelConfig(backend="none"))
    work = Path(tempfile.mkdtemp(prefix="imageclust_smoke_stream_"))
    try:
        pipeline = Pipeline(cfg, device=DEVICE)
        _zero_counters()
        t0 = time.perf_counter()
        res = pipeline.run_stream(chunks(pipeline.embedder.batch_size),
                                  STREAM_N, str(work))
        wall_s = time.perf_counter() - t0
        c = _counters()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    _check_scale_launches("run_stream", c, "lance_williams")
    sizes = [len(d.images) for d in res.clusters.values()]
    if not all(3 <= s <= 6 for s in sizes):
        raise AssertionError("run_stream: cluster sizes out of bounds")
    if sum(sizes) + len(res.dropped) != STREAM_N:
        raise AssertionError("run_stream: images lost")
    metrics = res.metrics.to_dict()
    batches = -(-STREAM_N // pipeline.embedder.batch_size)
    if c["k6"] != K6_LAUNCHES * batches:
        raise AssertionError(f"run_stream: {c['k6']} K6 launches for "
                             f"{batches} ResNet50 batches")
    emit({"phase": "run_stream", "card": card, "images": STREAM_N,
          "wall_s": wall_s, "stages_s": metrics["stages_s"],
          "embed_images_per_s": metrics.get("images_per_sec_embed"),
          "clusters": len(sizes), "dropped": len(res.dropped),
          "launches": c})
    return c["k6"]


# -- the ViT towers (phases 11-15) ---------------------------------------------

def phase_k5(card: str):
    import torch
    import torch.nn.functional as F

    from imageclust_tpu_torch.ops import attention as at

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    cases = []
    max_err = 0.0
    for shape in K5_SHAPES:
        for name, tol in K5_TOL.items():
            dt = getattr(torch, name)
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                       for _ in range(3))
            before = at.launches
            got = at.short_seq_attention(q, k, v)
            want = at.short_seq_attention_plain(q, k, v)
            torch.cuda.synchronize()
            if at.launches != before + 1:
                raise AssertionError("K5 call did not count one launch")
            err = float((got.float() - want.float()).abs().max())
            if got.shape != q.shape or got.dtype != dt or not torch.allclose(
                    got.float(), want.float(), rtol=tol, atol=tol):
                raise AssertionError(f"K5 != twin at {shape} {name}: "
                                     f"max abs err {err}")
            cases.append({"shape": shape, "dtype": name, "tol": tol,
                          "max_abs_err": err})
            max_err = max(max_err, err)
    long_q = torch.zeros((1, 129, 1, 64), device=dev)
    try:
        at.short_seq_attention(long_q, long_q, long_q)
        raise AssertionError("K5 took T = 129")
    except ValueError:
        pass
    emit({"phase": "k5_parity", "cases": cases, "parity": "tolerance",
          "max_abs_err": max_err})

    B, T, H, Dh = K5_SHAPES[0]
    q, k, v = (torch.randn((B, T, H, Dh), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    call = lambda: at.short_seq_attention(q, k, v)  # noqa: E731
    plain = lambda: at.short_seq_attention_plain(q, k, v)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh)  # noqa: E731
    call_ms = cuda_ms(call)
    k5_ms = burst_ms(call)
    dev_ms = device_ms(call, ("short_seq_attention",))
    plain_ms = burst_ms(plain)
    plain_dev_ms = device_ms(plain)
    lib_ms = burst_ms(sdpa)
    lib_dev_ms = device_ms(sdpa)
    bytes_moved = 4 * B * T * H * Dh * 2  # q, k, v read once, o written
    ops = 4 * B * H * T * T * Dh           # two products, 2 ops a MAC
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / BF16_OPS_PER_S * 1e3
    bound_by = "operations" if ops_ms > bytes_ms else "bytes"
    emit({"phase": "k5_time", "card": card, "shape": [B, T, H, Dh],
          "dtype": "bfloat16", "burst_ms": k5_ms, "device_ms": dev_ms,
          "call_ms": call_ms, "plain_burst_ms": plain_ms,
          "plain_device_ms": plain_dev_ms, "sdpa_burst_ms": lib_ms,
          "sdpa_device_ms": lib_dev_ms,
          "bound_ms": max(bytes_ms, ops_ms), "bound_by": bound_by,
          "bytes": bytes_moved, "bytes_ms": bytes_ms, "ops": ops,
          "ops_ms": ops_ms,
          "timing": f"*burst_ms: CUDA events around {TIMING_REPS} "
                    "back-to-back warm calls, per call; call_ms: CUDA events "
                    f"around one call, median of {TIMING_REPS}; *device_ms: "
                    f"torch.profiler kernel time, mean of {TIMING_REPS}; "
                    "sdpa: scaled_dot_product_attention on (B, H, T, Dh) "
                    "copies, a yardstick only"})
    return max_err, {"ms": k5_ms, "device_ms": dev_ms, "call_ms": call_ms,
                     "plain_ms": plain_ms,
                     "bound_ms": max(bytes_ms, ops_ms), "bound_by": bound_by,
                     "library_ms": lib_ms}


def _noise_images(n: int, size: int, seed: int):
    import numpy as np

    return np.random.default_rng(seed).integers(
        0, 256, (n, size, size, 3), dtype=np.uint8)


def _blob_check(emb, images, want) -> dict:
    """``Embedder.embed_blob`` on the card: the float32 (N, 3, S, S) blob
    preprocessed on the host in numpy (channel flip, scale, mean, std, as
    the embedder does at the input size) against ``want``, the same
    tower's ``Embedder.embed`` rows of the same uint8 images."""
    import numpy as np

    spec = emb.spec
    x = images.astype(np.float32)
    if spec.bgr_input:
        x = x[..., ::-1]
    x = (x * np.float32(spec.scale) - np.asarray(spec.mean, np.float32)) \
        / np.asarray(spec.std, np.float32)
    blob = np.ascontiguousarray(x.transpose(0, 3, 1, 2), np.float32)
    got = emb.embed_blob(blob)
    cos = _cosines(got, want)
    if got.shape != want.shape or got.dtype != np.float32 or not (
            np.isfinite(got).all() and cos.min() >= BLOB_COS_FLOOR):
        raise AssertionError(f"{spec.name} embed_blob: {got.shape} "
                             f"{got.dtype}, min cosine {cos.min()}")
    return {"images": len(blob), "cosine_min": float(cos.min()),
            "cosine_floor": BLOB_COS_FLOOR,
            "max_abs_diff": float(np.abs(got - want).max())}


def phase_vit_tower(card: str):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from imageclust_tpu_torch.config import EmbedConfig
    from imageclust_tpu_torch.models import create_embedder
    from imageclust_tpu_torch.models import vit
    from imageclust_tpu_torch.ops import attention as at

    t0 = time.perf_counter()
    emb = create_embedder(EmbedConfig(model="vit_b32"), device=DEVICE)
    build_s = time.perf_counter() - t0
    images = _noise_images(VIT_N, 224, 12)
    emb.embed(images[:emb.batch_size])  # warm: cuBLAS plans, allocator
    torch.cuda.synchronize()
    at.launches = 0
    t0 = time.perf_counter()
    got = emb.embed(images)
    wall_s = time.perf_counter() - t0
    launches = at.launches
    batches = -(-VIT_N // emb.batch_size)
    if launches != VIT_B32_DEPTH * batches:
        raise AssertionError(f"ViT-B/32: {launches} K5 launches for "
                             f"{batches} batches")
    saved = vit.attention
    vit.attention = at.short_seq_attention_plain
    try:
        t0 = time.perf_counter()
        want = emb.embed(images)
        twin_s = time.perf_counter() - t0
    finally:
        vit.attention = saved
    if got.shape != (VIT_N, 512) or not np.isfinite(got).all():
        raise AssertionError(f"ViT-B/32 output {got.shape}")
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                 * np.linalg.norm(want, axis=1))
    if not cos.min() >= VIT_COS_FLOOR:
        raise AssertionError(f"ViT-B/32 on K5 vs twin: min cosine "
                             f"{cos.min()} < {VIT_COS_FLOOR}")
    blob = _blob_check(emb, images[:BLOB_N], got[:BLOB_N])
    # one batch under the profiler: the tower's device time and K5's share
    x = torch.from_numpy(images[:emb.batch_size]).to(DEVICE)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        emb._forward(x)
        torch.cuda.synchronize()
    all_us = _kernel_us(prof)
    k5_us = _kernel_us(prof, ("short_seq_attention",))
    emit({"phase": "vit_b32_tower", "card": card, "images": VIT_N,
          "batch": emb.batch_size, "dtype": "bfloat16",
          "embedder_build_s": build_s, "wall_s": wall_s,
          "images_per_s": VIT_N / wall_s, "twin_wall_s": twin_s,
          "twin_images_per_s": VIT_N / twin_s, "k5_launches": launches,
          "cosine_min": float(cos.min()), "cosine_floor": VIT_COS_FLOOR,
          "batch_device_ms": all_us / 1e3, "batch_k5_device_ms": k5_us / 1e3,
          "embed_blob": blob,
          "timing": "wall: host clock around Embedder.embed (host copy in, "
                    "embeddings back to the host); batch_*: torch.profiler "
                    "kernel time of one batch's forward"})


def phase_other_towers(card: str):
    import numpy as np
    import torch

    from imageclust_tpu_torch.config import EmbedConfig
    from imageclust_tpu_torch.models import create_embedder
    from imageclust_tpu_torch.models.vit import VIT_CONFIGS
    from imageclust_tpu_torch.ops import attention as at

    towers = []
    for name in ("vit_b16", "vit_l14", "vit_l14_336", "siglip_so400m"):
        vcfg = VIT_CONFIGS[name]
        t0 = time.perf_counter()
        emb = create_embedder(EmbedConfig(model=name), device=DEVICE)
        build_s = time.perf_counter() - t0
        images = _noise_images(OTHER_TOWER_N, vcfg.image_size, 15)
        emb.embed(images[:emb.batch_size])  # warm
        torch.cuda.synchronize()
        at.launches = 0
        t0 = time.perf_counter()
        out = emb.embed(images)
        wall_s = time.perf_counter() - t0
        seq = (vcfg.image_size // vcfg.patch) ** 2 + vcfg.use_class_token
        if (out.shape != (OTHER_TOWER_N, vcfg.proj_dim)
                or not np.isfinite(out).all()):
            raise AssertionError(f"{name}: output {out.shape}")
        if at.launches:
            raise AssertionError(f"{name} (T = {seq}) launched K5")
        towers.append({"model": name, "seq": seq, "batch": emb.batch_size,
                       "embedder_build_s": build_s, "wall_s": wall_s,
                       "images_per_s": OTHER_TOWER_N / wall_s,
                       "k5_launches": at.launches})
        del emb
        torch.cuda.empty_cache()
    emit({"phase": "other_towers", "card": card, "images": OTHER_TOWER_N,
          "dtype": "bfloat16", "towers": towers})


# -- the large-k path: K4 and bf16/int8 residency (phases 16-18) --------------

def _k4_inputs(gen, n, k, d, dtype, grid):
    """(rows, cents) on the card: integer-grid values (every product and
    sum exact in f32: |v| <= 8 for f32/bf16, the whole int8 range) or
    normal ones."""
    import torch

    if grid:
        hi = 127 if dtype == torch.int8 else 8
        return tuple(torch.randint(-hi, hi + 1, (m, d), generator=gen,
                                   device=DEVICE, dtype=torch.int16).to(dtype)
                     for m in (n, k))
    return tuple(torch.randn((m, d), generator=gen, device=DEVICE).to(dtype)
                 for m in (n, k))


def _dist64(x, c, idx):
    """(m, kk) float64 squared distances of the rows of x to the centroids
    idx picks, from the stored values, in row chunks."""
    import torch

    out = []
    for s in range(0, x.shape[0], 8192):
        xs = x[s:s + 8192].double()
        cs = c[idx[s:s + 8192].long()].double()
        out.append(((xs[:, None, :] - cs) ** 2).sum(-1))
    return torch.cat(out)


def _k4_compare(x, c, kk: int, exact: bool):
    """K4 on all rows of x against its twin: bit-identical when ``exact``,
    else the picks may differ only at near ties (float64 distances of the
    two picks, on the rows where they differ, within K4_NEAR_TIE relative).
    Returns the case's record."""
    import torch

    from imageclust_tpu_torch.ops import pref_kernels as pk

    cn = pk.row_norms(c)
    before = pk.launches
    gi, gv = pk.pref_topk_block(x, c, cn, kk)
    torch.cuda.synchronize()
    if pk.launches != before + 1:
        raise AssertionError("K4 call did not count one launch")
    m = x.shape[0]
    wi, wv = pk.pref_topk_block_plain(x, c, cn, kk)
    k = c.shape[0]
    if not (gi.shape == (m, kk) and bool(((gi >= 0) & (gi < k)).all())
            and bool((torch.diff(gv, dim=1) >= 0).all())):
        raise AssertionError(f"K4 output malformed at {tuple(x.shape)}, k={k}")
    picks = (gi == wi).all(1)
    bits = picks & (gv.view(torch.int32) == wv.view(torch.int32)).all(1)
    share = float(bits.float().mean())
    err = float((gv - wv).abs().max())
    what = f"K4 at n={x.shape[0]} k={k} d={x.shape[1]} {x.dtype}"
    if exact and share != 1.0:
        raise AssertionError(f"{what}: {1 - share:.3g} of rows differ from "
                             "the twin on integer data")
    if not exact:
        rel = 0.0
        rows = torch.nonzero(~picks)[:, 0]
        if len(rows):
            dk = _dist64(x[rows], c, gi[rows])
            dw = _dist64(x[rows], c, wi[rows])
            rel = float(((dk - dw).abs() / dw.clamp_min(1.0)).max())
        if rel > K4_NEAR_TIE or not torch.allclose(gv, wv, rtol=K4_NEAR_TIE,
                                                   atol=K4_NEAR_TIE):
            raise AssertionError(f"{what}: picks differ beyond a near tie "
                                 f"(rel {rel:.3g}, max abs err {err:.3g})")
    return {"n": x.shape[0], "k": k, "d": x.shape[1],
            "dtype": str(x.dtype).split(".")[-1], "kk": kk,
            "data": "integer grid" if exact else "normal",
            "rows_compared": m, "identical_row_share": share,
            "same_picks_row_share": float(picks.float().mean()),
            "max_abs_err": err}


def _k4_bound(n, k, d, dtype, kk=8):
    """(bound ms, bound_by, bytes, ops): rows, cents and norms read once,
    the outputs written once; 2 n k d operations at the dtype's peak."""
    import torch

    es = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}[dtype]
    rate = {torch.float32: FP32_OPS_PER_S, torch.bfloat16: BF16_OPS_PER_S,
            torch.int8: INT8_OPS_PER_S}[dtype]
    bytes_moved = (n + k) * d * es + (n + k) * 4 + n * kk * 8
    ops = 2 * n * k * d
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / rate * 1e3
    return (max(bytes_ms, ops_ms), "operations" if ops_ms > bytes_ms
            else "bytes", bytes_moved, ops)


def phase_k4(card: str):
    import torch

    from imageclust_tpu_torch.ops import pref_kernels as pk

    gen = torch.Generator(device=DEVICE).manual_seed(16)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}
    cases = []
    for n, k, d, dup in K4_SMALL:
        for name, dt in dts.items():
            for grid in (True, False) if dt != torch.int8 else (True,):
                x, c = _k4_inputs(gen, n, k, d, dt, grid)
                if dup:  # the second half repeats the first: ties across tiles
                    c = torch.cat([c[:k // 2], c[:k // 2]])
                cases.append(_k4_compare(x, c, min(K4_KK, k), grid))
    for name, d in (("bfloat16", 512), ("float32", 512), ("int8", 1024)):
        for grid in (True, False) if name != "int8" else (True,):
            x, c = _k4_inputs(gen, K4_N, K4_K, d, dts[name], grid)
            cases.append(_k4_compare(x, c, K4_KK, grid))
            del x, c
    for name, d in K4_STREAM_D.items():
        for grid in (True, False) if name != "int8" else (True,):
            x, c = _k4_inputs(gen, K4_STREAM_N, K4_STREAM_K, d, dts[name],
                              grid)
            cases.append(_k4_compare(x, c, K4_KK, grid))
            del x, c
    max_err = max(cs["max_abs_err"] for cs in cases
                  if cs["data"] == "integer grid")
    emit({"phase": "k4_parity", "cases": cases,
          "parity": "bit-identical on integer grids; normal data: picks "
                    f"equal up to near ties ({K4_NEAR_TIE} relative in "
                    "float64)", "max_abs_err": max_err})

    times = {}
    shapes = [(name, K4_N, K4_K, d,
               "resident" if name != "float32" else "cp.async")
              for name, d in (("bfloat16", 512), ("int8", 1024),
                              ("float32", 512))]
    shapes += [(name, K4_STREAM_N, K4_STREAM_K, d,
                "streaming" if name != "float32" else "cp.async")
               for name, d in K4_STREAM_D.items()]
    for name, n, k, d, row_path in shapes:
        dt = dts[name]
        x, c = _k4_inputs(gen, n, k, d, dt, dt == torch.int8)
        cn = pk.row_norms(c)
        call = lambda: pk.pref_topk_block(x, c, cn, K4_KK)  # noqa: E731
        call_ms = cuda_ms(call, 3, 1)
        dev_ms = burst_ms(call, 3, 1)
        prof_ms = device_ms(call, K4_KERNELS, 3)
        bound_ms, bound_by, bytes_moved, ops = _k4_bound(n, k, d, dt)
        rec = {"dtype": name, "n": n, "k": k, "d": d, "row_path": row_path,
               "device_ms": dev_ms, "profiler_device_ms": prof_ms,
               "call_ms": call_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "bytes": bytes_moved, "ops": ops}
        if n == K4_N:
            rec["plain_ms"] = cuda_ms(
                lambda: pk.pref_topk_block_plain(x, c, cn, K4_KK), 1, 1)
        if n == K4_N and dt != torch.int8:  # int8 has no such PyTorch call
            ct = c.T.contiguous()

            def two_calls():  # context only: no one PyTorch call is K4
                for s in range(0, n, 1 << 18):
                    torch.topk(torch.matmul(x[s:s + (1 << 18)], ct), K4_KK,
                               dim=1)
            rec["matmul_topk_ms"] = cuda_ms(two_calls, 1, 1)
        times[(name, row_path if n == K4_N else "stream_shape")] = rec
        emit({"phase": "k4_time", "card": card, **rec,
              "timing": "call_ms: CUDA events around one call, median of 3 "
                        "warm calls; device_ms: CUDA events around 3 "
                        "back-to-back calls, per call; profiler_device_ms: "
                        "torch.profiler kernel time, mean of 3; plain_ms: "
                        "the twin, one warm call; "
                        "matmul_topk_ms: torch.matmul (bf16, or f32 with "
                        "TF32 off) + torch.topk(8) over 2^18-row chunks, one "
                        "warm call, context only (int8: no such call)"})
        del x, c, cn
        torch.cuda.empty_cache()
    t = times[("bfloat16", "resident")]
    f = times[("float32", "cp.async")]
    return max_err, {"ms": t["device_ms"], "call_ms": t["call_ms"],
                     "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "matmul_topk_ms": t["matmul_topk_ms"],
                     "int8_ms": times[("int8", "resident")]["device_ms"],
                     "float32_ms": f["device_ms"],
                     "float32_bound_ms": f["bound_ms"],
                     "float32_matmul_topk_ms": f["matmul_topk_ms"],
                     "streaming_ms": {name: times[(name, "stream_shape")][
                         "device_ms"] for name in K4_STREAM_D}}


def phase_engine_k4(card: str):
    import numpy as np
    import torch

    from imageclust_tpu_torch.cluster import constrained_ward_bucketed
    from imageclust_tpu_torch.cluster import sharded

    os.environ["IMAGECLUST_CLUSTER_PROFILE"] = "1"
    gen = torch.Generator(device=DEVICE).manual_seed(17)
    k4 = {}
    # bf16 at d = 512 is phase 18's engine run (the same job size and
    # residency), and phase 23 holds K4 against its twin on a bf16 job's
    # centroids: this phase runs the other two residencies
    for fd, d in (("int8", 1024), ("float32", 512)):
        x = torch.randn((ENGINE_K4_N, d), generator=gen, device=DEVICE)
        kw = dict(min_size=3, max_size=6, feature_dtype=fd, device=DEVICE)
        _zero_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _k2_timed() as k2:
            res = constrained_ward_bucketed(x, **kw)
        wall_s = time.perf_counter() - t0
        c = _counters()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        _check_scale_launches(f"engine 1.6M {fd}", c, "lance_williams", k4=1)
        k4[fd] = c["k4"]
        sizes = _check_columnar(f"engine 1.6M {fd}", res, ENGINE_K4_N)
        rec = {"phase": "bucketed_engine_k4", "card": card, "n": ENGINE_K4_N,
               "d": d, "feature_dtype": fd, "wall_s": wall_s,
               "phases_s": res.phases_s, "k2_device_s": k2["device_s"],
               "k2_calls": k2["calls"], "host_paths": res.host_paths,
               "buckets": res.n_buckets, "clusters": int(len(sizes)),
               "dropped": len(res._dropped_idx),
               "merges": int(len(res.merges)),
               "size_histogram": np.bincount(sizes).tolist(),
               "peak_device_gb": peak_gb, "launches": c}
        if fd == "int8":
            # on the int8 grid all of K4's arithmetic is exact: the run with
            # every kernel swapped for its twin must be the same run
            with _twins():
                t0 = time.perf_counter()
                ref = constrained_ward_bucketed(x, **kw)
                rec["twin_wall_s"] = time.perf_counter() - t0
            if not (np.array_equal(res.merges, ref.merges)
                    and np.array_equal(res._members, ref._members)
                    and np.array_equal(res._offsets, ref._offsets)
                    and list(res._dropped_idx) == list(ref._dropped_idx)):
                raise AssertionError("engine 1.6M int8: kernel run != twin "
                                     "run")
            rec["identical_to_twin_run"] = True
        else:
            # the summarize pass against its twin on the same centroids
            k = -(-ENGINE_K4_N // 384)
            cents = sharded.kmeans(x, k, summarize_fused=True)[0]
            a_k = sharded._kmeans_summarize_fused(x, cents, 8, True)[0]
            with _twins():
                a_t = sharded._kmeans_summarize_fused(x, cents, 8, True)[0]
            share = float((a_k == a_t).float().mean())
            rec["assign_match_share"] = share
            if share < ASSIGN_MATCH_FLOOR:
                raise AssertionError(f"engine 1.6M {fd}: K4's assignments "
                                     f"match the twin's on {share:.6f} of "
                                     f"items")
            del cents
        emit(rec)
        del x, res
        torch.cuda.empty_cache()
    del os.environ["IMAGECLUST_CLUSTER_PROFILE"]
    return k4


@contextlib.contextmanager
def _vit_b32_depth(depth: int):
    """``vit_b32`` built at full width with ``depth`` encoder blocks while
    the block runs (the registry reads ``VIT_CONFIGS`` at build time)."""
    import dataclasses

    from imageclust_tpu_torch.models.vit import VIT_CONFIGS

    full = VIT_CONFIGS["vit_b32"]
    VIT_CONFIGS["vit_b32"] = dataclasses.replace(full, depth=depth)
    try:
        yield
    finally:
        VIT_CONFIGS["vit_b32"] = full


def phase_stream_big(card: str):
    with _vit_b32_depth(STREAM_VIT_DEPTH):
        return _stream_big(card)


def _stream_big(card: str):
    import torch

    from imageclust_tpu_torch.config import (
        AppConfig,
        ClusterConfig,
        EmbedConfig,
        LabelConfig,
        NamingConfig,
    )
    from imageclust_tpu_torch.pipeline import Pipeline

    gen = torch.Generator(device=DEVICE).manual_seed(18)
    dev = torch.device(DEVICE)
    n = STREAM_BIG_N
    bases = torch.randint(0, 256, (n // 4 + 1, 3), generator=gen, device=dev)

    def chunks(batch):
        for s in range(0, n, batch):
            e = min(s + batch, n)
            g = torch.arange(s, e, device=dev) // 4
            noise = torch.randint(0, 21, (e - s, 224, 224, 3), generator=gen,
                                  device=dev, dtype=torch.int16)
            img = bases[g][:, None, None, :] - 10 + noise
            yield img.clamp(0, 255).to(torch.uint8)

    cfg = AppConfig(labels=LabelConfig(backend="none"),
                    embed=EmbedConfig(model="vit_b32"),
                    cluster=ClusterConfig(feature_dtype="bfloat16"),
                    naming=NamingConfig(max_clusters=STREAM_NAMING_BUDGET))
    work = Path(tempfile.mkdtemp(prefix="imageclust_smoke_stream_big_"))
    try:
        pipeline = Pipeline(cfg, device=DEVICE)
        _zero_counters()
        t0 = time.perf_counter()
        res = pipeline.run_stream(chunks(pipeline.embedder.batch_size), n,
                                  str(work))
        wall_s = time.perf_counter() - t0
        c = _counters()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    _check_scale_launches("run_stream 1.6M", c, "lance_williams", k4=1)
    batches = -(-n // pipeline.embedder.batch_size)
    if c["k5"] != STREAM_VIT_DEPTH * batches:
        raise AssertionError(f"run_stream 1.6M: {c['k5']} K5 launches for "
                             f"{batches} batches")
    sizes = [len(d.images) for d in res.clusters.values()]
    if not all(3 <= s <= 6 for s in sizes):
        raise AssertionError("run_stream 1.6M: cluster sizes out of bounds")
    if sum(sizes) + len(res.dropped) != n:
        raise AssertionError("run_stream 1.6M: images lost")
    metrics = res.metrics.to_dict()
    emit({"phase": "run_stream_big", "card": card, "images": n,
          "model": "vit_b32", "vit_depth": STREAM_VIT_DEPTH,
          "feature_dtype": "bfloat16",
          "wall_s": wall_s, "stages_s": metrics["stages_s"],
          "embed_images_per_s": metrics.get("images_per_sec_embed"),
          "clusters": len(sizes), "dropped": len(res.dropped),
          "naming_skipped": metrics["counters"].get("naming_skipped", 0),
          "launches": c})
    return c


# -- the towers users bring weights to (phases 19-20) -------------------------

def _sha256(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _cosines(a, b):
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


def phase_onnx(card: str):
    """ONNX at full width: the seeded ResNet50 (1000 classes) exported
    twice through the port's exporter (equal sha256), loaded back through
    ``embed.onnx_path`` (bit-identical weights), embedded beside the seeded
    tower, then served and run through ``cli run`` from the file."""
    from imageclust_tpu_torch.config import EmbedConfig
    from imageclust_tpu_torch.models import create_embedder

    seeded = create_embedder(EmbedConfig(onnx_path=""), device=DEVICE,
                             seed=ONNX_SEED)
    OUT.mkdir(parents=True, exist_ok=True)
    paths = [OUT / "resnet50_seeded.onnx", OUT / "resnet50_seeded_2.onnx"]
    try:
        _onnx_round_trip(card, seeded, paths)
    finally:  # 102 MB each: never brought back with the outputs
        for path in paths:
            path.unlink(missing_ok=True)


def _onnx_round_trip(card: str, seeded, paths):
    import numpy as np
    import torch

    from imageclust_tpu_torch.config import EmbedConfig
    from imageclust_tpu_torch.models import create_embedder
    from imageclust_tpu_torch.models.onnx_export import export_resnet50_onnx

    export_s = []
    for path in paths:
        t0 = time.perf_counter()
        export_resnet50_onnx(seeded.model, str(path))
        export_s.append(time.perf_counter() - t0)
    digests = [_sha256(path) for path in paths]
    if digests[0] != digests[1]:
        raise AssertionError(f"two exports differ: {digests}")
    t0 = time.perf_counter()
    loaded = create_embedder(EmbedConfig(onnx_path=str(paths[0])),
                             device=DEVICE)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    want = seeded.model.state_dict()
    got = loaded.model.state_dict()
    if got.keys() != want.keys() or not all(
            torch.equal(got[k], want[k]) for k in want):
        raise AssertionError("loaded weights differ from the seeded ones")
    if not loaded.weights_loaded or ":torch-randominit" in loaded.tag:
        raise AssertionError(f"ONNX not loaded: {loaded.tag}")
    images = _noise_images(ONNX_EMBED_N, 224, 19)
    a = seeded.embed(images)
    b = loaded.embed(images)
    cos = _cosines(a, b)
    if a.shape != (ONNX_EMBED_N, 1000) or not np.isfinite(b).all() or not (
            cos.min() >= ONNX_COS_FLOOR):
        raise AssertionError(f"ONNX tower vs seeded: {b.shape}, min cosine "
                             f"{cos.min()}")
    blob = _blob_check(seeded, images[:BLOB_N], a[:BLOB_N])
    emit({"phase": "onnx", "card": card, "file": os.path.relpath(paths[0],
                                                               REPO),
          "bytes": paths[0].stat().st_size, "sha256": digests[0],
          "exports_equal": True, "export_s": export_s, "load_s": load_s,
          "weights_bit_identical": True, "images": ONNX_EMBED_N,
          "max_abs_diff": float(np.abs(a - b).max()),
          "cosine_min": float(cos.min()), "embedder_tag": loaded.tag,
          "embed_blob": blob})
    del loaded
    torch.cuda.empty_cache()
    phase_server(card, "resnet50", {"onnx_path": str(paths[0])},
                 ("200_images",), "server_onnx")
    phase_cli(card, INT8_CLI_GROUPS,
              ("--set", f"embed.onnx_path={paths[0]}"), "cli_run_onnx")


def _batch_split(emb, images) -> dict:
    """One batch's forward under torch.profiler: device ms of the int8
    GEMMs (cuBLASLt), of the other matrix products and convolutions, of K5
    and of everything else (casts, quantize, dequantize, im2col copies,
    norms), with the five costliest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.from_numpy(images[:emb.batch_size]).to(DEVICE)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        emb._forward(x)
        torch.cuda.synchronize()
    kernels = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if us:
            kernels.append((evt.key, us / 1e3))
    groups = {"int8_gemm_ms": 0.0, "float_gemm_conv_ms": 0.0, "k5_ms": 0.0,
              "other_ms": 0.0}
    for key, ms in kernels:
        low = key.lower()
        if "short_seq_attention" in low:
            groups["k5_ms"] += ms
        elif any(m in low for m in ("i8", "imma", "int8", "s8")) and any(
                m in low for m in ("gemm", "cutlass", "sm90", "xmma")):
            groups["int8_gemm_ms"] += ms
        elif any(m in low for m in ("gemm", "cutlass", "conv", "sm90",
                                    "xmma", "cudnn", "fprop")):
            groups["float_gemm_conv_ms"] += ms
        else:
            groups["other_ms"] += ms
    top = sorted(kernels, key=lambda kv: -kv[1])[:5]
    return {"device_ms": sum(ms for _, ms in kernels), **groups,
            "top": [[k[:120], ms] for k, ms in top]}


def phase_int8_towers(card: str):
    """The int8 PTQ towers at full width (ResNet50, ViT-B/32): calibration
    seconds, images/s through ``Embedder.embed`` beside the bf16 tower's,
    per-row cosine of int8 against bf16; for ViT-B/32 the int8 tower on K5
    against the same tower on the twin's attention, then one int8
    ``POST /api/cluster``; a ResNet50 int8 ``cli run``. Returns the int8
    request's launches."""
    import numpy as np
    import torch

    from imageclust_tpu_torch.config import EmbedConfig
    from imageclust_tpu_torch.models import create_embedder
    from imageclust_tpu_torch.models import quantize_vit
    from imageclust_tpu_torch.models.registry import DEFAULT_BATCH, _quantize
    from imageclust_tpu_torch.ops import attention as at

    towers = []
    for model in ("resnet50", "vit_b32"):
        t0 = time.perf_counter()
        bf16 = create_embedder(EmbedConfig(model=model), device=DEVICE)
        bf16_build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        int8 = create_embedder(EmbedConfig(model=model, quantize="int8"),
                               device=DEVICE)
        torch.cuda.synchronize()
        int8_build_s = time.perf_counter() - t0
        # the calibration alone, on the bf16 tower's (the same seeded)
        # weights: one float32 forward of 8 images and the statistics
        t0 = time.perf_counter()
        _quantize(bf16.model, bf16.spec, EmbedConfig(model=model,
                                                     quantize="int8"), False)
        torch.cuda.synchronize()
        calib_s = time.perf_counter() - t0
        images = _noise_images(INT8_N, 224, 20)
        for emb in (bf16, int8):  # warm: cuBLAS plans, the allocator
            emb.embed(images[:emb.batch_size])
        torch.cuda.synchronize()
        walls = {"bfloat16": [], "int8": []}
        outs = {}
        at.launches = 0
        for label, emb in (("bfloat16", bf16), ("int8", int8),
                           ("int8", int8), ("bfloat16", bf16)):
            k5_before = at.launches
            t0 = time.perf_counter()
            outs[label] = emb.embed(images)
            walls[label].append(time.perf_counter() - t0)
            if label == "int8":
                k5_int8 = at.launches - k5_before
        batches = -(-INT8_N // int8.batch_size)
        want_k5 = VIT_B32_DEPTH * batches if model == "vit_b32" else 0
        if k5_int8 != want_k5:
            raise AssertionError(f"int8 {model}: {k5_int8} K5 launches, want "
                                 f"{want_k5}")
        got = outs["int8"]
        if got.shape != outs["bfloat16"].shape or not np.isfinite(got).all():
            raise AssertionError(f"int8 {model}: output {got.shape}")
        cos = _cosines(got, outs["bfloat16"])
        split = {label: _batch_split(emb, images)
                 for label, emb in (("bfloat16", bf16), ("int8", int8))}
        rec = {"model": model, "batch": int8.batch_size,
               "bf16_build_s": bf16_build_s, "int8_build_s": int8_build_s,
               "calibration_s": calib_s, "int8_wall_s": walls["int8"],
               "bf16_wall_s": walls["bfloat16"],
               "int8_images_per_s": [INT8_N / w for w in walls["int8"]],
               "bf16_images_per_s": [INT8_N / w for w in walls["bfloat16"]],
               "cosine_int8_vs_bf16_min": float(cos.min()),
               "cosine_int8_vs_bf16_median": float(np.median(cos)),
               "int8_k5_launches": k5_int8, "batch_device_split": split}
        if model == "vit_b32":
            saved = quantize_vit.attention
            quantize_vit.attention = at.short_seq_attention_plain
            try:
                twin = int8.embed(images)
            finally:
                quantize_vit.attention = saved
            tcos = _cosines(got, twin)
            if not tcos.min() >= VIT_COS_FLOOR:
                raise AssertionError(f"int8 ViT-B/32 on K5 vs twin: min "
                                     f"cosine {tcos.min()}")
            rec["cosine_k5_vs_twin_min"] = float(tcos.min())
        towers.append(rec)
        del bf16, int8, outs
        torch.cuda.empty_cache()
    emit({"phase": "int8_towers", "card": card, "images": INT8_N,
          "towers": towers,
          "timing": "wall: host clock around Embedder.embed (host copy in, "
                    "embeddings back to the host), turns bf16, int8, int8, "
                    "bf16; calibration_s: registry._quantize on the bf16 "
                    "tower's weights, synchronised"})
    launches = phase_server(card, "vit_b32", {"quantize": "int8"},
                            ("200_images",), "server_int8")
    # 200 images: batches of the smallest power of two that covers them
    bs = min(DEFAULT_BATCH["vit_b32"], 1 << (SERVER_GROUPS * 5 - 1).bit_length())
    if launches["k5"] != VIT_B32_DEPTH * -(-SERVER_GROUPS * 5 // bs):
        raise AssertionError(f"int8 server: {launches['k5']} K5 launches")
    phase_cli(card, INT8_CLI_GROUPS, ("--set", "embed.quantize=int8"),
              "cli_run_int8")
    return launches


# -- the text side (phases 21-23) ---------------------------------------------

def _clip_text_checkpoint():
    """A seeded HF-named state dict of CLIP ViT-B/32's text tower (vocab
    49,408, width 512, depth 12, heads 8, context 77, proj 512) written to
    ``$IMAGECLUST_SMOKE_OUT`` as ``.pt`` (254 MB, deleted at the script's
    end); returns its path."""
    import torch

    from imageclust_tpu_torch.models import text

    path = OUT / "clip_text_b32_seeded.pt"
    if not path.exists():
        cfg = text.TextConfig(eot_id=2)
        tower = text.TextTransformer(cfg).init_random(TEXT_SEED)
        state = tower.state_dict()
        sd = {}
        for ours, theirs in text._hf_pairs(cfg):
            val = state[ours]
            sd["text_model." + theirs] = val[0] if ours == "pos_embed" else val
        sd["text_projection.weight"] = state["projection.weight"]
        OUT.mkdir(parents=True, exist_ok=True)
        torch.save({k: v.contiguous() for k, v in sd.items()}, path)
    return path


def _label_dirs(root: Path, colours: dict, per_label: int, seed: int):
    """One directory of BMPs per label, each image ``base - 10 + noise in
    [0, 20]`` like the jobs' images."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for label, base in colours.items():
        (root / label).mkdir(parents=True)
        for i in range(per_label):
            noise = rng.integers(0, 21, (224, 224, 3), dtype=np.uint8)
            img = np.clip(np.asarray(base, np.int16) - 10 + noise, 0,
                          255).astype(np.uint8)
            (root / label / f"{i}.bmp").write_bytes(encode_bmp(img))


def _cli_bank(colours: dict, out: Path, seed: int) -> float:
    """``cli bank --model vit_b32`` over ``_label_dirs``; returns its
    seconds."""
    from imageclust_tpu_torch import cli

    tmp = Path(tempfile.mkdtemp(prefix="imageclust_smoke_bank_"))
    try:
        _label_dirs(tmp, colours, BANK_IMAGES_PER_LABEL, seed)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["bank", "--images", str(tmp), "--out", str(out),
                           "--model", "vit_b32", "--device", DEVICE])
        bank_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if rc != 0:
        raise AssertionError(f"cli bank exited {rc}")
    return bank_s


def phase_text_tower(card: str):
    """The CLIP text tower at full width from a seeded HF checkpoint through
    ``TextEncoder.from_checkpoint`` (the hashing tokenizer: no merges file
    in the repository): the card against the CPU, names/s through
    ``encode``, one batch's device ms, and a zero-shot bank over the
    builtin vocabulary with ``vit_b32``."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from imageclust_tpu_torch.config import EmbedConfig
    from imageclust_tpu_torch.labels.fake import _VOCAB
    from imageclust_tpu_torch.labels.zero_shot import ZeroShotLabeler
    from imageclust_tpu_torch.models import create_embedder, text
    from imageclust_tpu_torch.ops import attention as at

    path = _clip_text_checkpoint()
    t0 = time.perf_counter()
    enc = text.TextEncoder.from_checkpoint(str(path), device=DEVICE)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    want_cfg = text.TextConfig(vocab=49408, width=512, depth=12, heads=8,
                               proj_dim=512, context=77, eot_id=2)
    if enc.cfg != want_cfg or enc.tokenizer is not None:
        raise AssertionError(f"text tower config {enc.cfg}")
    rng = np.random.default_rng(21)
    words = [w.lower() for w in _VOCAB] + ["red", "green", "blue", "shoe",
                                           "hat", "photo", "of", "a"]
    names = [" ".join(rng.choice(words, rng.integers(1, 6)))
             + f" {i}" for i in range(TEXT_N)]
    cpu = text.TextEncoder(enc.cfg, state_dict={
        k: v.cpu() for k, v in enc.model.state_dict().items()},
        bpe_path="", device="cpu")
    got = enc.encode(names[:TEXT_CPU_N])
    want = cpu.encode(names[:TEXT_CPU_N])
    cos = _cosines(got, want)
    if got.shape != (TEXT_CPU_N, 512) or not cos.min() >= TEXT_COS_FLOOR:
        raise AssertionError(f"text tower card vs CPU: min cosine "
                             f"{cos.min()}")
    max_err = float(np.abs(got - want).max())
    del cpu
    enc.encode(names[:enc._ENCODE_BATCH])  # warm: cuBLAS plans
    torch.cuda.synchronize()
    at.launches = 0
    t0 = time.perf_counter()
    out = enc.encode(names)
    wall_s = time.perf_counter() - t0
    if at.launches:
        raise AssertionError("the text tower launched K5")
    if out.shape != (TEXT_N, 512) or not np.isfinite(out).all():
        raise AssertionError(f"text tower output {out.shape}")
    toks = torch.from_numpy(np.stack(
        [enc.tokenize(n) for n in names[:enc._ENCODE_BATCH]])).to(DEVICE)
    with torch.inference_mode():
        enc.model(toks)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            enc.model(toks)
            torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb = create_embedder(EmbedConfig(model="vit_b32"), device=DEVICE)
    zs = ZeroShotLabeler.from_texts(list(_VOCAB), emb, text_encoder=enc)
    bank_s = time.perf_counter() - t0
    norms = np.linalg.norm(zs.bank, axis=1)
    if (zs.bank.shape != (len(_VOCAB), 512) or not np.isfinite(zs.bank).all()
            or not np.allclose(norms, 1.0, atol=1e-5)):
        raise AssertionError(f"zero-shot bank {zs.bank.shape}")
    emit({"phase": "text_tower", "card": card,
          "config": {k: getattr(enc.cfg, k) for k in
                     ("vocab", "width", "depth", "heads", "proj_dim",
                      "context", "eot_id")},
          "tokenizer": "hash_tokenize (no merges file in the repository)",
          "checkpoint_load_s": load_s,
          "card_vs_cpu": {"names": TEXT_CPU_N,
                          "cosine_min": float(cos.min()),
                          "cosine_floor": TEXT_COS_FLOOR,
                          "max_abs_diff": max_err},
          "names": TEXT_N, "batch": enc._ENCODE_BATCH, "wall_s": wall_s,
          "names_per_s": TEXT_N / wall_s,
          "batch_device_ms": _kernel_us(prof) / 1e3, "k5_launches": 0,
          "zero_shot_bank": {"labels": len(_VOCAB), "dim": 512,
                             "build_s": bank_s},
          "timing": "wall: host clock around TextEncoder.encode (hashing, "
                    "transfers, embeddings back to the host); "
                    "batch_device_ms: torch.profiler kernel time of one "
                    "256-row forward"})
    del enc, emb, zs
    torch.cuda.empty_cache()


def phase_server_zero_shot(card: str):
    """``cli bank --model vit_b32`` on three colour directories drawn like
    phase 4's groups, then the server with ``embed.model=vit_b32``,
    ``labels.backend=zero_shot`` (that bank), ``labels.fusion=text`` and
    the phase-21 checkpoint: one 18-image ``POST /api/cluster``."""
    from imageclust_tpu_torch.ops import attention as at

    colours = {"blue": (220, 30, 30), "green": (30, 220, 30),
               "red": (30, 30, 220)}  # BGR: group_images' three bases
    bank = OUT / "bank_server.npz"
    OUT.mkdir(parents=True, exist_ok=True)
    bank_s = _cli_bank(colours, bank, seed=22)
    saved = os.environ.get("IMAGECLUST_LABEL_BANK")
    os.environ["IMAGECLUST_LABEL_BANK"] = str(bank)
    try:
        res = phase_server(
            card, "vit_b32", which=("18_images",), name="server_zero_shot",
            labels_kw={"backend": "zero_shot", "fusion": "text",
                       "text_checkpoint_path": str(_clip_text_checkpoint())})
    finally:
        if saved is None:
            del os.environ["IMAGECLUST_LABEL_BANK"]
        else:
            os.environ["IMAGECLUST_LABEL_BANK"] = saved
    req = res["requests"][0]
    if not (req["unique_labels"] or 0) >= 2:
        raise AssertionError(f"zero-shot request: {req['unique_labels']} "
                             "unique labels")
    if res["k5"] != VIT_B32_DEPTH:  # 18 images: one batch
        raise AssertionError(f"zero-shot request: {res['k5']} K5 launches")
    emit({"phase": "server_zero_shot_bank", "card": card,
          "bank": {"labels": sorted(colours), "images_per_label":
                   BANK_IMAGES_PER_LABEL, "cli_bank_s": bank_s,
                   "built_from": "cli bank --model vit_b32 over one BMP "
                                 "directory per colour of phase 4's groups "
                                 "(base - 10 + noise in [0, 20])"},
          "unique_labels": req["unique_labels"], "k1_launches": res["k1"],
          "k5_launches": res["k5"], "merges": req["merges"]})
    return res


def phase_stream_joint(card: str):
    """``Pipeline.run_stream`` on 1,600,000 images made on the card (as in
    phase 18: ``vit_b32``, bf16 residency) with ``labels.backend=zero_shot``
    (a ``cli bank`` over four of the job's own colour bases) and
    ``labels.fusion=text`` (the phase-21 tower): BASELINE config 5's joint
    visual+text features, 512 + 512 bf16 columns into the engine. Then K4
    on this job's centroids against its twin: the share of equal picks
    beside ``ASSIGN_MATCH_FLOOR``, and every differing pick a near tie.
    The tower (the bank's too) has ``STREAM_VIT_DEPTH`` blocks."""
    with _vit_b32_depth(STREAM_VIT_DEPTH):
        return _stream_joint(card)


def _stream_joint(card: str):
    import torch

    from imageclust_tpu_torch.cluster import sharded
    from imageclust_tpu_torch.config import (
        AppConfig,
        ClusterConfig,
        EmbedConfig,
        LabelConfig,
        NamingConfig,
    )
    from imageclust_tpu_torch.pipeline import Pipeline

    gen = torch.Generator(device=DEVICE).manual_seed(23)
    dev = torch.device(DEVICE)
    n = STREAM_BIG_N
    bases = torch.randint(0, 256, (n // 4 + 1, 3), generator=gen, device=dev)
    picks = [0, n // 16, n // 8, n // 5]  # groups whose base names a label
    colours = {f"base{g}": tuple(int(v) for v in bases[g].tolist())
               for g in picks}
    bank = OUT / "bank_stream.npz"
    OUT.mkdir(parents=True, exist_ok=True)
    bank_s = _cli_bank(colours, bank, seed=23)

    def chunks(batch):
        for s in range(0, n, batch):
            e = min(s + batch, n)
            g = torch.arange(s, e, device=dev) // 4
            noise = torch.randint(0, 21, (e - s, 224, 224, 3), generator=gen,
                                  device=dev, dtype=torch.int16)
            img = bases[g][:, None, None, :] - 10 + noise
            yield img.clamp(0, 255).to(torch.uint8)

    cfg = AppConfig(
        labels=LabelConfig(backend="zero_shot", fusion="text",
                           text_checkpoint_path=str(_clip_text_checkpoint())),
        embed=EmbedConfig(model="vit_b32"),
        cluster=ClusterConfig(feature_dtype="bfloat16"),
        naming=NamingConfig(max_clusters=STREAM_NAMING_BUDGET))
    work = Path(tempfile.mkdtemp(prefix="imageclust_smoke_stream_joint_"))
    saved = os.environ.get("IMAGECLUST_LABEL_BANK")
    os.environ["IMAGECLUST_LABEL_BANK"] = str(bank)
    try:
        pipeline = Pipeline(cfg, device=DEVICE)
        seen = {}
        cluster_big = pipeline._cluster_big

        def spy(features, *args, **kw):  # the features the engine gets
            seen["features"] = features
            return cluster_big(features, *args, **kw)

        pipeline._cluster_big = spy
        _zero_counters()
        t0 = time.perf_counter()
        res = pipeline.run_stream(chunks(pipeline.embedder.batch_size), n,
                                  str(work))
        wall_s = time.perf_counter() - t0
        c = _counters()
    finally:
        shutil.rmtree(work, ignore_errors=True)
        if saved is None:
            del os.environ["IMAGECLUST_LABEL_BANK"]
        else:
            os.environ["IMAGECLUST_LABEL_BANK"] = saved
    feats = seen["features"]
    if tuple(feats.shape) != (n, 1024) or feats.dtype != torch.bfloat16:
        raise AssertionError(f"run_stream joint: the engine got "
                             f"{tuple(feats.shape)} {feats.dtype}")
    _check_scale_launches("run_stream joint", c, "lance_williams", k4=1)
    batches = -(-n // pipeline.embedder.batch_size)
    if c["k5"] != STREAM_VIT_DEPTH * batches:
        raise AssertionError(f"run_stream joint: {c['k5']} K5 launches for "
                             f"{batches} batches")
    metrics = res.metrics.to_dict()
    unique = metrics["counters"].get("unique_labels", 0)
    if unique < 2 or not {"label", "fuse"} <= set(metrics["stages_s"]):
        raise AssertionError(f"run_stream joint: {unique} unique labels, "
                             f"stages {sorted(metrics['stages_s'])}")
    sizes = [len(d.images) for d in res.clusters.values()]
    if not all(3 <= s <= 6 for s in sizes):
        raise AssertionError("run_stream joint: cluster sizes out of bounds")
    if sum(sizes) + len(res.dropped) != n:
        raise AssertionError("run_stream joint: images lost")
    labelled = sum(1 for d in res.clusters.values() if d.labels)
    del res
    # K4 on this job's centroids against its twin (phase 17's check), the
    # first engine run of K4 at bf16 d = 1024
    k = -(-n // 384)
    cents = sharded.kmeans(feats, k, summarize_fused=True)[0]
    a_k = sharded._kmeans_summarize_fused(feats, cents, 8, True)[0]
    with _twins():
        a_t = sharded._kmeans_summarize_fused(feats, cents, 8, True)[0]
    share = float((a_k == a_t).float().mean())
    # The features of this job are near duplicates (four images a colour
    # base): an item's distance to its centroid is about 1e-3 of the
    # squared norms that the float32 score (xx + cn) - 2 g cancels, so the
    # kernel's and the twin's sums of g, which add in different orders, can
    # pick different centroids at a near tie. Every differing pick must be
    # a near tie on that scale: the float64 distances to the two picks
    # within K4_NEAR_TIE of xx + cn (phase 16's rule, whose random normal
    # rows have distances of the norms' size).
    c16 = sharded._fused_cast_cents(feats.dtype, cents)[0]
    rows = torch.nonzero(a_k != a_t)[:, 0]
    tie = {"differing_items": int(len(rows)), "max_gap_over_norms": 0.0,
           "max_abs_gap": 0.0, "kernel_pick_closer": 0,
           "twin_pick_closer": 0}
    if len(rows):
        dk = _dist64(feats[rows], c16, a_k[rows, None].long())[:, 0]
        dt = _dist64(feats[rows], c16, a_t[rows, None].long())[:, 0]
        xx = (feats[rows].double() ** 2).sum(1)
        cn = torch.maximum((c16[a_k[rows].long()].double() ** 2).sum(1),
                           (c16[a_t[rows].long()].double() ** 2).sum(1))
        tie.update({
            "max_gap_over_norms": float(((dk - dt).abs() / (xx + cn)).max()),
            "max_abs_gap": float((dk - dt).abs().max()),
            "median_distance": float(dt.median()),
            "median_squared_norm": float(xx.median()),
            "kernel_pick_closer": int((dk < dt).sum()),
            "twin_pick_closer": int((dt < dk).sum())})
    if tie["max_gap_over_norms"] > K4_NEAR_TIE:
        raise AssertionError(f"run_stream joint: K4's picks differ from the "
                             f"twin's beyond a near tie ({tie})")
    del feats, cents, a_k, a_t, seen
    torch.cuda.empty_cache()
    emit({"phase": "run_stream_joint", "card": card, "images": n,
          "model": "vit_b32", "vit_depth": STREAM_VIT_DEPTH,
          "feature_dtype": "bfloat16",
          "labels": {"backend": "zero_shot", "fusion": "text",
                     "min_confidence": cfg.labels.min_confidence},
          "bank": {"labels": colours, "images_per_label":
                   BANK_IMAGES_PER_LABEL, "cli_bank_s": bank_s,
                   "built_from": "cli bank --model vit_b32 over one BMP "
                                 "directory for each of four of the job's "
                                 "own colour bases (groups "
                                 f"{picks}), drawn like the job's images"},
          "engine_features": [n, 1024], "wall_s": wall_s,
          "stages_s": metrics["stages_s"],
          "embed_images_per_s": metrics.get("images_per_sec_embed"),
          "unique_labels": unique, "labelled_clusters": labelled,
          "clusters": len(sizes), "dropped": metrics["counters"]["dropped"],
          "naming_skipped": metrics["counters"].get("naming_skipped", 0),
          "k4_assign_match_share": share,
          "assign_match_floor": ASSIGN_MATCH_FLOOR, "k4_near_ties": tie,
          "near_tie": K4_NEAR_TIE, "launches": c})
    return c

# -- the chain engine and the scoreboards (phases 24-26) -----------------------

@contextlib.contextmanager
def _chain_impl(impl: str):
    saved = os.environ.get("IMAGECLUST_CHAIN_IMPL")
    os.environ["IMAGECLUST_CHAIN_IMPL"] = impl
    try:
        yield
    finally:
        if saved is None:
            del os.environ["IMAGECLUST_CHAIN_IMPL"]
        else:
            os.environ["IMAGECLUST_CHAIN_IMPL"] = saved


@contextlib.contextmanager
def _chain_timed():
    """The chain engine with its loops and each reciprocal-NN round timed
    on the host clock, synchronised before and after, and the loop's peak
    device memory above what it started with. Yields a dict filled as the
    loops run."""
    import torch

    from imageclust_tpu_torch.cluster import chain

    saved = {name: getattr(chain, name) for name in (
        "_rnn_loop", "_chain_loop", "_recompute_round", "_merge_round")}
    rec = {"loop_s": 0.0, "peak_bytes": 0, "recompute_s": 0.0,
           "merge_s": 0.0}

    def timed(name, key, fn):
        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            rec[key] += time.perf_counter() - t0
            return out
        setattr(chain, name, wrapper)

    def loop(fn):
        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            at = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            rec["loop_s"] += time.perf_counter() - t0
            rec["peak_bytes"] = max(rec["peak_bytes"],
                                    torch.cuda.max_memory_allocated() - at)
            return out
        return wrapper

    chain._rnn_loop = loop(saved["_rnn_loop"])
    chain._chain_loop = loop(saved["_chain_loop"])
    timed("_recompute_round", "recompute_s", saved["_recompute_round"])
    timed("_merge_round", "merge_s", saved["_merge_round"])
    try:
        yield rec
    finally:
        for name, fn in saved.items():
            setattr(chain, name, fn)


@contextlib.contextmanager
def _f32_gram():
    """The chain engine with its Gram tiles as plain f32 products on the
    card (cuBLAS, TF32 off) in place of float64 sums."""
    import torch

    from imageclust_tpu_torch.cluster import chain

    saved = chain._gram
    chain._gram = lambda a, b: torch.matmul(a, b.T)
    try:
        yield
    finally:
        chain._gram = saved


def _first_divergence(x, log_a, log_b, max_size: int):
    """Where two merge logs of one job first differ: the row, both merges,
    for each cluster they involve its two nearest feasible partners in
    float64 (after the rows both logs share) with their relative gap, and
    the two merges' own Ward distances in float64 with theirs (the gap a
    greedy engine's global minimum turns on)."""
    import numpy as np

    m = min(len(log_a), len(log_b))
    rows = np.nonzero((log_a[:m] != log_b[:m]).any(axis=1))[0]
    if not len(rows):
        return None
    k = int(rows[0])
    x64 = np.asarray(x, np.float64)
    members = {i: [i] for i in range(len(x64))}
    for hi, lo, new in log_b[:k]:
        members[int(new)] = members.pop(int(hi)) + members.pop(int(lo))
    births = np.array(sorted(members))
    sizes = np.array([len(members[b]) for b in births], np.float64)
    cents = np.stack([x64[members[b]].mean(axis=0) for b in births])
    out = []
    for a in sorted({int(v) for v in (*log_a[k][:2], *log_b[k][:2])}
                    & set(members)):
        i = int(np.searchsorted(births, a))
        w = (sizes[i] * sizes / (sizes[i] + sizes)
             * ((cents - cents[i]) ** 2).sum(axis=1))
        w[(births == a) | (sizes[i] + sizes > max_size)] = np.inf
        j = np.argsort(w, kind="stable")[:2]
        out.append({"cluster": a, "size": int(sizes[i]),
                    "nearest": [[float(w[t]), int(births[t])] for t in j],
                    "relative_gap": float((w[j[1]] - w[j[0]]) / w[j[0]])})
    pair = []
    for hi, lo, _ in (log_a[k], log_b[k]):
        i, j = (int(np.searchsorted(births, int(c))) for c in (hi, lo))
        pair.append(float(sizes[i] * sizes[j] / (sizes[i] + sizes[j])
                          * ((cents[i] - cents[j]) ** 2).sum()))
    return {"row": k, "of": m, "merge_a": log_a[k].tolist(),
            "merge_b": log_b[k].tolist(), "clusters": out,
            "merge_distances": pair,
            "merge_gap": abs(pair[0] - pair[1]) / max(min(pair), 1e-300)}


def _recompute_split(x, n: int) -> dict:
    """One full recompute round (the first ``_R_CAP`` rows against every
    column) of the rounds' first state on ``x``: CUDA events around the
    call, and torch.profiler's device time split into the Gram products
    (kernels named ``*gemm*``) and everything else (casts, elementwise
    passes, the row minima)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from imageclust_tpu_torch.cluster import chain

    st = chain._rnn_state(x, n)
    unb = st.active & ~st.blocked
    r_idx = torch.arange(chain._R_CAP, device=x.device)
    chain._nn_rows(st, unb, r_idx, 6)  # warm-up

    def call():
        chain._nn_rows(st, unb, r_idx, 6)

    ms = cuda_ms(call, reps=5, warm=1)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    all_us = _kernel_us(prof)
    gemm_us = all_us - sum(
        getattr(e, "self_device_time_total",
                getattr(e, "self_cuda_time_total", 0.0))
        for e in prof.key_averages() if "gemm" not in e.key.lower())
    d_pad = st.cents.shape[1]
    flops = 2.0 * chain._R_CAP * st.n_pad * d_pad
    return {"rows": chain._R_CAP, "columns": st.n_pad, "d_pad": d_pad,
            "ms": ms, "gram_device_ms": gemm_us / 1e3,
            "other_device_ms": (all_us - gemm_us) / 1e3,
            "gram_share": gemm_us / all_us if all_us else None,
            "gram_bound_ms": flops / FP32_OPS_PER_S * 1e3,
            "timing": "ms: CUDA events, median of 5; device split: "
                      "torch.profiler over one call; gram_bound_ms: the "
                      "product's operations at the FP32 peak"}


def _member_sets(res) -> set:
    return {frozenset(m) for m in res._index_map.values()}


def phase_chain(card: str):
    """Phase 24: the chain engine on the card against the exact engine, the
    sequential chain against the rounds (and the rounds on the CPU), then
    the rounds at n = 100,000, d = 1000 beside the bucketed engine."""
    import numpy as np
    import torch

    from imageclust_tpu_torch.cluster import (
        chain,
        constrained_ward,
        constrained_ward_bucketed,
        constrained_ward_chain,
    )
    from imageclust_tpu_torch.cluster.agreement import agreement

    # chain against greedy (K1, centroid rule) on the spot check's features
    x = np.random.default_rng(0).standard_normal(
        (CHAIN_GREEDY_N, CHAIN_GREEDY_D)).astype(np.float32)
    _zero_counters()
    t0 = time.perf_counter()
    greedy = constrained_ward(x, min_size=3, max_size=6,
                              update_rule="centroid", device=DEVICE)
    greedy_s = time.perf_counter() - t0
    c_greedy = _counters()
    _check_launches("chain vs greedy", c_greedy["k1"], len(greedy.merges))
    _zero_counters()
    with _chain_timed() as rec:
        t0 = time.perf_counter()
        got = constrained_ward_chain(x, min_size=3, max_size=6,
                                     reassign_dropped=False, device=DEVICE)
        chain_s = time.perf_counter() - t0
    c_chain = _counters()
    if any(c_chain[k] for k in ("k1", "k2", "k3", "k4", "k5")):
        raise AssertionError(f"chain: a kernel ran {c_chain}")
    same = (_member_sets(got) == _member_sets(greedy)
            and set(got.dropped) == set(greedy.dropped))
    if not same:
        raise AssertionError("chain vs greedy at 4096 x 512: partitions "
                             "differ")
    # the same job with the Gram as a plain f32 product on the card (not
    # gated): its partition against the exact engine's, and where its log
    # leaves the float64-summed one
    xt = torch.from_numpy(x).to(DEVICE)
    log64, _, m64, _ = chain._rnn_loop(xt, CHAIN_GREEDY_N, 6)
    with _f32_gram():
        got32 = constrained_ward_chain(x, min_size=3, max_size=6,
                                       reassign_dropped=False, device=DEVICE)
        log32, _, m32, _ = chain._rnn_loop(xt, CHAIN_GREEDY_N, 6)
    g32 = xt[:1024] @ xt.T
    g64 = xt[:1024].double() @ xt.double().T
    err = (g32.double() - g64).abs()
    at = int(torch.argmax(err))
    vs_greedy = {"n": CHAIN_GREEDY_N, "d": CHAIN_GREEDY_D,
                 "greedy_s": greedy_s, "chain_s": chain_s,
                 "chain_loop_s": rec["loop_s"], "k1_launches": c_greedy["k1"],
                 "merges_applied": len(got.merges),
                 "clusters": got.n_clusters, "dropped": len(got.dropped),
                 "loop_stats": got.loop_stats, "identical_partition": same,
                 "f32_gram": {
                     "identical_partition": (
                         _member_sets(got32) == _member_sets(greedy)
                         and set(got32.dropped) == set(greedy.dropped)),
                     "ari_vs_greedy": agreement(got32.assignments(),
                                                greedy.assignments())["ari"],
                     "clusters": got32.n_clusters,
                     "dropped": len(got32.dropped),
                     "gram_max_abs_err_vs_float64": float(err.max()),
                     "gram_abs_at_max_err": float(g64.flatten()[at].abs()),
                     "first_divergence_from_float64_sums": _first_divergence(
                         x, log32[:m32].cpu().numpy(),
                         log64[:m64].cpu().numpy(), 6)}}
    del xt, g32, g64, err

    # the sequential chain (CUDA graph replays) against the rounds on the
    # card, and the rounds on the card against the CPU on the first
    # CHAIN_CPU_N rows
    x = np.random.default_rng(24).standard_normal(
        (CHAIN_SEQ_N, CHAIN_SEQ_D)).astype(np.float32)
    runs = {}
    for impl, dev, n in (("rnn", DEVICE, CHAIN_SEQ_N),
                         ("seq", DEVICE, CHAIN_SEQ_N),
                         ("rnn", DEVICE, CHAIN_CPU_N),
                         ("rnn", "cpu", CHAIN_CPU_N)):
        with _chain_impl(impl), _chain_timed() as rec:
            t0 = time.perf_counter()
            res = constrained_ward_chain(x[:n], min_size=3, max_size=6,
                                         reassign_dropped=False, device=dev)
            wall = time.perf_counter() - t0
        runs[(impl, dev, n)] = (res, wall, dict(rec))
    for key, (res, _, _) in runs.items():
        ref = runs[("rnn", DEVICE, key[2])][0]
        if not (_member_sets(res) == _member_sets(ref)
                and set(res.dropped) == set(ref.dropped)):
            raise AssertionError(f"chain {key[0]} on {key[1]} at {key[2]} "
                                 f"x {CHAIN_SEQ_D}: partition != rnn on "
                                 "the card")
    runs = {f"{impl}_{dev}" + ("" if n == CHAIN_SEQ_N else f"_{n}"): v
            for (impl, dev, n), v in runs.items()}
    ref = runs[f"rnn_{DEVICE}"][0]
    seq, seq_wall, seq_rec = runs[f"seq_{DEVICE}"]
    seq_vs_rnn = {
        "n": CHAIN_SEQ_N, "d": CHAIN_SEQ_D, "cpu_n": CHAIN_CPU_N,
        "identical_partitions": True,
        "wall_s": {k: v[1] for k, v in runs.items()},
        "loop_s": {k: v[2]["loop_s"] for k, v in runs.items()},
        "rnn_card_stats": ref.loop_stats,
        "seq_iterations": seq.loop_stats["iterations"],
        "seq_steps_per_s": seq.loop_stats["iterations"] / seq_rec["loop_s"],
        "seq_merges": int(len(seq.merges)),
        "cpu_threads": torch.get_num_threads()}

    # the rounds at full size on phase 8's features, beside the bucketed
    # engine (Lance-Williams, K2) on the same features
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    x = torch.randn((BIG_N, BIG_D), generator=gen, device=DEVICE)
    x_ref = x.clone()
    _zero_counters()
    with _chain_timed() as rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = constrained_ward_chain(x, min_size=3, max_size=6,
                                     device=DEVICE)
        wall_s = time.perf_counter() - t0
    c_big = _counters()
    if not torch.equal(x, x_ref):
        raise AssertionError("chain 100k: the caller's features changed")
    del x_ref
    sizes = _check_columnar("chain 100k", res, BIG_N)
    split = _recompute_split(x, BIG_N)
    with _f32_gram():
        split["f32_gram"] = _recompute_split(x, BIG_N)
    _zero_counters()
    t0 = time.perf_counter()
    bucketed = constrained_ward_bucketed(x, min_size=3, max_size=6,
                                         device=DEVICE)
    bucketed_s = time.perf_counter() - t0
    c_bucketed = _counters()
    _check_scale_launches("chain phase bucketed", c_bucketed,
                          "lance_williams")
    agree = agreement(bucketed.assignments(), res.assignments())
    stats = res.loop_stats
    emit({"phase": "chain_engine", "card": card,
          "chain_vs_greedy": vs_greedy, "seq_vs_rnn": seq_vs_rnn,
          "rounds_100k": {
              "n": BIG_N, "d": BIG_D, "wall_s": wall_s,
              "loop_s": rec["loop_s"],
              "recompute_rounds": stats["recompute_rounds"],
              "recompute_s": rec["recompute_s"],
              "merge_rounds": stats["merge_rounds"],
              "merge_s": rec["merge_s"],
              "rows_recomputed": stats["rows_recomputed"],
              "peak_device_bytes": rec["peak_bytes"],
              "clusters": int(len(sizes)), "dropped": len(res._dropped_idx),
              "merges_applied": int(len(res.merges)),
              "size_histogram": np.bincount(sizes).tolist(),
              "launches": c_big, "features_unchanged": True,
              "recompute_round_split": split},
          "bucketed_100k": {"wall_s": bucketed_s,
                            "clusters": bucketed.n_clusters,
                            "launches": c_bucketed},
          "agreement_bucketed_vs_chain": agree,
          "timing": "host clock, synchronised around each loop and each "
                    "round; peak: max_memory_allocated above the start of "
                    "the loop"})
    return c_big


def _cli_partition_vector(result: dict, names: list):
    from imageclust_tpu_torch.cluster.agreement import partition_vector

    return partition_vector(
        {k: v["images"] for k, v in result["clusters"].items()}, names)


def phase_chain_pipeline(card: str):
    """Phase 25: ``cli run --model vit_b32 --set
    cluster.scale_engine=chain`` on phase 14's 4500 BMPs (agreement with
    phase 14's bucketed partition), then ``Pipeline.run_stream`` on
    100,000 images made on the card with ``vit_b32`` and the chain
    engine."""
    import torch

    from imageclust_tpu_torch.cluster.agreement import agreement
    from imageclust_tpu_torch.config import (
        AppConfig,
        ClusterConfig,
        EmbedConfig,
        LabelConfig,
        NamingConfig,
    )
    from imageclust_tpu_torch.pipeline import Pipeline

    if "vit_b32" not in _JOBS:  # a development run without phase 14
        phase_cli_big(card, VIT_CLI_GROUPS, "vit_b32")
    base, names = _JOBS["vit_b32"]
    chain_res, chain_names = phase_cli_big(
        card, VIT_CLI_GROUPS, "vit_b32",
        extra=("--set", "cluster.scale_engine=chain"))
    if chain_names != names:
        raise AssertionError("phase 25: not phase 14's images")
    agree = agreement(_cli_partition_vector(base, names),
                      _cli_partition_vector(chain_res, names))
    emit({"phase": "chain_cli_agreement", "card": card,
          "images": len(names),
          "agreement_bucketed_vs_chain": agree})

    gen = torch.Generator(device=DEVICE).manual_seed(25)
    dev = torch.device(DEVICE)
    n = CHAIN_STREAM_N
    bases = torch.randint(0, 256, (n // 4 + 1, 3), generator=gen, device=dev)

    def chunks(batch):
        for s in range(0, n, batch):
            e = min(s + batch, n)
            g = torch.arange(s, e, device=dev) // 4
            noise = torch.randint(0, 21, (e - s, 224, 224, 3), generator=gen,
                                  device=dev, dtype=torch.int16)
            img = bases[g][:, None, None, :] - 10 + noise
            yield img.clamp(0, 255).to(torch.uint8)

    cfg = AppConfig(labels=LabelConfig(backend="none"),
                    embed=EmbedConfig(model="vit_b32"),
                    cluster=ClusterConfig(scale_engine="chain"),
                    naming=NamingConfig(max_clusters=STREAM_NAMING_BUDGET))
    work = Path(tempfile.mkdtemp(prefix="imageclust_smoke_stream_chain_"))
    try:
        pipeline = Pipeline(cfg, device=DEVICE)
        _zero_counters()
        with _chain_timed() as rec:
            t0 = time.perf_counter()
            res = pipeline.run_stream(chunks(pipeline.embedder.batch_size),
                                      n, str(work))
            wall_s = time.perf_counter() - t0
        c = _counters()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    batches = -(-n // pipeline.embedder.batch_size)
    if c["k5"] != VIT_B32_DEPTH * batches or any(
            c[k] for k in ("k1", "k2", "k3", "k4")):
        raise AssertionError(f"run_stream chain: launches {c} for "
                             f"{batches} batches")
    sizes = [len(d.images) for d in res.clusters.values()]
    if not all(3 <= s <= 6 for s in sizes):
        raise AssertionError("run_stream chain: cluster sizes out of bounds")
    if sum(sizes) + len(res.dropped) != n:
        raise AssertionError("run_stream chain: images lost")
    metrics = res.metrics.to_dict()
    emit({"phase": "run_stream_chain", "card": card, "images": n,
          "model": "vit_b32", "engine": "chain", "wall_s": wall_s,
          "stages_s": metrics["stages_s"],
          "embed_images_per_s": metrics.get("images_per_sec_embed"),
          "chain_loop_s": rec["loop_s"],
          "chain_peak_device_bytes": rec["peak_bytes"],
          "clusters": len(sizes), "dropped": len(res.dropped),
          "naming_skipped": metrics["counters"].get("naming_skipped", 0),
          "launches": c})
    return c


def _floors(res: dict) -> dict:
    """tests/test_agreement.py's residency floors, each mode's row: the
    floors it misses."""
    yard = res["f32_seed_yardstick"]["ari"]
    f32 = res["f32"]["ari_vs_truth"]
    missed = {}
    for mode in ("bfloat16", "int8"):
        row = res[mode]
        bad = [k for k in ("ari", "same_pair_f1", "nmi")
               if row[k] < QUALITY_FLOORS[k]]
        if row["ari"] <= yard:
            bad.append("seed_yardstick")
        if row["ari_vs_truth"] < f32 - QUALITY_FLOORS["truth_ari_below_f32"]:
            bad.append("ari_vs_truth")
        missed[mode] = bad
    return missed


def phase_scoreboards(card: str):
    """Phase 26: the residency, text-fusion and PTQ scoreboards on the
    card, every row on its own line; the residency rows held to
    tests/test_agreement.py's floors (at 100,000 x 256 the yardstick, NMI
    and truth floors; see ``SCORE_RESIDENCY``)."""
    from imageclust_tpu_torch.cluster import quality
    from imageclust_tpu_torch.models.registry import DEFAULT_BATCH

    launches = {}

    def run(name, fn, *args, **kw):
        _zero_counters()
        t0 = time.perf_counter()
        out = fn(*args, device=DEVICE, **kw)
        secs = time.perf_counter() - t0
        c = _counters()
        if not (c["k2"] == c["chunks"] > 0 and c["k3"] == c["k4"] == 0):
            raise AssertionError(f"scoreboard {name}: launches {c}")
        launches[name] = c
        return out, secs, c

    for (n, d), held in ((SCORE_RESIDENCY_FLOORS, None),
                         (SCORE_RESIDENCY, {"seed_yardstick", "nmi",
                                            "ari_vs_truth"})):
        res, secs, c = run(f"residency_{n}", quality.residency_scoreboard,
                           n, d, sep=1.0)
        for mode, row in res.items():
            emit({"phase": "scoreboard_residency", "card": card, "n": n,
                  "d": d, "sep": 1.0, "row": mode, **row})
        missed = _floors(res)
        for mode, bad in missed.items():
            gated = bad if held is None else [k for k in bad if k in held]
            if gated:
                raise AssertionError(f"residency {mode} at {n} x {d}: below "
                                     f"the floors {gated}: {res[mode]}")
        emit({"phase": "scoreboard_residency_floors", "card": card, "n": n,
              "d": d, "seconds": secs, "floors": QUALITY_FLOORS,
              "held": "all" if held is None else sorted(held),
              "missed": missed, "launches": c})

    n, d = SCORE_FUSION
    row, secs, c = run("fusion", quality.fusion_scoreboard, n, d, sep=1.0)
    emit({"phase": "scoreboard_fusion", "card": card, "n": n, "d": d,
          "seconds": secs, **row, "launches": c})

    for model in ("resnet50", "vit_b32"):
        row, secs, c = run(f"ptq_{model}", quality.ptq_scoreboard, model,
                           SCORE_PTQ_N)
        if model == "vit_b32":
            # two towers embed the images; calibration adds forwards
            want = 2 * VIT_B32_DEPTH * -(-SCORE_PTQ_N // DEFAULT_BATCH[model])
            if c["k5"] < want:
                raise AssertionError(f"ptq vit_b32: {c['k5']} K5 launches, "
                                     f"want >= {want}")
        elif c["k5"]:
            raise AssertionError(f"ptq resnet50: {c['k5']} K5 launches")
        emit({"phase": "scoreboard_ptq", "card": card, "model": model,
              "n": SCORE_PTQ_N, "seconds": secs, **row, "launches": c})
    return launches


# -- fine-tuning and checkpoints (phase 27) ------------------------------------

def _finetune_dir(root: Path) -> Path:
    """``FT_CLASSES`` labelled folders of ``FT_PER_CLASS`` seeded colour-
    block BMPs at 224 x 224: a class colour, a block of a second colour at
    a random place, and noise."""
    import numpy as np

    rng = np.random.default_rng(27)
    bases = rng.integers(0, 256, (FT_CLASSES, 3))
    data = root / "labeled"
    for c in range(FT_CLASSES):
        d = data / f"class{c}"
        d.mkdir(parents=True)
        for i in range(FT_PER_CLASS):
            img = np.clip(bases[c] + rng.integers(-20, 21, (224, 224, 3)),
                          0, 255).astype(np.uint8)
            y, x = rng.integers(0, 160, 2)
            img[y:y + 64, x:x + 64] = rng.integers(0, 256, 3)
            (d / f"{i}.bmp").write_bytes(encode_bmp(img))
    return data


class _EpochLog:
    """Collects the fine-tune's per-epoch records and resume messages."""

    def __init__(self):
        import logging

        self.logger = logging.getLogger("imageclust_tpu_torch.models.finetune")
        self.records = []
        self.handler = logging.Handler(logging.INFO)
        self.handler.emit = self.records.append

    def __enter__(self):
        import logging

        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)

    def epochs(self) -> list:
        return [r.epoch_stats for r in self.records
                if hasattr(r, "epoch_stats")]

    def text(self) -> str:
        return "\n".join(r.getMessage() for r in self.records)


def _conv_kernel(name: str) -> bool:
    n = name.lower()
    return any(k in n for k in ("conv", "xmma", "cudnn", "implicit",
                                "dgrad", "wgrad", "fprop", "gemm"))


def _train_step_profile(model, images, labels) -> dict:
    """One profiled train step (AdamW on a copy of the state): device ms
    in convolutions (cuDNN, and the one dense GEMM) against the rest
    (BatchNorm statistics and normalisation, ReLU, pooling, the loss and
    the AdamW passes), and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from imageclust_tpu_torch.models.train import (
        init_opt_state,
        make_train_step,
    )

    opt = init_opt_state(model)
    step = make_train_step(model, learning_rate=FT_LR)
    for _ in range(2):
        step(model, opt, images, labels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(model, opt, images, labels)
        torch.cuda.synchronize()
    per = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if us:
            per[evt.key] = per.get(evt.key, 0.0) + us
    if not per:
        return {"profiler": "no device time recorded"}
    conv = sum(us for k, us in per.items() if _conv_kernel(k)) / 1e3
    total = sum(per.values()) / 1e3
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    return {"device_ms": total, "conv_ms": conv,
            "elementwise_bn_ms": total - conv,
            "top_kernels": [{"name": k[:120], "ms": us / 1e3,
                             "conv": _conv_kernel(k)} for k, us in top]}


def _step_on(device: str, dtype: str, weights, images, labels):
    """One train step of a fresh ``dtype`` tower from ``weights`` (the
    Flax tree) on ``device``: (loss, gradient leaves, batch_stats)."""
    import torch

    from imageclust_tpu_torch.models.convert import (
        flax_params_from_named,
        resnet50_flax_from_state_dict,
        resnet50_state_dict_from_flax,
    )
    from imageclust_tpu_torch.models.resnet50 import ResNet50V1
    from imageclust_tpu_torch.models.train import (
        init_opt_state,
        make_train_step,
    )

    model = ResNet50V1(num_classes=weights["params"]["dense0"]["bias"].size,
                       dtype=dtype)
    model.load_state_dict(resnet50_state_dict_from_flax(weights))
    model.to(device)
    step = make_train_step(model, learning_rate=FT_LR)
    loss = step(model, init_opt_state(model), images.to(device),
                labels.to(device))
    grads = flax_params_from_named(
        {k: p.grad for k, p in model.named_parameters()})
    stats = resnet50_flax_from_state_dict(model)["batch_stats"]
    return float(loss), dict(_tree_leaves(grads)), dict(_tree_leaves(stats))


def _tree_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_leaves(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), tree


def _card_against_cpu(weights, images, labels) -> dict:
    """The train step at batch ``FT_CHECK_BATCH`` on the card and on the
    CPU from the same weights (the tuned tower) and batch: float32 (TF32 off) held to the
    loss at rtol 1e-4, each gradient leaf at a relative L2 of 1e-3 and the
    batch_stats at rtol 1e-4 of each leaf's largest magnitude; bfloat16
    to the loss at rtol 1e-2 and each gradient leaf to a cosine >= 0.99."""
    import numpy as np
    import torch

    out = {}
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        cl, cg, cs = _step_on(DEVICE, dtype, weights, images, labels)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        hl, hg, hs = _step_on("cpu", dtype, weights, images, labels)
        cpu_s = time.perf_counter() - t0
        cg = {k: v.astype(np.float64).ravel() for k, v in cg.items()}
        hg = {k: v.astype(np.float64).ravel() for k, v in hg.items()}
        rel = {k: float(np.linalg.norm(cg[k] - hg[k])
                        / max(np.linalg.norm(hg[k]), 1e-30)) for k in hg}
        cos = {k: float(cg[k] @ hg[k] / max(
            np.linalg.norm(cg[k]) * np.linalg.norm(hg[k]), 1e-30))
            for k in hg}
        if dtype == "float32":  # the CPU against itself on one thread
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                _, og, _ = _step_on("cpu", dtype, weights, images, labels)
            finally:
                torch.set_num_threads(threads)
            cpu_self = max(float(np.linalg.norm(
                og[k].astype(np.float64).ravel() - hg[k]) / max(
                    np.linalg.norm(hg[k]), 1e-30)) for k in hg)
        stats = max(float(np.abs(cs[k] - hs[k]).max()
                          / max(np.abs(hs[k]).max(), 1e-30)) for k in hs)
        row = {"loss_card": cl, "loss_cpu": hl,
               "loss_rel": abs(cl - hl) / abs(hl),
               "grad_rel_l2_max": max(rel.values()),
               "grad_rel_l2_worst_leaves": sorted(
                   rel.items(), key=lambda kv: -kv[1])[:3],
               "grad_cosine_min": min(cos.values()),
               "grad_cosine_worst_leaves": sorted(
                   cos.items(), key=lambda kv: kv[1])[:3],
               "batch_stats_rel_max": stats, "card_s": card_s,
               "cpu_s": cpu_s}
        if dtype == "float32":
            row["cpu_1_thread_rel_l2_max"] = cpu_self
        out[dtype] = row
        if dtype == "float32":
            ok = (row["loss_rel"] <= 1e-4 and row["grad_rel_l2_max"] <= 1e-3
                  and stats <= 1e-4)
        else:
            ok = row["loss_rel"] <= 1e-2 and row["grad_cosine_min"] >= 0.99
        if not ok:
            raise AssertionError(f"train step card vs CPU ({dtype}): {row}")
    return out


def _fixture_on_card() -> dict:
    """The committed Orbax fixture (written by the JAX package: OCDBT,
    zstd frames with compressed blocks) read here, bit for bit against
    tests/data/expected.npz."""
    import numpy as np
    import torch

    from imageclust_tpu_torch.utils import orbax_io

    got = dict(_tree_leaves(orbax_io.restore_variables(
        str(REPO / "tests" / "data" / "orbax_small"))))
    with np.load(REPO / "tests" / "data" / "expected.npz") as z:
        want = dict(z)
    for name, arr in want.items():
        key = name.removesuffix(".bf16bits").replace(".", "/")
        leaf = got[key]
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.view(torch.uint16).numpy()
        if leaf.dtype != arr.dtype or not np.array_equal(leaf, arr):
            raise AssertionError(f"fixture leaf {key} differs")
    return {"leaves": len(want), "libzstd": orbax_io.libzstd_path() or None}


def phase_finetune(card: str):
    """Fine-tuning at full width on the card: the labelled BMPs, the
    warm start from a seeded ONNX export, two epochs and a resume, the
    train step against the CPU's, the tuned checkpoint served, ``cli
    train``, and the committed Orbax fixture."""
    tmp = Path(tempfile.mkdtemp(prefix="imageclust_smoke_ft_"))
    try:
        return _finetune(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _finetune(card: str, tmp: Path):
    import copy

    import numpy as np
    import torch

    from imageclust_tpu_torch.config import EmbedConfig
    from imageclust_tpu_torch.models import create_embedder
    from imageclust_tpu_torch.models.convert import (
        resnet50_flax_from_state_dict,
    )
    from imageclust_tpu_torch.models.finetune import (
        finetune_resnet50,
        load_labeled_dir,
    )
    from imageclust_tpu_torch.models.onnx_export import export_resnet50_onnx
    from imageclust_tpu_torch.models.resnet50 import ResNet50V1
    from imageclust_tpu_torch.ops import merge_kernels as mk
    from imageclust_tpu_torch.ops.preprocess import preprocess_batch

    fixture = _fixture_on_card()
    data = _finetune_dir(tmp)
    onnx = tmp / "init.onnx"
    export_resnet50_onnx(ResNet50V1().init_random(ONNX_SEED), str(onnx))
    out = str(tmp / "tuned" / "embedder")
    kw = dict(batch_size=FT_BATCH, learning_rate=FT_LR, init_onnx=str(onnx),
              device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    with _EpochLog() as log:
        t0 = time.perf_counter()
        model, classes, loss = finetune_resnet50(
            str(data), out, epochs=FT_EPOCHS, **kw)
        train_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    epochs = log.epochs()
    if (len(epochs) != FT_EPOCHS or not epochs[-1]["loss"]
            < epochs[0]["loss"] or not np.isfinite(loss)):
        raise AssertionError(f"fine-tune: epochs {epochs}")
    with _EpochLog() as log:
        model, _, resumed_loss = finetune_resnet50(
            str(data), out, epochs=FT_EPOCHS + 1, **kw)
    resumed = log.epochs()
    if (f"resuming fine-tune from epoch {FT_EPOCHS}" not in log.text()
            or [e["epoch"] for e in resumed] != [FT_EPOCHS]):
        raise AssertionError(f"resume: {log.text()}")

    images, labels, _ = load_labeled_dir(str(data), size=224)
    order = np.random.default_rng(1).permutation(len(images))
    blob = preprocess_batch(torch.from_numpy(images[order[:FT_BATCH]]).to(
        DEVICE), size=224)
    lab = torch.from_numpy(labels[order[:FT_BATCH]]).to(DEVICE)
    timed = copy.deepcopy(model)
    from imageclust_tpu_torch.models.train import (
        init_opt_state,
        make_train_step,
    )

    opt = init_opt_state(timed)
    step = make_train_step(timed, learning_rate=FT_LR)
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: step(timed, opt, blob, lab), reps=10, warm=2)
    step_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    split = _train_step_profile(timed, blob, lab)
    del timed, opt
    torch.cuda.empty_cache()

    check = _card_against_cpu(
        resnet50_flax_from_state_dict(model),
        blob[:FT_CHECK_BATCH].cpu(), lab[:FT_CHECK_BATCH].cpu())

    emb = create_embedder(EmbedConfig(checkpoint_path=out,
                                      num_classes=FT_CLASSES), device=DEVICE)
    mem = create_embedder(EmbedConfig(onnx_path="", num_classes=FT_CLASSES),
                          device=DEVICE)
    mem.model.load_state_dict(model.state_dict())
    sample = images[order[:FT_SERVE_N]]
    a, b = emb.embed(sample), mem.embed(sample)
    tag = emb.tag
    if not (emb.weights_loaded and ":torch-ckpt-" in emb.tag
            and a.shape == (FT_SERVE_N, FT_CLASSES)
            and np.array_equal(a.view(np.uint32), b.view(np.uint32))):
        raise AssertionError(f"served checkpoint differs: {emb.tag}")
    del emb, mem
    torch.cuda.empty_cache()
    mk.launches = 0
    served = phase_server(card, "resnet50",
                          {"checkpoint_path": out,
                           "num_classes": FT_CLASSES},
                          ("18_images",), "server_finetuned")

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "imageclust_tpu_torch.cli", "train",
         "--images", str(data), "--out", str(tmp / "cli" / "embedder"),
         "--epochs", "1", "--batch", str(FT_BATCH), "--device", DEVICE],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    cli_s = time.perf_counter() - t0
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "cli_train.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(f"cli train exited {proc.returncode}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    if (set(line) != {"checkpoint", "classes", "final_loss"}
            or line["classes"] != classes
            or not np.isfinite(line["final_loss"])):
        raise AssertionError(f"cli train: {line}")

    emit({"phase": "finetune", "card": card,
          "images": len(images), "classes": len(classes),
          "batch": FT_BATCH, "stage_layers": list(model.stage_layers),
          "dtype": "bfloat16", "learning_rate": FT_LR,
          "epochs": epochs, "train_s": train_s,
          "peak_memory_gib": peak_gib, "resumed_epochs": resumed,
          "resumed_loss": resumed_loss,
          "step_ms": step_ms, "step_images_per_s": FT_BATCH / step_ms * 1e3,
          "step_peak_memory_gib": step_peak_gib, "step_split": split,
          "card_vs_cpu": check, "served_tag": tag,
          "served_bit_identical_images": FT_SERVE_N,
          "server_k1_launches": served["k1"],
          "cli_train": line, "cli_train_s": cli_s,
          "fixture": fixture})
    return served["k1"]


# -- phase 28: the mesh on the card ---------------------------------------------
#
# The parent process computes the single-card references, then starts the
# ranks with launch_processes(device="cuda"): (a) one rank over NCCL, (b) two
# ranks sharing the card over gloo. Each rank runs mesh_rank(), which pickles
# its results to $IMAGECLUST_SMOKE_OUT/mesh_<part>_rank<r>.pkl; the parent
# holds them against the references.

MESH_SEQ_N, MESH_SEQ_D = 200, 64  # phase 28: the sequential chain's job
MESH_EXACT_N = 512  # phase 28: the exact engine's job (d = 1000)
MESH_TRAIN_BATCH = 64              # phase 28: the full-width train step
MESH_LAUNCH_S = {"nccl": 300.0, "gloo": 600.0}  # each launch's time limit


def _mesh_inputs():
    """Every input of phase 28, made from seeds (each rank makes its own)."""
    import numpy as np

    return {
        "exact": {data: _loop_features(MESH_EXACT_N, data, 1000, 7)
                  for data in ("integer_grid", "gaussian_blobs")},
        "chain_rnn": np.random.default_rng(0).standard_normal(
            (CHAIN_GREEDY_N, CHAIN_GREEDY_D)).astype(np.float32),
        "chain_seq": np.random.default_rng(28).standard_normal(
            (MESH_SEQ_N, MESH_SEQ_D)).astype(np.float32),
    }


def _big_features(dev):
    """Phase 8's 100,000 x 1000 features, on ``dev``."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(8)
    return torch.randn((BIG_N, BIG_D), generator=gen, device=dev)


def _grad_f64(state: dict, images, labels) -> dict:
    """The gradient of the train step's loss in float64 throughout, from
    ``state``'s weights on the card: every convolution, BatchNorm's batch
    statistics (the step's formula, ``max(E[x^2] - mean^2, 0)``), the pooled
    mean, the head and the softmax cross entropy. The exact gradient that
    phase 28 measures the float32 steps' distances from."""
    import torch
    import torch.nn.functional as F

    from imageclust_tpu_torch.models.resnet50 import ResNet50V1

    model = ResNet50V1(num_classes=FT_CLASSES, dtype="float32")
    model.load_state_dict(state)
    model = model.double().to(DEVICE)

    def conv(mod, x):
        return F.conv2d(x, mod.weight, mod.bias, stride=mod.stride,
                        padding=mod.padding)

    def bn(mod, x):
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0)
        mul = torch.rsqrt(var + 1e-5) * mod.weight
        return ((x - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1)
                + mod.bias.view(1, -1, 1, 1))

    x = images.to(DEVICE, torch.float64)
    x = F.max_pool2d(bn(model.bn0, conv(model.conv0, x)).relu(), 3, 2,
                     padding=1)
    for si, n_blocks in enumerate(model.stage_layers):
        for bi in range(n_blocks):
            blk = getattr(model, f"stage{si + 1}_block{bi}")
            y = bn(blk.bn0, conv(blk.conv0, x)).relu()
            y = bn(blk.bn1, conv(blk.conv1, y)).relu()
            y = bn(blk.bn2, conv(blk.conv2, y))
            if blk.conv_proj is not None:
                x = bn(blk.bn_proj, conv(blk.conv_proj, x))
            x = (y + x).relu()
    logits = F.linear(x.mean(dim=(2, 3)), model.dense0.weight,
                      model.dense0.bias)
    F.cross_entropy(logits, labels.to(DEVICE).long()).backward()
    return {k: p.grad.cpu() for k, p in model.named_parameters()}


def _mesh_train_input(tmp: Path) -> dict:
    """Phase 28's train step inputs, at two sets of weights: the seeded
    tower that phase 27's fine-tune starts from, and phase 27's tuned one
    (``finetune_resnet50`` on its labelled BMPs, two epochs at batch 64,
    bf16); one batch, the first 64 images of phase 27's check order,
    preprocessed; and at each set of weights the float64 gradient on that
    batch (:func:`_grad_f64`). Written to
    ``$IMAGECLUST_SMOKE_OUT/mesh_train.pt`` for the ranks."""
    import numpy as np
    import torch

    from imageclust_tpu_torch.models.finetune import (
        finetune_resnet50,
        load_labeled_dir,
    )
    from imageclust_tpu_torch.models.resnet50 import ResNet50V1
    from imageclust_tpu_torch.ops.preprocess import preprocess_batch

    data = _finetune_dir(tmp)
    model, _, _ = finetune_resnet50(
        str(data), str(tmp / "tuned" / "embedder"), epochs=FT_EPOCHS,
        batch_size=FT_BATCH, learning_rate=FT_LR, device=DEVICE)
    images, labels, _ = load_labeled_dir(str(data), size=224)
    pick = np.random.default_rng(1).permutation(len(images))[
        :MESH_TRAIN_BATCH]
    blob = preprocess_batch(torch.from_numpy(images[pick]).to(DEVICE),
                            size=224).float().cpu()
    labels = torch.from_numpy(labels[pick])
    seeded = ResNet50V1(num_classes=FT_CLASSES, dtype="float32").init_random(0)
    out = {"images": blob, "labels": labels, "weights": {}}
    for name, tower in (("seeded", seeded), ("tuned", model)):
        state = {k: v.detach().float().cpu()
                 for k, v in tower.state_dict().items()}
        out["weights"][name] = {"state": state,
                                "grad64": _grad_f64(state, blob, labels)}
        torch.cuda.empty_cache()
    torch.save(out, OUT / "mesh_train.pt")
    return out


def _columnar(res) -> dict:
    """What two runs of one engine must share: the merge log, and the
    partition as (cluster id per item, dropped items)."""
    import numpy as np

    return {"merges": np.asarray(res.merges), "assign": res.assignments(),
            "dropped": sorted(int(i) for i in (
                res._dropped_idx if res._dropped_idx is not None else []))
            if res._members is not None else sorted(res.dropped)}


def _gloo_cuda_probe(mesh) -> dict:
    """Raw torch.distributed collectives under gloo on CUDA tensors (two
    ranks on one card), each checked for its value: "ok", "wrong" or the
    error's first line; and one all_reduce inside autograd's backward (a
    custom Function whose backward sums its gradient over the ranks), its
    largest error. The wrappers (core/collectives.py) hand card tensors to
    gloo directly, so each must be "ok" and the error 0."""
    import torch
    import torch.distributed as dist

    dev = mesh.device
    r, w = mesh.rank, mesh.size
    x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * r
    ranks_sum = sum(torch.arange(4.0) + 10 * q for q in range(w))

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return torch.equal(y.cpu(), ranks_sum)

    def broadcast():
        y = x.clone()
        dist.broadcast(y, src=0)
        return torch.equal(y.cpu(), torch.arange(4.0))

    def all_gather():
        parts = [torch.empty_like(x) for _ in range(w)]
        dist.all_gather(parts, x)
        return all(torch.equal(p.cpu(), torch.arange(4.0) + 10 * q)
                   for q, p in enumerate(parts))

    def all_to_all():
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x.clone())
        return torch.equal(y.cpu(), torch.cat([
            torch.arange(4.0)[2 * r:2 * r + 2] + 10 * q for q in range(w)]))

    out = {}
    for name, fn in (("all_reduce", all_reduce), ("broadcast", broadcast),
                     ("all_gather", all_gather), ("all_to_all", all_to_all)):
        try:
            out[name] = "ok" if fn() else "wrong"
        except Exception as e:  # recorded and printed, never hidden
            out[name] = (str(e).strip().splitlines() or [repr(e)])[0][:160]
        dist.barrier()

    class _SumGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return t.clone()

        @staticmethod
        def backward(ctx, g):
            g = g.contiguous().clone()
            dist.all_reduce(g)
            return g

    errs = []
    base = (torch.arange(1 << 20) % 97 + 1).float()
    for _ in range(8):
        t = torch.ones(1 << 20, device=dev, requires_grad=True)
        wt = base.to(dev) * (r + 1)
        (torch.exp(_SumGrad.apply(t * 2.0)) * wt).sum().backward()
        want = (2.0 * torch.exp(torch.tensor(2.0)) * base
                * sum(q + 1 for q in range(w)))
        errs.append(float((t.grad.cpu() - want).abs().max()
                          / want.abs().max()))
    out["all_reduce_in_backward_rel_err"] = max(errs)
    dist.barrier()
    return out


def mesh_rank() -> None:
    """One rank of phase 28 (a target of launch_processes): the part named
    by IMAGECLUST_MESH_PART ("nccl": one rank; "gloo": two ranks on one
    card) on the mesh over every rank, each job between a reset and a read
    of the launch and collective counters and the peak memory."""
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist

    from imageclust_tpu_torch.cluster import (
        constrained_ward,
        constrained_ward_bucketed,
        constrained_ward_chain,
    )
    from imageclust_tpu_torch.core.collectives import COUNTERS
    from imageclust_tpu_torch.core.mesh import create_mesh

    part = os.environ["IMAGECLUST_MESH_PART"]
    mesh = create_mesh(data=-1, device="cuda")
    torch.cuda.set_device(mesh.device)
    out = {"rank": mesh.rank, "device": str(mesh.device),
           "backend": mesh.backend, "world": mesh.size}
    inputs = _mesh_inputs()

    def run(name, fn):
        _zero_counters()
        COUNTERS.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        dist.barrier()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        out[name] = {"wall_s": time.perf_counter() - t0, "result": result,
                     "launches": _counters(),
                     "collectives": COUNTERS.snapshot(),
                     "peak_bytes": torch.cuda.max_memory_allocated() - base}

    if part == "gloo":
        out["gloo_cuda"] = _gloo_cuda_probe(mesh)
    for data, x in inputs["exact"].items():
        run(f"exact_{data}", lambda: _columnar(constrained_ward(
            x, min_size=3, max_size=6, update_rule="centroid",
            reassign_dropped=False, mesh=mesh)))
    xb = _big_features(mesh.device)
    for rule in ("lance_williams", "centroid"):
        run(f"bucketed_{rule}", lambda: _columnar(constrained_ward_bucketed(
            xb, min_size=3, max_size=6, update_rule=rule, mesh=mesh)))
    del xb
    if part == "gloo":
        for impl, x in (("rnn", inputs["chain_rnn"]),
                        ("seq", inputs["chain_seq"])):
            os.environ["IMAGECLUST_CHAIN_IMPL"] = impl
            run(f"chain_{impl}", lambda: _columnar(constrained_ward_chain(
                x, min_size=3, max_size=6, mesh=mesh)))
            del os.environ["IMAGECLUST_CHAIN_IMPL"]
        run("pipeline", lambda: _mesh_pipeline(mesh))
        for data, model in ((2, 1), (1, 2)):
            tm = create_mesh(data=data, model=model, device="cuda")
            run(f"train_{data}x{model}", lambda: _mesh_train_step(tm))
    with open(OUT / f"mesh_{part}_rank{mesh.rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)
    print(f"mesh rank {mesh.rank} of {part}: done", flush=True)


@contextlib.contextmanager
def _features_seen():
    """The features the pipeline hands the bucketed engine (a tensor, or
    this rank's ShardedRows), captured in ``seen``."""
    from imageclust_tpu_torch import pipeline as pl

    seen = []
    engine = pl.constrained_ward_bucketed

    def spy(features, *args, **kwargs):
        seen.append(features)
        return engine(features, *args, **kwargs)

    pl.constrained_ward_bucketed = spy
    try:
        yield seen
    finally:
        pl.constrained_ward_bucketed = engine


def _sha(t) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()
                          ).hexdigest()


def _mesh_pipeline(mesh) -> dict:
    """``Pipeline.run_paths`` over the mesh on phase 9's 4500 BMPs (every
    rank reads, decodes and embeds its row block; the bucketed engine on
    row-sharded features). Where the partition differs from the single
    card's (pickled by the parent), the k-means assignments of the two
    forms on these features are traced: each item whose bucket differs,
    and the relative gap of its distances to the two centroids."""
    import pickle

    from imageclust_tpu_torch.config import AppConfig
    from imageclust_tpu_torch.pipeline import Pipeline

    paths = sorted(str(p) for p in Path(
        os.environ["IMAGECLUST_MESH_IMAGES"]).iterdir())
    t0 = time.perf_counter()
    pipe = Pipeline(AppConfig(), mesh=mesh)
    build_s = time.perf_counter() - t0
    with _features_seen() as seen:
        res = pipe.run_paths(paths, str(OUT / "mesh_pipeline_work"))
    whole = seen[0].gather()
    out = {"partition": sorted(sorted(d.images)
                               for d in res.clusters.values()),
           "dropped": sorted(res.dropped), "build_s": build_s,
           "stages_s": res.metrics.stages, "features_sha256": _sha(whole)}
    with open(OUT / "mesh_pipeline_ref.pkl", "rb") as fh:
        want = pickle.load(fh)
    if out["partition"] != want["partition"]:
        out["kmeans_trace"] = _kmeans_trace(seen[0], whole)
    return out


def _kmeans_trace(sharded, whole) -> dict:
    """The bucketed engine's k-means on row-sharded features (psum'd sums)
    against one device's on the same whole features, after 0, 1, ... 8
    Lloyd iterations: the first iteration count whose assignments differ,
    and there, for each item assigned differently, the relative gap
    (float64) between its distances to the two buckets' centroids of the
    one-device run, beside the largest relative difference of the two
    runs' centroids; then the same gaps after all 8 iterations. A flip
    moves the centroids it feeds, so a near tie at the first divergence
    can leave later items farther apart."""
    import numpy as np

    from imageclust_tpu_torch.cluster import sharded as tsh

    n = whole.shape[0]
    k = max(1, -(-n // max(3, int(512 * 0.75))))
    x = whole.double().cpu().numpy()

    def gaps(cs, as_, am):
        c = cs.double().cpu().numpy()
        out = []
        for i in np.nonzero(am != as_)[0]:
            da = ((x[i] - c[as_[i]]) ** 2).sum()
            db = ((x[i] - c[am[i]]) ** 2).sum()
            out.append(float(abs(db - da) / max(da, 1e-300)))
        return out

    trace = {"buckets": k}
    for iters in range(9):
        cm, am, _, _ = tsh.kmeans(sharded, k, iters, 0)
        cs, as_, _, _ = tsh.kmeans(whole, k, iters, 0)
        am, as_ = am.cpu().numpy(), as_.cpu().numpy()
        if "first_divergence" not in trace and (am != as_).any():
            g = gaps(cs, as_, am)
            trace["first_divergence"] = {
                "iterations": iters, "items": len(g),
                "relative_gaps": g[:32], "max_relative_gap": max(g),
                "centroids_max_rel_diff": float(
                    ((cm - cs).abs().max() / cs.abs().max()).cpu())}
    g = gaps(cs, as_, am)
    trace.update({"items_assigned_differently": len(g),
                  "relative_gaps": g[:32],
                  "max_relative_gap": max(g) if g else None})
    return trace


def _mesh_train_step(mesh) -> dict:
    """The full-width ResNet50 train step (float32, TF32 off) over ``mesh``
    at batch 64 against the single-card step, on this rank, at both sets
    of weights of :func:`_mesh_train_input`. Each gradient leaf is measured
    three ways (relative L2): the mesh's from the single card's, and each
    one's from the float64 gradient. At the tuned weights the gates are
    phase 27's: loss rtol 1e-4, each gradient leaf 1e-3 from the single
    card's, batch_stats 1e-4 of each leaf's largest magnitude. At the
    seeded weights the float32 gradient itself lies about 2.6e-2 from
    float64 at its worst leaf on an H100, on one card as on the mesh, so
    two float32 reduction orders differ by as much; there the mesh's
    largest leaf distance from float64 must be at most twice the single
    card's (a rank that normalised with its own batch statistics, or a
    gradient not summed over ``data``, is off by far more)."""
    import copy

    import numpy as np
    import torch

    from imageclust_tpu_torch.core.collectives import all_gather_rows
    from imageclust_tpu_torch.models.resnet50 import ResNet50V1
    from imageclust_tpu_torch.models.train import (
        gather_variables,
        init_opt_state,
        make_train_step,
        param_spec,
        shard_model,
    )

    def rel(a, b):
        a, b = a.double().cpu(), b.double().cpu()
        return float(torch.linalg.vector_norm(a - b)
                     / max(float(torch.linalg.vector_norm(b)), 1e-30))

    def worst(d):
        return sorted(d.items(), key=lambda kv: -kv[1])[:3]

    given = torch.load(OUT / "mesh_train.pt", weights_only=True)
    images = given["images"].to(mesh.device)
    labels = given["labels"].to(mesh.device)
    rows = {}
    for name, w in given["weights"].items():
        full = ResNet50V1(num_classes=FT_CLASSES, dtype="float32")
        full.load_state_dict(w["state"])
        ref = copy.deepcopy(full).to(mesh.device)
        model = shard_model(full, mesh)  # a first step warms cuDNN's choices
        make_train_step(model, learning_rate=FT_LR, mesh=mesh)(
            model, init_opt_state(model), images, labels)
        del model, full
        torch.cuda.synchronize()
        model_s = shard_model(copy.deepcopy(ref), mesh)
        step = make_train_step(model_s, learning_rate=FT_LR, mesh=mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(model_s, init_opt_state(model_s), images, labels)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        ref_step = make_train_step(ref, learning_rate=FT_LR)
        ref_loss = ref_step(ref, init_opt_state(ref), images, labels)
        mesh_single, mesh_64, single_64 = {}, {}, {}
        ref_params = dict(ref.named_parameters())
        for k, p in model_s.named_parameters():
            g = p.grad
            if param_spec(k, p):
                g = all_gather_rows(g.contiguous(), mesh, "model")
            mesh_single[k] = rel(g, ref_params[k].grad)
            mesh_64[k] = rel(g, w["grad64"][k])
            single_64[k] = rel(ref_params[k].grad, w["grad64"][k])
        got = gather_variables(model_s, mesh)
        stats = max(float((got[k].double() - v.double().cpu()).abs().max()
                          / max(float(v.abs().max()), 1e-30))
                    for k, v in ref.state_dict().items() if "running" in k)
        row = {"loss": float(loss), "loss_single": float(ref_loss),
               "loss_rel": abs(float(loss) - float(ref_loss))
               / abs(float(ref_loss)),
               "grad_rel_l2_max": max(mesh_single.values()),
               "grad_rel_l2_worst_leaves": worst(mesh_single),
               "mesh_from_f64_max": max(mesh_64.values()),
               "mesh_from_f64_worst_leaves": worst(mesh_64),
               "single_from_f64_max": max(single_64.values()),
               "single_from_f64_worst_leaves": worst(single_64),
               "batch_stats_rel_max": stats, "step_s": step_s}
        row["ok"] = bool(np.isfinite(row["loss"]))
        if name == "tuned":  # phase 27's gates
            row["ok"] = (row["ok"] and row["loss_rel"] <= 1e-4
                         and row["grad_rel_l2_max"] <= 1e-3
                         and stats <= 1e-4)
        else:  # no farther from float64 than the single card, up to 2x
            row["ok"] = (row["ok"] and row["mesh_from_f64_max"]
                         <= 2 * row["single_from_f64_max"])
        rows[name] = row
    return {**rows["tuned"], "seeded": rows["seeded"],
            "ok": rows["tuned"]["ok"] and rows["seeded"]["ok"]}


def _mesh_references(inputs, paths) -> dict:
    """The single-card runs phase 28's ranks are held against."""
    import pickle

    import torch

    from imageclust_tpu_torch.cluster import (
        constrained_ward,
        constrained_ward_bucketed,
        constrained_ward_chain,
    )
    from imageclust_tpu_torch.config import AppConfig
    from imageclust_tpu_torch.pipeline import Pipeline

    ref, secs = {}, {}
    for data, x in inputs["exact"].items():
        t0 = time.perf_counter()
        ref[f"exact_{data}"] = _columnar(constrained_ward(
            x, min_size=3, max_size=6, update_rule="centroid",
            reassign_dropped=False, device=DEVICE))
        secs[f"exact_{data}"] = time.perf_counter() - t0
    xb = _big_features(torch.device(DEVICE))
    for rule in ("lance_williams", "centroid"):
        t0 = time.perf_counter()
        ref[f"bucketed_{rule}"] = _columnar(constrained_ward_bucketed(
            xb, min_size=3, max_size=6, update_rule=rule, device=DEVICE))
        secs[f"bucketed_{rule}"] = time.perf_counter() - t0
    del xb
    for impl, x in (("rnn", inputs["chain_rnn"]),
                    ("seq", inputs["chain_seq"])):
        os.environ["IMAGECLUST_CHAIN_IMPL"] = impl
        t0 = time.perf_counter()
        ref[f"chain_{impl}"] = _columnar(constrained_ward_chain(
            x, min_size=3, max_size=6, device=DEVICE))
        secs[f"chain_{impl}"] = time.perf_counter() - t0
        del os.environ["IMAGECLUST_CHAIN_IMPL"]
    t0 = time.perf_counter()
    with _features_seen() as seen:
        res = Pipeline(AppConfig(), device=DEVICE).run_paths(
            paths, str(OUT / "mesh_pipeline_single"))
    secs["pipeline"] = time.perf_counter() - t0
    ref["pipeline"] = {"partition": sorted(sorted(d.images)
                                           for d in res.clusters.values()),
                       "dropped": sorted(res.dropped),
                       "features_sha256": _sha(seen[0])}
    with open(OUT / "mesh_pipeline_ref.pkl", "wb") as fh:
        pickle.dump(ref["pipeline"], fh)
    return ref, secs


def _mesh_compare(name: str, got: dict, want: dict, x=None) -> dict:
    """A rank's engine result against the single card's: identical merge
    logs and partitions, or (on real-valued features) a traced difference
    whose first divergence must be a near tie (relative gap below 1e-5 in
    float64)."""
    import numpy as np

    if name == "pipeline":
        row = {"identical_features": got["features_sha256"]
               == want["features_sha256"],
               "identical_partition": got["partition"] == want["partition"]
               and got["dropped"] == want["dropped"]}
        if row["identical_partition"]:
            return row
        # traced: the features must be the single card's, and every item
        # the row-block k-means first assigns elsewhere a near tie
        trace = got.get("kmeans_trace") or {}
        row["kmeans_trace"] = trace
        gap = trace.get("first_divergence", {}).get("max_relative_gap")
        if not (row["identical_features"] and gap is not None
                and gap < 1e-5):
            raise AssertionError(f"mesh {name}: partition differs from the "
                                 f"single card's: {row}")
        return row
    logs = np.array_equal(got["merges"], want["merges"])
    part = (np.array_equal(got["assign"], want["assign"])
            and got["dropped"] == want["dropped"])
    row = {"identical_logs": bool(logs), "identical_partition": bool(part)}
    if logs and part:
        return row
    if x is None or "integer_grid" in name:
        raise AssertionError(f"mesh {name}: {row} against the single card")
    div = _first_divergence(x, got["merges"], want["merges"], 6)
    row["first_divergence"] = div
    # a near tie: a cluster between two partners, or the two logs' merges
    # at one distance
    gaps = [c["relative_gap"] for c in (div or {}).get("clusters", [])]
    if div:
        gaps.append(div["merge_gap"])
    if not gaps or min(gaps) > 1e-5:
        raise AssertionError(f"mesh {name}: differs beyond a near tie: "
                             f"{row}")
    return row


def _mesh_part_summary(part: str, ranks: list, ref: dict, inputs) -> dict:
    """Phase 28's checks and numbers for one part, from every rank."""
    rows = {}
    for name in [k for k in ranks[0] if isinstance(ranks[0][k], dict)
                 and "wall_s" in ranks[0][k]]:
        per = [r[name] for r in ranks]
        row = {"wall_s": [p["wall_s"] for p in per],
               "peak_bytes": [p["peak_bytes"] for p in per],
               # host seconds inside the collectives: under gloo (which
               # blocks) their whole cost, its host staging included
               "collective_s": [p["collectives"]["seconds"] for p in per],
               "collective_calls": per[0]["collectives"]["calls"],
               "collective_bytes": [p["collectives"]["bytes"] for p in per],
               "k2_launches": [p["launches"]["k2"] for p in per],
               "k3_launches": [p["launches"]["k3"] for p in per]}
        if name.startswith("train"):
            row.update(per[0]["result"])
            for p in per:
                if not p["result"]["ok"]:
                    raise AssertionError(f"mesh {part} {name}: {p['result']}")
            rows[name] = row
            continue
        x = None
        if name.startswith("exact_"):
            x = inputs["exact"][name[len("exact_"):]]
        elif name.startswith("chain_"):
            x = inputs[name]
        for p in per:
            row.update(_mesh_compare(name, p["result"], ref[name], x))
        if name.startswith(("exact", "bucketed", "chain")):
            merges = len(per[0]["result"]["merges"])
            row["merges"] = merges
        if name.startswith("exact"):
            row["collective_bytes_per_merge"] = [
                sum(b.values()) / max(merges, 1)
                for b in row["collective_bytes"]]
            if max(row["collective_bytes_per_merge"]) > 8 * 4 * MESH_EXACT_N:
                raise AssertionError(f"mesh {part} {name}: more than O(n) "
                                     f"bytes a merge: {row}")
        if name.startswith("bucketed"):
            row["exchange_bytes"] = [b.get("all_to_all", 0)
                                     for b in row["collective_bytes"]]
            key = "k2_launches" if "lance" in name else "k3_launches"
            if min(row[key]) < 1:  # every rank ran its buckets on the kernel
                raise AssertionError(f"mesh {part} {name}: {key} {row[key]}")
        if name == "pipeline":
            row["stages_s"] = per[0]["result"]["stages_s"]
            if min(row["k2_launches"]) < 1:
                raise AssertionError(f"mesh {part} pipeline: K2 {row}")
        rows[name] = row
    return rows


def phase_mesh(card: str):
    """Phase 28: the mesh on the card. (a) One rank over NCCL: the mesh
    exact engine at 512 x 1000 (phase 3's generators) and the mesh
    bucketed engine at 100,000 x 1000 (phase 8's) under both rules. (b) Two
    ranks sharing the card over gloo: the same, the chain's rounds at
    4096 x 512
    (phase 24's shape) and the sequential chain at 200 x 64,
    ``Pipeline.run_paths`` on phase 9's 4500 BMPs, and the full-width
    ResNet50 train step at batch 64 at (data=2, model=1) and (data=1,
    model=2). Each is held against the single card: merge logs and
    partitions identical (a real-valued difference must trace to a near
    tie), the train step at phase 27's gates at tuned weights and, at
    seeded ones, no farther from the float64 gradient than twice the
    single card's distance. A failing rank fails the phase with every
    rank's log."""
    import pickle

    import numpy as np

    from imageclust_tpu_torch.parallel import launch_processes

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="imageclust_smoke_mesh_"))
    try:
        rng = np.random.default_rng(9)  # phase 9's images
        names, blobs, _ = group_images(rng, BIG_CLI_GROUPS, 5, "s")
        images = tmp / "images"
        images.mkdir()
        for name, blob in zip(names, blobs):
            (images / name).write_bytes(blob)
        del blobs
        paths = sorted(str(images / n) for n in names)
        inputs = _mesh_inputs()
        t0 = time.perf_counter()
        ref, ref_s = _mesh_references(inputs, paths)
        t1 = time.perf_counter()
        _mesh_train_input(tmp / "ft")
        ref_s["train_input"] = time.perf_counter() - t1
        ref_wall = time.perf_counter() - t0
        summary = {"phase": "mesh", "card": card,
                   "single_card_s": ref_s, "references_s": ref_wall}
        env = {"IMAGECLUST_MESH_IMAGES": str(images),
               "IMAGECLUST_SMOKE_OUT": str(OUT)}
        for part, n, backend in (("nccl", 1, "nccl"), ("gloo", 2, "gloo")):
            t0 = time.perf_counter()
            logs = launch_processes(
                "chip_smoke:mesh_rank", n, device="cuda", backend=backend,
                timeout=MESH_LAUNCH_S[part],
                env={**env, "IMAGECLUST_MESH_PART": part})
            launch_s = time.perf_counter() - t0
            (OUT / f"mesh_{part}.log").write_text("\n---\n".join(logs))
            ranks = []
            for r in range(n):
                with open(OUT / f"mesh_{part}_rank{r}.pkl", "rb") as fh:
                    ranks.append(pickle.load(fh))
            rows = _mesh_part_summary(part, ranks, ref, inputs)
            if part == "gloo":  # what gloo does with card tensors, raw
                probes = [r["gloo_cuda"] for r in ranks]
                rows["gloo_cuda_collectives"] = probes
                for probe in probes:
                    bad = {k: v for k, v in probe.items()
                           if v not in ("ok", 0.0)}
                    if bad:  # the wrappers pass card tensors to gloo
                        raise AssertionError(
                            f"gloo on CUDA tensors: {bad}")
            summary[part] = {"ranks": n, "backend": backend,
                             "launch_s": launch_s, "parts": rows}
            emit({"phase": f"mesh_{part}", "card": card, "ranks": n,
                  "launch_s": launch_s, "parts": rows})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(OUT / "mesh_pipeline_work", ignore_errors=True)
        shutil.rmtree(OUT / "mesh_pipeline_single", ignore_errors=True)
        (OUT / "mesh_train.pt").unlink(missing_ok=True)
    emit({"phase": "mesh", "card": card, "single_card_s": ref_s,
          "references_s": ref_wall,
          "phase_s": time.perf_counter() - t_phase})
    return summary


# -- the cloud backends and verify (phase 29) --------------------------------

# phase 29: the AWS endpoints the stub answers for, and the services it
# stands in for (the job's labeler and namers)
CLOUD_REGION = "us-east-1"
CLOUD_NAMERS = ("claude_haiku", "nova_micro", "gpt-3.5-turbo")
CLOUD_SECRET = "smoke-secret-imds"  # the IMDS role's secret key
CLOUD_ECS_TOKEN = "Bearer smoke-ecs-token"


def _sigv4_valid(method: str, url: str, body: bytes, headers: dict,
                 creds: dict, region: str, service: str) -> bool:
    """Recompute a SigV4 signature from the credentials the endpoints
    served (AWS's published algorithm, written out here apart from
    ``utils/aws.py``) and hold the request's ``Authorization`` to it."""
    import hmac
    import re
    import urllib.parse

    h = {k.lower(): v for k, v in headers.items()}
    m = re.fullmatch(
        r"AWS4-HMAC-SHA256 Credential=([^/]+)/(\d{8})/([^/]+)/([^/]+)/"
        r"aws4_request, SignedHeaders=([a-z0-9;-]+), Signature=([0-9a-f]{64})",
        h.get("authorization", ""))
    if m is None or m[1] != creds["AccessKeyId"] or m[3] != region \
            or m[4] != service or h.get("x-amz-date", "")[:8] != m[2]:
        return False
    signed = m[5].split(";")
    if not {"host", "x-amz-date", "x-amz-security-token"} <= set(signed) \
            or h["x-amz-security-token"] != creds["Token"]:
        return False
    parts = urllib.parse.urlsplit(url)
    values = {**h, "host": parts.netloc}
    canonical = "\n".join([
        method, urllib.parse.quote(parts.path or "/"), parts.query,
        "".join(f"{k}:{values[k].strip()}\n" for k in signed),
        ";".join(signed), hashlib.sha256(body).hexdigest()])
    scope = f"{m[2]}/{region}/{service}/aws4_request"
    to_sign = "\n".join(["AWS4-HMAC-SHA256", h["x-amz-date"], scope,
                         hashlib.sha256(canonical.encode()).hexdigest()])
    key = ("AWS4" + creds["SecretAccessKey"]).encode()
    for part in (m[2], region, service, "aws4_request"):
        key = hmac.new(key, part.encode(), hashlib.sha256).digest()
    want = hmac.new(key, to_sign.encode(), hashlib.sha256).hexdigest()
    return hmac.compare_digest(want, m[6])


class _CredentialEndpoints:
    """The container credentials endpoint and IMDSv2 on a local
    ``http.server`` thread, reached through the port's real ``urllib``
    transport. ``served`` holds the credentials each one gave."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        expiry = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                               time.gmtime(time.time() + 3600))
        self.served = {
            "ecs": {"AccessKeyId": "ASIASMOKEECS",
                    "SecretAccessKey": "smoke-secret-ecs",
                    "Token": "smoke-session-ecs", "Expiration": expiry},
            "imds": {"Code": "Success", "AccessKeyId": "ASIASMOKEIMDS",
                     "SecretAccessKey": CLOUD_SECRET,
                     "Token": "smoke-session-imds", "Expiration": expiry}}
        self.requests = []
        ep = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _answer(self, status: int, body):
                body = body if isinstance(body, bytes) else body.encode()
                self.send_response(status)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _handle(self):
                ep.requests.append((self.command, self.path))
                token = self.headers.get("X-aws-ec2-metadata-token")
                role_path = "/latest/meta-data/iam/security-credentials/"
                if self.command == "GET" and self.path == "/v2/creds/smoke":
                    if self.headers.get("Authorization") != CLOUD_ECS_TOKEN:
                        return self._answer(401, "bad token")
                    return self._answer(200, json.dumps(ep.served["ecs"]))
                if self.command == "PUT" and self.path == "/latest/api/token":
                    return self._answer(200, "smoke-imds-token")
                if token != "smoke-imds-token":
                    return self._answer(401, "IMDSv2 token missing")
                if self.path == role_path:
                    return self._answer(200, "smoke-role\n")
                if self.path == role_path + "smoke-role":
                    return self._answer(200, json.dumps(ep.served["imds"]))
                return self._answer(404, "no route")

            do_GET = do_PUT = _handle

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(30)


class _CloudStub:
    """Rekognition, Bedrock (Claude, Nova) and OpenAI behind the port's
    transport seam (``utils.aws.http_request``): each SigV4 signature is
    recomputed from the IMDS credentials and a wrong one is refused (403);
    the first Rekognition, Claude and OpenAI requests get a 429, and every
    Nova request for a cluster that carries ``nova_403`` gets a 403, so
    those clusters end in the fallback pair. A request to any other host
    raises (the credentials were resolved, through the real transport,
    before the stub went in)."""

    def __init__(self, creds: dict, labels_by_sha: dict, nova_403: str):
        self.creds = creds
        self.labels_by_sha, self.nova_403 = labels_by_sha, nova_403
        self.lock = threading.Lock()
        self.counts = dict.fromkeys(("rekognition", "claude", "nova",
                                     "openai", "throttled", "refused",
                                     "fallback_403"), 0)
        self.first = {"rekognition", "claude", "openai"}  # get a 429 first

    def __call__(self, method, url, body=None, headers=None, timeout=30.0):
        import base64
        import re
        import urllib.parse

        host = urllib.parse.urlsplit(url).hostname
        service = {f"rekognition.{CLOUD_REGION}.amazonaws.com": "rekognition",
                   "api.openai.com": "openai"}.get(host)
        if host == "bedrock-runtime.us-west-2.amazonaws.com":
            service = "nova" if "nova" in url else "claude"
        if service is None or method != "POST":
            raise AssertionError(f"cloud stub: unexpected {method} {url}")
        with self.lock:
            self.counts[service] += 1
            throttle = service in self.first
            self.first.discard(service)
        if service == "openai":
            if headers.get("Authorization") != "Bearer smoke-openai-key":
                return 401, b'{"error": "bad key"}'
        elif not _sigv4_valid(method, url, body, headers, self.creds,
                              *((CLOUD_REGION, "rekognition")
                                if service == "rekognition"
                                else ("us-west-2", "bedrock"))):
            with self.lock:
                self.counts["refused"] += 1
            return 403, b'{"message": "SignatureDoesNotMatch"}'
        if throttle:
            with self.lock:
                self.counts["throttled"] += 1
            return 429, b'{"message": "ThrottlingException"}'
        req = json.loads(body)
        if service == "rekognition":
            img = base64.b64decode(req["Image"]["Bytes"])
            labels = self.labels_by_sha[hashlib.sha256(img).hexdigest()]
            return 200, json.dumps({"Labels": [
                {"Name": n, "Confidence": c} for n, c in labels]}).encode()
        prompt = (req["messages"][-1]["content"] if "messages" in req
                  else req["inputText"])
        features = re.search(r"Features: (.*)\.$", prompt, re.S)[1]
        if service == "nova" and self.nova_403 in features:
            with self.lock:
                self.counts["fallback_403"] += 1
            return 403, b'{"message": "AccessDeniedException"}'
        text = json.dumps({"title": _cloud_title(service, features),
                           "catchy_phrase": f"{service} phrase"})
        if service == "openai":
            return 200, json.dumps(
                {"choices": [{"message": {"content": text}}]}).encode()
        if service == "nova":
            return 200, json.dumps({"Results": [{"outputText": text}]}
                                   ).encode()
        return 200, json.dumps({"content": [{"type": "text",
                                             "text": text}]}).encode()


def _cloud_title(service: str, features: str) -> str:
    return f"{service} {hashlib.sha256(features.encode()).hexdigest()[:8]}"


@contextlib.contextmanager
def _environ(**values):
    """Set (a str) or remove (None) environment variables for a block."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_cloud(card: str):
    """The cloud backends and ``cli verify`` on the card: credentials from a
    local container endpoint and IMDSv2 through the real transport, one
    200-image ``Pipeline.run`` with Rekognition labels and Claude, Nova and
    OpenAI names (a SigV4-checking stub at the transport's seam), the same
    job again on its label cache, the payload shrink, and ``cli verify
    --clip-text`` / ``--onnx`` with ``--device cuda``."""
    from imageclust_tpu_torch.utils import aws

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="imageclust_smoke_cloud_"))
    endpoints = _CredentialEndpoints()
    real = aws.http_request
    try:
        with _environ(
                AWS_ACCESS_KEY_ID=None, AWS_SECRET_ACCESS_KEY=None,
                AWS_SESSION_TOKEN=None, AWS_WEB_IDENTITY_TOKEN_FILE=None,
                AWS_PROFILE=None, AWS_CONTAINER_CREDENTIALS_FULL_URI=None,
                AWS_SHARED_CREDENTIALS_FILE=str(tmp / "no_credentials"),
                AWS_CONFIG_FILE=str(tmp / "no_config"),
                AWS_CONTAINER_CREDENTIALS_RELATIVE_URI="/v2/creds/smoke",
                AWS_CONTAINER_AUTHORIZATION_TOKEN=CLOUD_ECS_TOKEN,
                IMAGECLUST_ECS_BASE=endpoints.base,
                AWS_EC2_METADATA_SERVICE_ENDPOINT=endpoints.base,
                AWS_EC2_METADATA_DISABLED="false",
                OPENAI_API_KEY="smoke-openai-key"):
            creds = _cloud_credentials(aws, endpoints)
            out = _cloud_job(aws, creds, tmp)
        out.update(_cloud_shrink())
        out.update(_cloud_verify(tmp))
    finally:
        aws.http_request = real
        aws._CACHE = None
        endpoints.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if endpoints.thread.is_alive():
        raise AssertionError("cloud: the credential server did not stop")
    emit({"phase": "cloud", "card": card, **out,
          "credential_requests": endpoints.requests,
          "phase_s": time.perf_counter() - t_phase})
    return out["k1_launches"]


def _cloud_credentials(aws, endpoints) -> dict:
    """Resolve through the container endpoint, then (its variables gone)
    through IMDSv2; the IMDS credentials stay cached for the job."""
    ecs = aws.resolve_credentials(force_refresh=True)
    want = endpoints.served["ecs"]
    if (ecs.access_key, ecs.secret_key, ecs.session_token) != (
            want["AccessKeyId"], want["SecretAccessKey"], want["Token"]):
        raise AssertionError(f"cloud: container credentials {ecs}")
    with _environ(AWS_CONTAINER_CREDENTIALS_RELATIVE_URI=None):
        imds = aws.resolve_credentials(force_refresh=True)
    want = endpoints.served["imds"]
    if (imds.access_key, imds.secret_key, imds.session_token) != (
            want["AccessKeyId"], want["SecretAccessKey"], want["Token"]):
        raise AssertionError(f"cloud: IMDS credentials {imds}")
    if not imds.expiry > time.time() + 3000:
        raise AssertionError(f"cloud: IMDS expiry {imds.expiry}")
    if [r[0] for r in endpoints.requests] != ["GET", "PUT", "GET", "GET"]:
        raise AssertionError(f"cloud: endpoints saw {endpoints.requests}")
    return want


def _cloud_job(aws, creds: dict, tmp: Path) -> dict:
    import numpy as np

    from imageclust_tpu_torch.config import (
        AppConfig,
        LabelConfig,
        NamingConfig,
    )
    from imageclust_tpu_torch.labels.base import CachedLabeler
    from imageclust_tpu_torch.naming.base import (
        FALLBACK_PHRASE,
        FALLBACK_TITLE,
        truncate_and_sanitize,
    )
    from imageclust_tpu_torch.ops import merge_kernels as mk
    from imageclust_tpu_torch.pipeline import Pipeline
    from imageclust_tpu_torch.types import UploadedImage

    names, blobs, groups = group_images(np.random.default_rng(29),
                                        SERVER_GROUPS, 5, "cloud_")
    canned = {hashlib.sha256(b).hexdigest(): [(f"Colour g{g:02d}", 99.0),
                                              ("Smoke Test", 88.5)]
              for b, g in zip(blobs, groups)}
    stub = _CloudStub(creds, canned, nova_403="Colour g00")
    aws.http_request = stub
    # the stub refuses a request signed with other credentials
    try:
        aws.aws_post_json(
            f"https://rekognition.{CLOUD_REGION}.amazonaws.com/",
            CLOUD_REGION, "rekognition", {"Image": {"Bytes": ""}},
            creds=aws.AwsCredentials(creds["AccessKeyId"], "wrong-secret",
                                     creds["Token"]))
        raise AssertionError("cloud: a wrong signature was accepted")
    except aws.AwsError as exc:
        if exc.status != 403 or stub.counts["refused"] != 1:
            raise
    stub.counts["rekognition"] = stub.counts["refused"] = 0
    stub.first.add("rekognition")

    cfg = AppConfig(
        labels=LabelConfig(backend="rekognition", region=CLOUD_REGION,
                           retry_delay_s=0.0),
        naming=NamingConfig(services=CLOUD_NAMERS, retry_delay_s=0.0))
    pipeline = Pipeline(cfg, device=DEVICE)
    uploads = [UploadedImage(n, b) for n, b in zip(names, blobs)]
    work = tmp / "job"
    mk.launches = 0
    t0 = time.perf_counter()
    result = pipeline.run(uploads, str(work), min_size=3, max_size=6)
    job_s = time.perf_counter() - t0
    launches = mk.launches
    first = dict(stub.counts)
    data = result.to_dict()
    merges = int(data["metrics"]["counters"]["merges"])
    _check_launches("cloud job", launches, merges)
    _check_sizes(data["clusters"])
    placed = [m for c in data["clusters"].values() for m in c["images"]]
    if sorted(placed + data["dropped"]) != sorted(names):
        raise AssertionError("cloud: images lost")
    # the labels the job used, image by image, from its label cache
    cache = CachedLabeler(None, str(work / "cache"),
                          namespace="RekognitionLabeler")
    for blob in blobs:
        with open(cache._cache_path(blob)) as fh:
            got = [(d["name"], d["confidence"])
                   for d in json.load(fh)["labels"]]
        if got != canned[hashlib.sha256(blob).hexdigest()]:
            raise AssertionError(f"cloud: labels {got}")
    # the names: the stub's titles, sorted by display order, and the
    # fallback pair where Nova answered 403
    order = ["Amazon Nova Micro", "OpenAI GPT-3.5 Turbo", "Claude Haiku v3.5"]
    fallbacks = 0
    for key, c in data["clusters"].items():
        features = truncate_and_sanitize(c["labels"], 1000)
        outs = c["serviceOutputs"]
        if [o["serviceName"] for o in outs] != order:
            raise AssertionError(f"cloud: {key} outputs {outs}")
        want = [_cloud_title("nova", features), _cloud_title("openai",
                                                               features),
                _cloud_title("claude", features)]
        if "Colour g00" in features:
            want[0] = FALLBACK_TITLE
            fallbacks += 1
            if outs[0]["catchyPhrase"] != FALLBACK_PHRASE:
                raise AssertionError(f"cloud: {key} Nova {outs[0]}")
        if [o["title"] for o in outs] != want:
            raise AssertionError(f"cloud: {key} titles {outs} != {want}")
    if not fallbacks or first["throttled"] != 3 or first["refused"] \
            or first["fallback_403"] != 3 * fallbacks \
            or first["rekognition"] != len(names) + 1:
        raise AssertionError(f"cloud: stub counts {first}, {fallbacks} "
                             "fallback clusters")
    # the same job on the same label cache: no Rekognition request
    mk.launches = 0
    t0 = time.perf_counter()
    again = pipeline.run(uploads, str(work), min_size=3, max_size=6)
    rerun_s = time.perf_counter() - t0
    _check_launches("cloud re-run", mk.launches, merges)
    rerun_rek = stub.counts["rekognition"] - first["rekognition"]
    if rerun_rek or again.metrics.counters["label_cache_hits"] != len(names):
        raise AssertionError(
            f"cloud re-run: {rerun_rek} Rekognition requests, "
            f"{again.metrics.counters['label_cache_hits']} cache hits")
    if again.to_dict()["clusters"] != data["clusters"]:
        raise AssertionError("cloud re-run: another result")
    return {"images": len(names), "job_s": job_s, "rerun_s": rerun_s,
            "stages_s": data["metrics"]["stages_s"],
            "clusters": len(data["clusters"]), "merges": merges,
            "k1_launches": launches, "nova_fallback_clusters": fallbacks,
            "requests": first,
            "rerun_requests": {k: stub.counts[k] - first[k]
                               for k in stub.counts}}


def _cloud_shrink() -> dict:
    """An over-limit BMP through ``shrink_to_payload_limit``: a JPEG at
    most 2048 px on its larger side where cv2 is importable, else the
    ValueError that names cv2."""
    import importlib.util

    import numpy as np

    from imageclust_tpu_torch.labels.rekognition import (
        shrink_to_payload_limit,
    )

    limit = 5 * 1024 * 1024
    yy, xx = np.mgrid[0:2000, 0:3000]
    img = np.stack([yy % 256, xx % 256, (yy + xx) % 256], -1).astype(np.uint8)
    bmp = encode_bmp(img)
    has_cv2 = importlib.util.find_spec("cv2") is not None
    try:
        out = shrink_to_payload_limit(bmp, limit)
    except ValueError as exc:
        if has_cv2 or "cv2" not in str(exc):
            raise
        return {"shrink": {"cv2": False, "bmp_bytes": len(bmp),
                           "error": str(exc)}}
    if not has_cv2:
        raise AssertionError("cloud: shrank an image without cv2")
    import cv2

    dec = cv2.imdecode(np.frombuffer(out, np.uint8), cv2.IMREAD_COLOR)
    if out[:2] != b"\xff\xd8" or max(dec.shape[:2]) > 2048:
        raise AssertionError(f"cloud: shrink gave {dec.shape}")
    return {"shrink": {"cv2": True, "bmp_bytes": len(bmp),
                       "jpeg_bytes": len(out), "shape": list(dec.shape)}}


def _cli_verify(args: list) -> tuple[int, dict, str]:
    from imageclust_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["verify", *args, "--device", DEVICE])
    text = out.getvalue()
    return rc, json.loads(text[:text.rindex("VERDICT")]), \
        text.strip().splitlines()[-1]


def _cloud_verify(tmp: Path) -> dict:
    """``cli verify --clip-text`` on the seeded text checkpoint (PASS) and
    ``--onnx`` on a seeded export: PASS where cv2 is importable (its
    partition check runs K1), else exit 2 naming cv2."""
    import importlib.util

    from imageclust_tpu_torch.models.onnx_export import export_resnet50_onnx
    from imageclust_tpu_torch.models.resnet50 import ResNet50V1
    from imageclust_tpu_torch.ops import merge_kernels as mk

    t0 = time.perf_counter()
    text_path = _clip_text_checkpoint()
    try:
        rc, text_report, verdict = _cli_verify(["--clip-text",
                                                str(text_path)])
    finally:
        text_path.unlink(missing_ok=True)
    if rc != 0 or verdict != "VERDICT: PASS" or not text_report["ok"]:
        raise AssertionError(
            f"verify --clip-text: {rc} {verdict} {text_report}")
    text_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    onnx_path = tmp / "resnet50_seeded.onnx"
    export_resnet50_onnx(ResNet50V1().init_random(ONNX_SEED), str(onnx_path))
    mk.launches = 0
    try:
        rc, report, verdict = _cli_verify(["--onnx", str(onnx_path)])
    finally:
        onnx_path.unlink(missing_ok=True)
    if importlib.util.find_spec("cv2") is not None:
        if rc != 0 or verdict != "VERDICT: PASS" or not mk.launches:
            raise AssertionError(f"verify --onnx: {rc} {verdict} {report}")
    elif rc != 2 or "cv2" not in report.get("error", ""):
        raise AssertionError(f"verify --onnx without cv2: {rc} {report}")
    return {"verify_clip_text": {"rc": 0, "verdict": "VERDICT: PASS",
                                 "s": text_s,
                                 "checks": text_report["clip_text"]["checks"]},
            "verify_onnx": {"rc": rc, "verdict": verdict, "report": report,
                            "k1_launches": mk.launches,
                            "s": time.perf_counter() - t0}}


def _bench_mode(card: str, name: str, fn, *args, **kw) -> dict:
    """One harness mode with the launch counters set to 0 just before and
    read just after; its stderr detail goes to ``$IMAGECLUST_SMOKE_OUT``."""
    err = io.StringIO()
    _zero_counters()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        res = fn(*args, **kw)
    s = time.perf_counter() - t0
    c = _counters()
    with open(OUT / "bench_phase.log", "a") as fh:
        fh.write(f"== {name}\n{err.getvalue()}")
    detail = res.pop("detail")
    emit({"phase": "bench", "mode": name, "line": res, "detail": detail,
          "launches": {k: c[k] for k in ("k1", "k2", "k3", "k4", "k5")},
          "s": s})
    if detail["device"] != {"card": card, "count": 1}:
        raise AssertionError(f"bench {name}: device {detail['device']}, "
                             f"card {card!r}")
    if not res["value"] > 0:
        raise AssertionError(f"bench {name}: value {res['value']}")
    return {"metric": res["metric"], "vs_baseline": res["vs_baseline"],
            **c}


def phase_bench(card: str):
    """The benchmark harness's modes on the card, each once at a small
    size (30). Returns the K1, K2 and K5 launches of the modes that reach
    them."""
    import importlib.util

    from imageclust_tpu_torch import bench
    from imageclust_tpu_torch.models.registry import DEFAULT_BATCH

    t_phase = time.perf_counter()
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "bench_phase.log").unlink(missing_ok=True)
    seen = []
    real = bench.constrained_ward_bucketed

    def spy(feats, **kw):  # where the e2e features live
        seen.append((type(feats).__name__, str(feats.device)))
        return real(feats, **kw)

    n, d = BENCH_E2E_N, BENCH_D
    runs = {}
    bench.constrained_ward_bucketed = spy
    try:
        runs["e2e"] = _bench_mode(card, "e2e", bench.bench_e2e, n,
                                  BENCH_E2E_BATCH, 256, device=DEVICE)
    finally:
        bench.constrained_ward_bucketed = real
    if len(seen) != 2 or any(w[0] != "Tensor" or not w[1].startswith(DEVICE)
                             for w in seen):
        raise AssertionError(f"bench e2e: features at {seen}")
    with tempfile.TemporaryDirectory(prefix="imageclust_smoke_bench_") as wd:
        runs["e2e-stream"] = _bench_mode(
            card, "e2e-stream", bench.bench_e2e_stream, n, "resnet50", 0,
            256, "float32", wd, device=DEVICE)
    for cn, engine in BENCH_CLUSTER:
        runs[f"cluster-only {engine}"] = _bench_mode(
            card, f"cluster-only {engine}", bench.bench_cluster_only, cn, d,
            256, engine, device=DEVICE)
    for model in ("resnet50", "vit_b32"):
        runs[f"embed-only {model}"] = _bench_mode(
            card, f"embed-only {model}", bench.bench_embed_only, model, 0,
            BENCH_EMBED_N, device=DEVICE)
    if importlib.util.find_spec("cv2") is not None:
        runs["decode"] = _bench_mode(card, "decode", bench.bench_decode,
                                     BENCH_DECODE_N, 8, device=DEVICE)
    else:
        try:
            bench.bench_decode(BENCH_DECODE_N, 8, device=DEVICE)
        except RuntimeError as exc:
            if "cv2" not in str(exc):
                raise
        else:
            raise AssertionError("bench decode ran without cv2")
    runs["quality"] = _bench_mode(card, "quality", bench.bench_quality,
                                  BENCH_QUALITY_N, d, 1.0, "", 0,
                                  device=DEVICE)

    want = {
        "e2e": f"e2e_embed+ward_{n // 1000}k_images",
        "e2e-stream": f"e2e_stream_{n // 1000}k_images[resnet50 float32]",
        "cluster-only auto": f"ward_cluster_{BENCH_CLUSTER[0][0]}_items",
        "cluster-only bucketed": f"ward_cluster_{BENCH_CLUSTER[1][0]}_items",
        **{f"embed-only {m}": f"embed_img_per_s[{m} b{DEFAULT_BATCH[m]}]"
           for m in ("resnet50", "vit_b32")},
        "decode": f"host_decode_{BENCH_DECODE_N}_jpegs",
        "quality": f"quality_nonparity_min_ari[n{BENCH_QUALITY_N} d{d} "
                   "sep1.0]",
    }
    null = {"e2e", "e2e-stream", "cluster-only auto",
            "cluster-only bucketed"}
    for name, r in runs.items():
        if r["metric"] != want[name]:
            raise AssertionError(f"bench {name}: metric {r['metric']}")
        if (r["vs_baseline"] is None) != (name in null):
            raise AssertionError(f"bench {name}: vs_baseline "
                                 f"{r['vs_baseline']}")
    reach = {"k1": ("cluster-only auto",),
             "k2": ("e2e", "e2e-stream", "cluster-only bucketed",
                    "quality"),
             "k5": ("embed-only vit_b32",)}
    for k, names in reach.items():
        for name in names:
            if not runs[name][k]:
                raise AssertionError(f"bench {name}: no {k.upper()} launch")
    emit({"phase": "bench_summary", "card": card, "modes": len(runs),
          "phase_s": time.perf_counter() - t_phase})
    return {k: sum(runs[name][k] for name in names)
            for k, names in reach.items()}


# phase 31: K6 at the ResNet50 tower's shapes at batch 512 and 224 px: (what,
# C, H, W, residual kind, launches a batch); 49 launches in all
K6_BATCH = 512
K6_SHAPES = (("stem", 64, 112, 112, "none", 1),
             ("stage1 inner", 64, 56, 56, "none", 6),
             ("stage1 out", 256, 56, 56, "projected", 1),
             ("stage1 out", 256, 56, 56, "raw", 2),
             ("stage2 inner", 128, 28, 28, "none", 8),
             ("stage2 out", 512, 28, 28, "projected", 1),
             ("stage2 out", 512, 28, 28, "raw", 3),
             ("stage3 inner", 256, 14, 14, "none", 12),
             ("stage3 out", 1024, 14, 14, "projected", 1),
             ("stage3 out", 1024, 14, 14, "raw", 5),
             ("stage4 inner", 512, 7, 7, "none", 6),
             ("stage4 out", 2048, 7, 7, "projected", 1),
             ("stage4 out", 2048, 7, 7, "raw", 2))
K6_LAUNCHES = 49  # a ResNet50 batch: the stem's bn0, then 3 a block


def _k6_operands(gen, shape, dt, nd, residual):
    """(x, vectors, residual, residual vectors) on the card: activations
    normal times 3 in channels_last memory, BatchNorm statistics and affine
    drawn near identity (the vectors from ``_BatchNorm.vectors``)."""
    import torch

    from imageclust_tpu_torch.models.resnet50 import _BatchNorm

    def act(dtype):
        return (torch.randn(shape, generator=gen, device=DEVICE) * 3).to(
            dtype).contiguous(memory_format=torch.channels_last)

    def vectors():  # detached: K6 raises where autograd tracks an operand
        c = shape[1]
        bn = _BatchNorm(c).to(DEVICE)
        with torch.no_grad():
            for t, lo in ((bn.running_mean, -0.5), (bn.running_var, 0.5),
                          (bn.weight, 0.5), (bn.bias, -0.5)):
                t.copy_(torch.rand(c, generator=gen, device=DEVICE) + lo)
            return tuple(v.detach() for v in bn.vectors())

    res = rvec = None
    if residual == "raw":  # the block's input, in norm_dtype
        res = act(nd)
    elif residual == "projected":  # the projection conv's output
        res, rvec = act(dt), vectors()
    return act(dt), vectors(), res, rvec


def _k6_bytes(shape, dt, nd, residual) -> int:
    """One read of x (and of the residual) and one write of the output,
    with the per-channel vectors."""
    import torch

    n = shape[0] * shape[1] * shape[2] * shape[3]
    size = {torch.bfloat16: 2, torch.float32: 4}
    res = {"none": 0, "raw": size[nd], "projected": size[dt]}[residual]
    vec = 4 * shape[1] * (6 if residual == "projected" else 3)
    return n * (size[dt] + size[nd] + res) + vec


def phase_k6(card: str):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from imageclust_tpu_torch.config import EmbedConfig
    from imageclust_tpu_torch.models import create_embedder
    from imageclust_tpu_torch.models import resnet50 as rn
    from imageclust_tpu_torch.ops import bn_act as ba

    gen = torch.Generator(device=DEVICE).manual_seed(31)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(what, (K6_BATCH, c, h, w), residual, bf16, bf16)
             for what, c, h, w, residual, _ in K6_SHAPES]
    for what, c, h, w in (("stem", 64, 112, 112),
                          ("stage3 out", 1024, 14, 14)):
        for dt, nd in ((bf16, f32), (f32, f32), (f32, bf16)):
            for residual in ("none", "raw", "projected"):
                cases.append((what, (64, c, h, w), residual, dt, nd))
    checked = []
    max_err = 0.0
    for what, shape, residual, dt, nd in cases:
        x, vec, res, rvec = _k6_operands(gen, shape, dt, nd, residual)
        for relu in (True, False):
            before = ba.launches
            got = ba.bn_act(x, *vec, nd, res, rvec, relu=relu)
            want = ba.bn_act_plain(x, *vec, nd, res, rvec, relu=relu)
            torch.cuda.synchronize()
            if ba.launches != before + 1:
                raise AssertionError("K6 call did not count one launch")
            max_err = max(max_err, float(
                (got.float() - want.float()).abs().max()))
            if not (got.is_contiguous(memory_format=torch.channels_last)
                    and _same_bits(got, want)):
                diff = int((got.float() != want.float()).sum())
                raise AssertionError(f"K6 != twin at {what} {shape} "
                                     f"{residual} {dt}->{nd} relu={relu}: "
                                     f"{diff} elements differ")
        checked.append([what, list(shape), residual, str(dt)[6:],
                        str(nd)[6:]])
        del x, vec, res, rvec, got, want
    emit({"phase": "k6_parity", "calls": 2 * len(checked),
          "parity": "bit-identical", "cases": checked})

    # the whole bf16 tower at batch 512, on K6 and on the twin in its place
    emb = create_embedder(EmbedConfig(
        model="resnet50", batch_size=K6_BATCH, dtype="bfloat16",
        norm_dtype="bfloat16", s2d_stem=True), device=DEVICE)
    model = emb.model
    images = torch.randint(0, 256, (K6_BATCH, 224, 224, 3), generator=gen,
                           device=DEVICE, dtype=torch.uint8)

    @torch.inference_mode()
    def tower():
        return model(images)

    def peak_bytes():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        tower()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    tower()
    torch.cuda.synchronize()
    before = ba.launches
    got = tower()
    torch.cuda.synchronize()
    launches = ba.launches - before
    if launches != K6_LAUNCHES:
        raise AssertionError(f"ResNet50 batch: {launches} K6 launches")
    k6_tower_ms = cuda_ms(tower, reps=10)
    k6_peak = peak_bytes()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tower()
        torch.cuda.synchronize()
    all_us = _kernel_us(prof)
    k6_us = _kernel_us(prof, ("bn_act",))
    top = sorted(((e.key[:90], getattr(e, "self_device_time_total", getattr(
        e, "self_cuda_time_total", 0.0)) / 1e3)
        for e in prof.key_averages()), key=lambda kv: -kv[1])[:10]
    saved = rn.batch_norm_act
    rn.batch_norm_act = ba.bn_act_plain
    try:
        want = tower()
        plain_tower_ms = cuda_ms(tower, reps=10)
        plain_peak = peak_bytes()
    finally:
        rn.batch_norm_act = saved
    tower_err = float((got.float() - want.float()).abs().max())
    max_err = max(max_err, tower_err)
    if not _same_bits(got, want):
        raise AssertionError(
            f"ResNet50 on K6 != on the twin: max abs {tower_err}")
    emit({"phase": "k6_tower", "card": card, "batch": K6_BATCH,
          "dtype": "bfloat16", "norm_dtype": "bfloat16", "stem": "s2d_raw",
          "logits": "bit-identical", "k6_launches": launches,
          "k6_batch_ms": k6_tower_ms, "plain_batch_ms": plain_tower_ms,
          "k6_images_per_s": K6_BATCH / k6_tower_ms * 1e3,
          "plain_images_per_s": K6_BATCH / plain_tower_ms * 1e3,
          "k6_peak_bytes": k6_peak, "plain_peak_bytes": plain_peak,
          "batch_device_ms": all_us / 1e3, "batch_k6_device_ms": k6_us / 1e3,
          "top_kernels_ms": top,
          "timing": "*_batch_ms: CUDA events around one forward, median of "
                    "10; batch_*device_ms, top_kernels_ms: torch.profiler "
                    "kernel time of one forward on K6; peaks: "
                    "max_memory_allocated over one forward, above what was "
                    "allocated before it"})
    del emb, model, images, got, want

    # K6's time at each shape of the tower beside its bound and the twin's
    rows = []
    k6_batch = bound_batch = plain_batch = 0.0
    for what, c, h, w, residual, count in K6_SHAPES:
        shape = (K6_BATCH, c, h, w)
        x, vec, res, rvec = _k6_operands(gen, shape, bf16, bf16, residual)
        call = lambda: ba.bn_act(x, *vec, bf16, res, rvec,  # noqa: E731
                                 relu=True)
        plain = lambda: ba.bn_act_plain(x, *vec, bf16, res,  # noqa: E731
                                        rvec, relu=True)
        ms = burst_ms(call)
        dev_ms = device_ms(call, ("bn_act",))
        plain_ms = burst_ms(plain)
        nbytes = _k6_bytes(shape, bf16, bf16, residual)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append({"what": what, "shape": list(shape),
                     "residual": residual, "launches_a_batch": count,
                     "burst_ms": ms, "device_ms": dev_ms,
                     "plain_burst_ms": plain_ms, "bytes": nbytes,
                     "bound_ms": bound_ms,
                     "pct_of_bound": 100 * bound_ms / (dev_ms or ms)})
        k6_batch += count * (dev_ms or ms)
        bound_batch += count * bound_ms
        plain_batch += count * plain_ms
        del x, vec, res, rvec
    emit({"phase": "k6_time", "card": card, "dtype": "bfloat16",
          "rows": rows, "batch_k6_ms": k6_batch,
          "batch_bound_ms": bound_batch, "batch_plain_ms": plain_batch,
          "pct_of_bound": 100 * bound_batch / k6_batch,
          "timing": f"burst_ms: CUDA events around {TIMING_REPS} back-to-"
                    "back warm calls, per call; device_ms: torch.profiler "
                    f"kernel time, mean of {TIMING_REPS}; bound: bytes over "
                    "3.35 TB/s; batch_*: summed over a batch's 49 launches "
                    "(device_ms where the profiler read one)"})
    stem = rows[0]
    return max_err, launches, {"ms": stem["burst_ms"], "device_ms": stem["device_ms"],
                 "plain_ms": stem["plain_burst_ms"],
                 "bound_ms": stem["bound_ms"], "bound_by": "bytes",
                 "batch_ms": k6_batch, "batch_bound_ms": bound_batch}


PHASES = {
    2: phase_k1, 3: phase_engine, 4: phase_server, 5: phase_cli,
    6: phase_k3, 7: phase_k2, 8: phase_engine_100k, 9: phase_cli_big,
    10: phase_stream, 11: phase_k5, 12: phase_vit_tower,
    13: lambda card: phase_server(card, "vit_b32"),
    14: lambda card: phase_cli_big(card, VIT_CLI_GROUPS, "vit_b32"),
    15: phase_other_towers, 16: phase_k4, 17: phase_engine_k4,
    18: phase_stream_big, 19: phase_onnx, 20: phase_int8_towers,
    21: phase_text_tower, 22: phase_server_zero_shot, 23: phase_stream_joint,
    24: phase_chain, 25: phase_chain_pipeline, 26: phase_scoreboards,
    27: phase_finetune, 28: phase_mesh, 29: phase_cloud, 30: phase_bench,
    31: phase_k6,
}


def main(argv: list[str] | None = None) -> int:
    t_start = time.perf_counter()
    args = sys.argv[1:] if argv is None else argv
    # development runs: `chip_smoke.py --phases 11,12` drives only those
    # phases after the build; the full run takes no arguments
    only = []
    if args[:1] == ["--phases"] and len(args) == 2:
        only = [int(n) for n in args[1].split(",")]
    elif args:
        print("usage: chip_smoke.py [--phases N,M,...]", file=sys.stderr)
        return 2
    if not (REPO / "imageclust_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {REPO} is not a checkout of the repository",
              file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not importable", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from imageclust_tpu_torch.device import resolve_device

    resolve_device("cuda")  # TF32 off for the whole run
    card = phase_card_and_build()
    if only:  # a development run of some phases: no summary, no result
        try:
            for n in only:
                PHASES[n](card)
        finally:
            (OUT / "clip_text_b32_seeded.pt").unlink(missing_ok=True)
        return 0
    walls = {1: time.perf_counter() - t_start}  # start-up and the build

    def run(n: int):
        t0 = time.perf_counter()
        out = PHASES[n](card)
        walls[n] = time.perf_counter() - t0
        return out

    max_err, timings = run(2)
    run(3)
    launches = run(4)["k1"]
    run(5)
    k3_err, k3_t = run(6)
    k2_err, k2_t = run(7)
    big_launches = run(8)
    run(9)
    stream_k6_launches = run(10)
    k5_err, k5_t = run(11)
    run(12)
    vit_launches = run(13)["k5"]
    run(14)
    run(15)
    k4_err, k4_t = run(16)
    run(17)
    k4_launches = run(18)["k4"]
    run(19)
    int8_launches = run(20)["k5"]
    try:
        run(21)
        run(22)
        run(23)
    finally:
        (OUT / "clip_text_b32_seeded.pt").unlink(missing_ok=True)
    run(24)
    run(25)
    run(26)
    run(27)
    run(28)
    cloud_launches = run(29)
    bench_launches = run(30)
    k6_err, tower_k6_launches, k6_t = run(31)
    emit({"phase": "wall_times", "phases_s": walls,
          "script_s": time.perf_counter() - t_start})
    t = timings[4096]
    emit({"kernels": [{
        "name": "merge_update_argmin",
        "route": "cuda",
        "source": "imageclust_tpu_torch/csrc/merge_update_argmin.cu",
        "replaces": "imageclust_tpu/ops/pallas_kernels.py:134",
        "launches": launches + cloud_launches + bench_launches["k1"],
        "max_abs_err": max_err,
        **t,
        "bound_by": "bytes",
        "library_ms": None,
        "shape": "n=4096: a cached loop call (ms, call_ms, plain_ms, "
                 "bound_ms) and the full scan of a call without a loop "
                 "(full_scan_*)",
        "parity": "bit-identical",
    }, {
        "name": "merge_loop_whole",
        "route": "cuda",
        "source": "imageclust_tpu_torch/csrc/merge_loop_whole.cu",
        "replaces": "imageclust_tpu/ops/pallas_kernels.py:491",
        "launches": big_launches["k2"] + bench_launches["k2"],
        "max_abs_err": k2_err,
        **k2_t,
        "library_ms": None,
        "shape": "C=256, B=512, 384 items a bucket (the 100k job's chunk)",
        "parity": "bit-identical",
    }, {
        "name": "merge_update_argmin_batched",
        "route": "cuda",
        "source": "imageclust_tpu_torch/csrc/merge_update_argmin_batched.cu",
        "replaces": "imageclust_tpu/ops/pallas_kernels.py:270",
        "launches": big_launches["k3"],
        "max_abs_err": k3_err,
        **k3_t,
        "library_ms": None,
        "shape": "C=261, B=512, 384 items a bucket: a cached lockstep call "
                 "after 100 iterations (ms, call_ms, plain_ms, bound_ms) and "
                 "the full scan of a call without a loop (full_scan_*)",
        "parity": "bit-identical",
    }, {
        "name": "short_seq_attention",
        "route": "cuda",
        "source": "imageclust_tpu_torch/csrc/short_seq_attention.cu",
        "replaces": "imageclust_tpu/ops/attention.py:64",
        "launches": vit_launches + int8_launches + bench_launches["k5"],
        "max_abs_err": k5_err,
        **k5_t,
        "shape": "B=1024, T=50, H=12, Dh=64 bf16 (ViT-B/32 at batch 1024)",
        "parity": "tolerance",
    }, {
        "name": "pref_topk_block",
        "route": "cuda",
        "source": "imageclust_tpu_torch/csrc/pref_topk_block.cu",
        "replaces": "imageclust_tpu/ops/pallas_kernels.py:629",
        "launches": k4_launches,
        "max_abs_err": k4_err,
        **k4_t,
        "library_ms": None,
        "shape": "n=2,000,000, k=5209, d=512 bf16, kk=8 (a 2M job's "
                 "summarize pass)",
        "parity": "bit-identical on integer grids",
    }, {
        "name": "bn_act",
        "route": "cuda",
        "source": "imageclust_tpu_torch/csrc/bn_act.cu",
        "replaces": None,
        "launches": stream_k6_launches + tower_k6_launches,
        "max_abs_err": k6_err,
        **k6_t,
        "library_ms": None,
        "shape": "the stem, 512 x 64 x 112 x 112 bf16 (ms, device_ms, "
                 "plain_ms, bound_ms); batch_*: a ResNet50 batch of 512",
        "parity": "bit-identical",
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
