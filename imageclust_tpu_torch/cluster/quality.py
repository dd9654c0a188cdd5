"""Quality scoreboard scenarios for the NON-parity modes, on PyTorch.

The port of ``imageclust_tpu/cluster/quality.py``. The precision-caveated
modes buy capacity and throughput; these scenarios measure what they cost:
partition agreement (:mod:`imageclust_tpu_torch.cluster.agreement`) against
the f32 parity path (clustering.go:198-284's semantics) on *overlapping*
synthetic mixtures, where near-tied Ward distances flip under rounding.

* :func:`residency_scoreboard`: ``cluster.feature_dtype=bfloat16|int8``
  against f32 on the same device-resident features.
* :func:`fusion_scoreboard`: ``labels.fusion=text`` (the text tower's dense
  label block) against the parity ``onehot`` block.
* :func:`ptq_scoreboard`: ``embed.quantize=int8`` towers against the bf16
  towers on the same synthetic images.

Every function runs on ``device`` (default ``"cuda"``; raises without a
card) and takes no mesh. Mixtures and images are drawn from a
``torch.Generator`` on that device, so they are not the JAX package's for
the same seed (nor the CPU's the card's).
"""

from __future__ import annotations

import numpy as np
import torch

from imageclust_tpu_torch.cluster.agreement import agreement
from imageclust_tpu_torch.device import resolve_device

__all__ = [
    "synth_mixture",
    "synth_mixture_labels",
    "residency_scoreboard",
    "fusion_scoreboard",
    "ptq_scoreboard",
]


def _generator(dev: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def synth_mixture(n: int, d: int, *, k: int | None = None,
                  sep: float = 1.0, seed: int = 0,
                  balanced: bool = False, device=None):
    """Overlapping Gaussian mixture ON THE DEVICE: (features f32 tensor,
    true component ids np.int64).

    ``k`` defaults to ``n // 5``: components the size of the engine's
    target clusters. Component centers are drawn N(0, sep^2 I) and items
    N(center, I); ``sep=1`` is heavy overlap, ``sep>=8`` approaches
    separated blobs. ``balanced=True`` assigns exactly ``n // k`` items per
    component (a permutation of round-robin ids) instead of uniform draws:
    with ``n/k`` inside [min_size, max_size] and a large ``sep`` every
    engine mode must agree outright."""
    dev = resolve_device(device)
    if k is None:
        k = max(2, n // 5)
    gen = _generator(dev, seed)
    centers = torch.randn((k, d), generator=gen, device=dev) * sep
    if balanced:
        perm = torch.randperm(n, generator=gen, device=dev)
        z = (torch.arange(n, device=dev) % k)[perm]
    else:
        z = torch.randint(0, k, (n,), generator=gen, device=dev)
    feats = centers[z] + torch.randn((n, d), generator=gen, device=dev)
    return feats, z.cpu().numpy().astype(np.int64)


def _bucketed(feats, feature_dtype: str, *, bucket_size: int = 256,
              seed: int = 0, device=None) -> np.ndarray:
    from imageclust_tpu_torch.cluster.sharded import constrained_ward_bucketed

    res = constrained_ward_bucketed(
        feats, min_size=3, max_size=6, bucket_size=bucket_size,
        update_rule="lance_williams", feature_dtype=feature_dtype,
        seed=seed, device=device,
    )
    return res.assignments()


def residency_scoreboard(n: int, d: int, *, sep: float = 1.0,
                         k: int | None = None, bucket_size: int = 256,
                         seed: int = 0, balanced: bool = False,
                         modes=("bfloat16", "int8"), device=None) -> dict:
    """Agreement of each residency dtype's partition against the f32
    engine's on one shared overlapping mixture. Returns
    ``{mode: agreement-dict + ari_vs_truth}`` with an ``"f32"`` row carrying
    the parity run's own ari_vs_truth, and ``"f32_seed_yardstick"``: the
    f32 engine against itself under another k-means seed, the unit for
    reading the mode rows (a dtype must not diverge more than the engine's
    own bucketing randomness)."""
    feats, truth = synth_mixture(n, d, k=k, sep=sep, seed=seed,
                                 balanced=balanced, device=device)
    kw = dict(bucket_size=bucket_size, device=feats.device)
    base = _bucketed(feats, "float32", seed=seed, **kw)
    out = {"f32": {"ari_vs_truth": agreement(base, truth)["ari"]}}
    alt = _bucketed(feats, "float32", seed=seed + 1, **kw)
    out["f32_seed_yardstick"] = agreement(base, alt)
    for mode in modes:
        got = _bucketed(feats, mode, seed=seed, **kw)
        row = agreement(base, got)
        row["ari_vs_truth"] = agreement(got, truth)["ari"]
        out[mode] = row
    return out


def synth_mixture_labels(truth: np.ndarray, *, n_vocab: int = 0,
                         noise: float = 0.3, seed: int = 0):
    """Synthetic per-image label lists correlated with the true components:
    each image carries its component's label (confidence ~90) plus, with
    probability ``noise``, one shared distractor label — enough vocabulary
    collision to make the fusion block matter without determining the
    partition outright. Returns (per_image_labels, label_set)."""
    from imageclust_tpu_torch.labels.base import Label

    rng = np.random.default_rng(seed)
    k = int(truth.max()) + 1
    n_vocab = n_vocab or max(4, k // 3)
    # several components share each vocabulary word (synonym collisions —
    # the regime where text fusion and one-hot genuinely differ)
    vocab_of = rng.integers(0, n_vocab, k)
    per_image = []
    for z in truth:
        labels = [Label(f"word{vocab_of[z]}", 80.0 + float(rng.random()) * 15)]
        if rng.random() < noise:
            labels.append(Label(f"word{rng.integers(0, n_vocab)}",
                                55.0 + float(rng.random()) * 20))
        per_image.append(labels)
    label_set = {}
    for labels in per_image:
        for lab in labels:
            label_set.setdefault(lab.name, len(label_set))
    return per_image, label_set


def fusion_scoreboard(n: int, d: int, *, sep: float = 1.0,
                      fusion_weight: float = 1.0, seed: int = 0,
                      device=None) -> dict:
    """``labels.fusion=text`` against the parity ``onehot`` block: the same
    images (mixture features standing in for tower embeddings), the same
    labels, the same engine; only the label block differs (the two
    branches of ``Pipeline._label_block``). The text tower is the seeded
    full-width CLIP text tower on ``device``; each block is concatenated
    onto the features on the device."""
    from imageclust_tpu_torch.labels.onehot import one_hot_matrix
    from imageclust_tpu_torch.labels.text_fusion import text_label_matrix
    from imageclust_tpu_torch.models.text import TextEncoder

    feats, truth = synth_mixture(n, d, sep=sep, seed=seed, device=device)
    dev = feats.device
    per_image, label_set = synth_mixture_labels(truth, seed=seed)

    onehot = one_hot_matrix(per_image, label_set) * np.float32(fusion_weight)
    text = text_label_matrix(per_image, label_set,
                             TextEncoder(device=dev)) \
        * np.float32(fusion_weight)

    def joint(block):
        return torch.cat([feats, torch.from_numpy(block).to(dev)], dim=1)

    base = _bucketed(joint(onehot), "float32", seed=seed, device=dev)
    got = _bucketed(joint(text), "float32", seed=seed, device=dev)
    row = agreement(base, got)
    row["ari_vs_truth_onehot"] = agreement(base, truth)["ari"]
    row["ari_vs_truth_text"] = agreement(got, truth)["ari"]
    return row


def _ptq_ids(n_base: int, bs: int, seed: int, i: int, dev):
    """Chunk ``i``'s base-pattern ids and the generator that goes on to
    draw its noise: seeded per chunk, so the ids replay without the
    images."""
    gen = _generator(dev, seed * 1_000_003 + i + 1)
    return torch.randint(0, n_base, (bs,), generator=gen, device=dev), gen


def ptq_scoreboard(model: str, n: int, *, n_base: int = 64,
                   batch_size: int = 0, seed: int = 0,
                   bucket_size: int = 256, device=None) -> dict:
    """``embed.quantize=int8`` end to end: the SAME synthetic images through
    the bf16 tower and its PTQ int8 twin (both from the same seeded init),
    both embedding sets clustered by the f32 parity engine, partitions
    compared. Images are ``n_base`` noisy base patterns plus per-item
    uniform noise. Includes the f32 k-means-seed yardstick row under
    ``"seed_yardstick"`` and each partition's ARI against the base-pattern
    ids (replayed from the per-chunk generators)."""
    from imageclust_tpu_torch.config import EmbedConfig
    from imageclust_tpu_torch.models import registry

    dev = resolve_device(device)

    def embed_all(quantize: str):
        emb = registry.create_embedder(EmbedConfig(
            model=model, batch_size=batch_size, quantize=quantize),
            device=dev)
        bs, s = emb.batch_size, emb.spec.input_size
        base = torch.randint(0, 200, (n_base, s, s, 3),
                             generator=_generator(dev, seed), device=dev,
                             dtype=torch.int16)

        def chunks():
            for i in range(-(-n // bs)):
                z, gen = _ptq_ids(n_base, bs, seed, i, dev)
                noise = torch.randint(0, 56, (bs, s, s, 3), generator=gen,
                                      device=dev, dtype=torch.int16)
                yield (base[z] + noise).to(torch.uint8)[:n - i * bs]

        return emb.embed_stream(chunks(), total=n), bs

    f32, bs = embed_all("")
    q8, _ = embed_all("int8")
    kw = dict(bucket_size=bucket_size, device=dev)
    base_part = _bucketed(f32, "float32", seed=seed, **kw)
    q8_part = _bucketed(q8, "float32", seed=seed, **kw)
    row = agreement(base_part, q8_part)
    alt = _bucketed(f32, "float32", seed=seed + 1, **kw)
    row["seed_yardstick"] = agreement(base_part, alt)
    # truth-recovery context: whether int8 LOSES structure is a different
    # question from whether it agrees pair for pair with the bf16 partition
    # (at random init the margin between the two is all noise)
    truth = torch.cat([_ptq_ids(n_base, bs, seed, i, dev)[0]
                       for i in range(-(-n // bs))])[:n]
    truth = truth.cpu().numpy().astype(np.int64)
    row["ari_vs_truth_f32"] = agreement(base_part, truth)["ari"]
    row["ari_vs_truth_int8"] = agreement(q8_part, truth)["ari"]
    return row
