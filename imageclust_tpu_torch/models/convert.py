"""Flax ResNet50 variables -> the port's ``state_dict``.

The JAX package's weights are a nested dict tree
``{"params": ..., "batch_stats": ...}`` (what
``jax.tree.map(np.asarray, embedder.variables)`` gives), either the plain
layout (conv kernels + BatchNorm scale/bias/mean/var) or the folded one
(``fold_bn_variables``: convs with a bias, no BatchNorm, no batch_stats).
This module maps either onto :class:`~.resnet50.ResNet50V1` by name:

* conv ``kernel`` HWIO -> ``weight`` OIHW,
* Dense ``kernel`` (in, out) -> ``weight`` (out, in),
* BatchNorm ``scale``/``bias`` -> ``weight``/``bias``, ``mean``/``var`` ->
  ``running_mean``/``running_var``,
* conv ``bias`` (folded layout) -> ``bias``.

Any missing, unexpected or mis-shaped tensor raises ValueError with the
full list, like the JAX package's ``_shape_diff``.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from imageclust_tpu_torch.models.resnet50 import (
    GLUON_STAGE_LAYERS,
    ResNet50V1,
)

__all__ = ["resnet50_state_dict_from_flax"]

_BN = {"scale": "weight", "bias": "bias"}
_STATS = {"mean": "running_mean", "var": "running_var"}


def _walk(tree: Mapping, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _map_param(path: tuple, arr: np.ndarray) -> tuple[str, np.ndarray]:
    *scope, leaf = path
    mod = ".".join(scope)
    if leaf == "kernel":
        if arr.ndim == 4:  # HWIO -> OIHW
            return f"{mod}.weight", np.transpose(arr, (3, 2, 0, 1))
        if arr.ndim == 2:  # Dense (in, out) -> (out, in)
            return f"{mod}.weight", arr.T
        raise ValueError(f"params/{'/'.join(path)}: kernel of rank {arr.ndim}")
    if leaf == "bias":
        return f"{mod}.bias", arr
    if leaf == "scale":
        return f"{mod}.weight", arr
    raise ValueError(f"params/{'/'.join(path)}: unknown leaf {leaf!r}")


def _stage_layers(params: Mapping) -> tuple[int, ...]:
    counts = [0, 0, 0, 0]
    for name in params:
        if name.startswith("stage") and "_block" in name:
            s = int(name[5:name.index("_")]) - 1
            counts[s] = max(counts[s], int(name.rsplit("block", 1)[1]) + 1)
    return tuple(counts) if any(counts) else GLUON_STAGE_LAYERS


def resnet50_state_dict_from_flax(
    variables: Mapping,
    *,
    stage_layers: Sequence[int] | None = None,
    num_classes: int | None = None,
    fold_bn: bool | None = None,
) -> dict[str, torch.Tensor]:
    """Convert Flax ResNet50 variables into a ``ResNet50V1`` state_dict.

    ``fold_bn`` defaults to the layout found (no ``batch_stats`` = folded),
    ``stage_layers`` to the blocks found per stage and ``num_classes`` to
    the width of ``dense0``. Raises ValueError
    on any missing, extra or mis-shaped tensor."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    if fold_bn is None:
        fold_bn = not stats
    if stage_layers is None:
        stage_layers = _stage_layers(params)
    if num_classes is None:
        num_classes = int(np.asarray(params["dense0"]["bias"]).shape[0])

    got: dict[str, np.ndarray] = {}
    problems: list[str] = []
    for path, arr in _walk(params):
        try:
            key, val = _map_param(path, arr)
        except ValueError as exc:
            problems.append(str(exc))
            continue
        got[key] = val
    for path, arr in _walk(stats):
        *scope, leaf = path
        if leaf not in _STATS:
            problems.append(f"batch_stats/{'/'.join(path)}: unknown leaf")
            continue
        got[".".join(scope) + "." + _STATS[leaf]] = arr

    with torch.device("meta"):
        ref = ResNet50V1(num_classes=num_classes, dtype="float32",
                         stage_layers=stage_layers, fold_bn=fold_bn)
    want = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    for k, shape in want.items():
        if k not in got:
            problems.append(f"{k}: missing")
        elif tuple(got[k].shape) != shape:
            problems.append(
                f"{k}: shape {tuple(got[k].shape)} != expected {shape}")
    for k in got:
        if k not in want:
            problems.append(f"{k}: unexpected")
    if problems:
        raise ValueError(
            "Flax->torch conversion failed:\n  " + "\n  ".join(problems[:40]))
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in got.items()}
