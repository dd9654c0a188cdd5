"""Flax tower variables -> the port's ``state_dict`` (ResNet50 and the
ViT/SigLIP towers).

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

The ViT towers (:func:`vit_state_dict_from_flax`) use the same kernel and
LayerNorm rules; ``class_token``, ``pos_embed`` and the attention-pooling
head's ``head/probe`` carry over as they are.
The text tower (:func:`text_state_dict_from_flax`) adds the token table:
Embed ``embedding`` (vocab, width) -> ``weight`` as it is.

:func:`resnet50_flax_from_state_dict` is the inverse for ResNet50: the
port's weights as the Flax tree (numpy), which is what checkpoints hold, so
a checkpoint from either package loads into either.

The int8 towers' qparams trees (JAX ``quantize_resnet50`` /
``quantize_vit`` output, :func:`quant_resnet50_state_dict_from_jax`,
:func:`quant_vit_state_dict_from_jax`) add the quantized leaves: an int8
``kernel_q`` HWIO -> OHWI (conv) or (in, out) -> (out, in) (Dense), with
``w_scale``, ``bias`` and the scalar ``act_scale`` as they are.

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
    _set_path,
)
from imageclust_tpu_torch.models.vit import ViTConfig, VisionTransformer

__all__ = ["resnet50_state_dict_from_flax", "resnet50_flax_from_state_dict",
           "flax_params_from_named", "named_from_flax_params",
           "vit_state_dict_from_flax",
           "text_state_dict_from_flax", "quant_resnet50_state_dict_from_jax",
           "quant_vit_state_dict_from_jax"]

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
    if not scope and leaf in ("class_token", "pos_embed"):  # ViT tables
        return leaf, arr
    mod = ".".join(scope)
    if leaf == "probe":  # the attention-pooling head's query
        return f"{mod}.probe", arr
    if leaf == "kernel":
        if arr.ndim == 4:  # HWIO -> OIHW
            return f"{mod}.weight", np.transpose(arr, (3, 2, 0, 1))
        if arr.ndim == 2:  # Dense (in, out) -> (out, in)
            return f"{mod}.weight", arr.T
        raise ValueError(f"params/{'/'.join(path)}: kernel of rank {arr.ndim}")
    if leaf == "kernel_q":
        if arr.ndim == 4:  # HWIO -> OHWI
            return f"{mod}.kernel_q", np.transpose(arr, (3, 0, 1, 2))
        if arr.ndim == 2:  # Dense (in, out) -> (out, in)
            return f"{mod}.kernel_q", arr.T
        raise ValueError(f"params/{'/'.join(path)}: kernel_q of rank "
                         f"{arr.ndim}")
    if leaf in ("bias", "w_scale", "act_scale"):
        return f"{mod}.{leaf}", arr
    if leaf in ("scale", "embedding"):
        return f"{mod}.weight", arr
    raise ValueError(f"params/{'/'.join(path)}: unknown leaf {leaf!r}")


def _map_params(params: Mapping) -> tuple[dict[str, np.ndarray], list[str]]:
    got: dict[str, np.ndarray] = {}
    problems: list[str] = []
    for path, arr in _walk(params):
        try:
            key, val = _map_param(path, arr)
        except ValueError as exc:
            problems.append(str(exc))
            continue
        got[key] = val
    return got, problems


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

    got, problems = _map_params(params)
    for path, arr in _walk(stats):
        *scope, leaf = path
        if leaf not in _STATS:
            problems.append(f"batch_stats/{'/'.join(path)}: unknown leaf")
            continue
        got[".".join(scope) + "." + _STATS[leaf]] = arr

    with torch.device("meta"):
        ref = ResNet50V1(num_classes=num_classes, dtype="float32",
                         stage_layers=stage_layers, fold_bn=fold_bn)
    return _checked(got, ref, problems)


def _flax_leaf(name: str, arr: np.ndarray) -> tuple[str, list[str],
                                                     np.ndarray]:
    """(collection, Flax path, array in Flax layout) of one ResNet50
    ``state_dict`` entry: the inverse of :func:`_map_param` and the
    BatchNorm statistics rule."""
    *scope, leaf = name.split(".")
    if leaf == "running_mean":
        return "batch_stats", scope + ["mean"], arr
    if leaf == "running_var":
        return "batch_stats", scope + ["var"], arr
    if leaf == "weight":
        if arr.ndim == 4:  # OIHW -> HWIO
            return "params", scope + ["kernel"], np.transpose(arr,
                                                              (2, 3, 1, 0))
        if arr.ndim == 2:  # Dense (out, in) -> (in, out)
            return "params", scope + ["kernel"], arr.T
        return "params", scope + ["scale"], arr  # BatchNorm
    if leaf == "bias":
        return "params", scope + ["bias"], arr
    raise ValueError(f"{name}: unknown ResNet50 state_dict entry")


def flax_params_from_named(named: Mapping[str, torch.Tensor]) -> dict:
    """A ``{name: tensor}`` map over the parameters of a ResNet50 (its
    weights, gradients, or AdamW moments) as the Flax ``params`` tree of
    float32 numpy arrays in Flax layout."""
    params: dict = {}
    for name, t in named.items():
        coll, path, arr = _flax_leaf(
            name, t.detach().to("cpu", torch.float32).numpy())
        if coll != "params":
            raise ValueError(f"{name}: not a parameter")
        _set_path(params, tuple(path), np.ascontiguousarray(arr))
    return params


def named_from_flax_params(params: Mapping,
                           shapes: Mapping[str, tuple]) -> dict:
    """The inverse of :func:`flax_params_from_named`: a Flax ``params``
    tree as ``{name: array}`` in torch layout, held against ``shapes``
    (each parameter's torch shape). Raises ValueError on any missing,
    extra or mis-shaped entry."""
    got, problems = _map_params(params)
    for k, shape in shapes.items():
        if k not in got:
            problems.append(f"{k}: missing")
        elif tuple(got[k].shape) != tuple(shape):
            problems.append(f"{k}: shape {tuple(got[k].shape)} != "
                            f"expected {tuple(shape)}")
    problems += [f"{k}: unexpected" for k in got if k not in shapes]
    if problems:
        raise ValueError(
            "Flax->torch conversion failed:\n  " + "\n  ".join(problems[:40]))
    return got


def resnet50_flax_from_state_dict(model: torch.nn.Module) -> dict:
    """The inverse of :func:`resnet50_state_dict_from_flax`: ``model``'s
    weights (a :class:`~.resnet50.ResNet50V1`, either layout) as the Flax
    tree ``{"params", "batch_stats"}`` (no ``batch_stats`` when folded) of
    float32 numpy arrays, with Flax's scope names and layouts (HWIO conv
    kernels, (in, out) Dense). Both layout changes are transposes, so the
    values keep their bits."""
    tree: dict = {"params": {}, "batch_stats": {}}
    for name, t in model.state_dict().items():
        coll, path, arr = _flax_leaf(
            name, t.detach().to("cpu", torch.float32).numpy())
        _set_path(tree[coll], tuple(path), np.ascontiguousarray(arr))
    if not tree["batch_stats"]:
        del tree["batch_stats"]
    return tree


def vit_state_dict_from_flax(variables: Mapping,
                             cfg: ViTConfig) -> dict[str, torch.Tensor]:
    """Convert Flax ``VisionTransformer`` variables (``{"params": ...}``)
    for ``cfg`` into a :class:`~.vit.VisionTransformer` state_dict: conv
    HWIO -> OIHW, Dense (in, out) -> (out, in), LayerNorm ``scale`` ->
    ``weight``, ``class_token``, ``pos_embed`` and ``head/probe``
    unchanged. Raises ValueError on any missing, extra or mis-shaped
    tensor."""
    got, problems = _map_params(variables["params"])
    with torch.device("meta"):
        ref = VisionTransformer(cfg)
    return _checked(got, ref, problems)


def text_state_dict_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """Convert Flax ``TextTransformer`` variables (``{"params": ...}``) into
    a :class:`~.text.TextTransformer` state_dict: the token table as it is,
    Dense (in, out) -> (out, in), LayerNorm ``scale`` -> ``weight``,
    ``pos_embed`` unchanged. The dims come from the tree itself (vocab and
    width from the token table, context from ``pos_embed``, depth from the
    blocks, proj_dim from the projection). Raises ValueError on any
    missing, extra or mis-shaped tensor."""
    from imageclust_tpu_torch.models.text import TextConfig, TextTransformer

    params = variables["params"]
    got, problems = _map_params(params)
    try:
        vocab, width = np.asarray(params["token_embed"]["embedding"]).shape
        cfg = TextConfig(
            vocab=int(vocab), width=int(width),
            depth=sum(1 for k in params if k.startswith("block")),
            heads=1,  # no tensor's shape depends on the head count
            proj_dim=int(np.asarray(
                params["projection"]["kernel"]).shape[1]),
            context=int(np.asarray(params["pos_embed"]).shape[1]))
    except (KeyError, ValueError) as exc:
        raise ValueError(f"Flax->torch conversion failed: not a text tower "
                         f"tree ({exc!r})") from exc
    with torch.device("meta"):
        ref = TextTransformer(cfg)
    return _checked(got, ref, problems)


def quant_resnet50_state_dict_from_jax(
        qparams: Mapping) -> dict[str, torch.Tensor]:
    """Convert the JAX package's int8 ResNet50 qparams (``quantize_resnet50``
    output, as numpy) into a :class:`~.quantize.QuantResNet50` state_dict:
    the float stem and head as in :func:`resnet50_state_dict_from_flax`,
    each body conv's ``kernel_q`` HWIO -> OHWI with its ``w_scale``,
    ``bias`` and ``act_scale``. Raises ValueError on any missing, extra or
    mis-shaped tensor, or a float where an int8 kernel belongs."""
    from imageclust_tpu_torch.models.quantize import QuantResNet50

    got, problems = _map_params(qparams)
    num_classes = int(np.asarray(qparams["dense0"]["bias"]).shape[0])
    with torch.device("meta"):
        ref = QuantResNet50(num_classes, _stage_layers(qparams))
    return _checked(got, ref, problems)


def quant_vit_state_dict_from_jax(qparams: Mapping,
                                  cfg: ViTConfig) -> dict[str, torch.Tensor]:
    """Convert the JAX package's int8 ViT qparams (``quantize_vit`` output,
    as numpy) for ``cfg`` into a :class:`~.quantize_vit.QuantViT`
    state_dict: the float parts as in :func:`vit_state_dict_from_flax`,
    each encoder Dense's ``kernel_q`` (in, out) -> (out, in) with its
    ``w_scale``, ``bias`` and ``act_scale``. Raises ValueError as the other
    converters do."""
    from imageclust_tpu_torch.models.quantize_vit import QuantViT

    got, problems = _map_params(qparams)
    with torch.device("meta"):
        ref = QuantViT(cfg)
    return _checked(got, ref, problems)


def _checked(got: dict, ref: torch.nn.Module,
             problems: list[str]) -> dict[str, torch.Tensor]:
    want = {k: (tuple(v.shape), v.dtype) for k, v in ref.state_dict().items()}
    for k, (shape, dtype) in want.items():
        if k not in got:
            problems.append(f"{k}: missing")
        elif tuple(got[k].shape) != shape:
            problems.append(
                f"{k}: shape {tuple(got[k].shape)} != expected {shape}")
        elif (dtype == torch.int8) != (got[k].dtype == np.int8):
            problems.append(f"{k}: dtype {got[k].dtype} != expected {dtype}")
    for k in got:
        if k not in want:
            problems.append(f"{k}: unexpected")
    if problems:
        raise ValueError(
            "Flax->torch conversion failed:\n  " + "\n  ".join(problems[:40]))
    return {k: torch.tensor(np.asarray(
        v, np.int8 if want[k][1] == torch.int8 else np.float32))
        for k, v in got.items()}
