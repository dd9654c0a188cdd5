"""Embedder fine-tuning on PyTorch: labeled image folders -> a tuned
ResNet50 (JAX ``models/finetune.py:29-146``).

Data comes from a directory of ``<label>/`` subfolders; the classifier
head is sized to the label count; the tower trains in bfloat16 through
:func:`~.train.make_train_step`. The train state (weights, AdamW state and
the epoch) is saved after every epoch at ``<out_path>_state`` so an
interrupted run resumes where it stopped, and the tuned weights at
``out_path``, both as Orbax checkpoints in the Flax layout
(:mod:`imageclust_tpu_torch.utils.orbax_io`): either package reads,
resumes and serves (``embed.checkpoint_path``) what the other wrote.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from imageclust_tpu_torch.data.loader import load_image_dir
from imageclust_tpu_torch.device import resolve_device
from imageclust_tpu_torch.ops.preprocess import preprocess_batch

log = logging.getLogger(__name__)

__all__ = ["load_labeled_dir", "finetune_resnet50"]


def load_labeled_dir(root: str, size: int = 224):
    """(images u8 BGR (N,size,size,3), labels (N,), class_names)."""
    classes = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    )
    if not classes:
        raise ValueError(f"no class subdirectories under {root}")
    images, labels = [], []
    for ci, cname in enumerate(classes):
        _, batch = load_image_dir(os.path.join(root, cname), size=size)
        images.append(batch)
        labels.extend([ci] * len(batch))
    return np.concatenate(images), np.asarray(labels, np.int32), classes


def _state_tree(model, opt_state, epoch: int) -> dict:
    from imageclust_tpu_torch.models.convert import (
        resnet50_flax_from_state_dict,
    )
    from imageclust_tpu_torch.models.train import opt_state_to_flax

    return {"variables": resnet50_flax_from_state_dict(model),
            "opt_state": opt_state_to_flax(opt_state),
            "epoch": np.asarray(epoch, np.int64)}


def finetune_resnet50(
    data_dir: str,
    out_path: str,
    epochs: int = 3,
    batch_size: int = 64,
    learning_rate: float = 1e-3,
    mesh=None,
    seed: int = 0,
    onnx_out: str = "",
    init_onnx: str = "",
    stage_layers=None,
    input_size: int = 224,
    resume: bool = True,
    device: str | torch.device | None = "cuda",
):
    """Fine-tune ResNet50 on labeled folders on ``device``; returns (the
    tuned model, classes, the last epoch's mean loss).

    As the JAX function: the epoch order is
    ``np.random.default_rng(seed).permutation(n)`` with the last partial
    batch dropped; a resumed run restores ``<out_path>_state`` and does not
    advance the permutation generator for the epochs it skips; the final
    weights go to ``out_path`` and ``classes.txt`` beside it, and to
    ``onnx_out`` as a gluon-named ONNX model when set. ``init_onnx``
    warm-starts the backbone from an ONNX ResNet50 and keeps the new head.
    Each epoch's log record carries ``epoch_stats`` (mean loss, steps, and
    images/s after the epoch's first step).

    ``mesh`` (a :class:`~imageclust_tpu_torch.core.mesh.Mesh`; every rank
    calls with the same arguments) trains with the sharded DP x TP step on
    the mesh's device: the batch size rounds down to a multiple of the
    ``data`` axis (at least one image a rank), the head is sharded over
    ``model``, and each checkpoint gathers the full variables and AdamW
    state, which rank 0 writes in the same layout (every rank waits for
    it). Every rank returns the whole tuned model."""
    from imageclust_tpu_torch.models.convert import (
        resnet50_flax_from_state_dict,
        resnet50_state_dict_from_flax,
    )
    from imageclust_tpu_torch.models.resnet50 import (
        GLUON_STAGE_LAYERS,
        ResNet50V1,
        load_onnx_params,
    )
    from imageclust_tpu_torch.core.mesh import check_mesh
    from imageclust_tpu_torch.models.train import (
        gather_opt_state,
        gather_variables,
        init_opt_state,
        make_train_step,
        opt_state_from_flax,
        shard_model,
        shard_opt_state,
    )
    from imageclust_tpu_torch.utils.checkpoint import (
        restore_variables,
        save_variables,
    )

    mesh = check_mesh(mesh)
    dev = mesh.device if mesh is not None else resolve_device(device)
    stage_layers = tuple(stage_layers or GLUON_STAGE_LAYERS)
    images, labels, classes = load_labeled_dir(data_dir, size=input_size)
    n = len(images)
    if n < batch_size:
        batch_size = max(1, n)
    if mesh is not None:  # JAX registry.py:95-101's rounding
        ndata = mesh.shape["data"]
        batch_size = max(ndata, batch_size // ndata * ndata)
    log.info("fine-tuning on %d images, %d classes", n, len(classes))

    model = ResNet50V1(num_classes=len(classes), dtype="bfloat16",
                       stage_layers=stage_layers).init_random(seed)
    if init_onnx and os.path.exists(init_onnx):
        # warm-start the backbone from the ONNX file; the head stays the
        # fresh one at the new class count
        full = ResNet50V1(dtype="bfloat16", stage_layers=stage_layers)
        sd = load_onnx_params(init_onnx, full)
        head = model.state_dict()
        sd["dense0.weight"] = head["dense0.weight"]
        sd["dense0.bias"] = head["dense0.bias"]
        model.load_state_dict(sd)
    model.to(dev)
    opt_state = init_opt_state(model)
    rng_np = np.random.default_rng(seed)
    loss = float("nan")

    state_path = os.path.abspath(out_path) + "_state"
    start_epoch = 0
    if resume and os.path.isdir(state_path):
        restored = restore_variables(
            state_path, _state_tree(model, opt_state, 0))
        model.load_state_dict(resnet50_state_dict_from_flax(
            restored["variables"], stage_layers=stage_layers,
            num_classes=len(classes), fold_bn=False))
        opt_state = opt_state_from_flax(restored["opt_state"], model)
        start_epoch = int(restored["epoch"])
        log.info("resuming fine-tune from epoch %d", start_epoch)
    if mesh is not None:
        shard_model(model, mesh)
        opt_state = shard_opt_state(opt_state, mesh)
    step = make_train_step(model, learning_rate=learning_rate, mesh=mesh)

    def whole():
        """(the whole model, its whole AdamW state): gathered on a mesh."""
        if mesh is None:
            return model, opt_state
        full = ResNet50V1(num_classes=len(classes), dtype="bfloat16",
                          stage_layers=stage_layers)
        full.load_state_dict(gather_variables(model, mesh))
        return full, gather_opt_state(opt_state, mesh)

    def write(fn):
        """Run ``fn`` on rank 0 alone; every rank waits for it."""
        if mesh is None or mesh.rank == 0:
            fn()
        if mesh is not None and mesh.size > 1:
            import torch.distributed as dist

            dist.barrier()

    for epoch in range(start_epoch, epochs):
        order = rng_np.permutation(n)
        losses = []
        t0 = None
        for start in range(0, n - batch_size + 1, batch_size):
            idx = order[start:start + batch_size]
            blob = preprocess_batch(
                torch.from_numpy(images[idx]).to(dev), size=input_size)
            losses.append(step(model, opt_state, blob,
                               torch.from_numpy(labels[idx]).to(dev)))
            if t0 is None:  # the first step waits; time the rest
                losses[0].item()
                t0 = time.perf_counter()
        step_losses = torch.stack(losses).cpu().numpy()  # waits for the card
        seconds = time.perf_counter() - t0
        loss = float(np.mean(step_losses.astype(np.float64)))
        stats = {"epoch": epoch, "loss": loss, "steps": len(losses),
                 "images_per_s": ((len(losses) - 1) * batch_size / seconds
                                  if len(losses) > 1 else float("nan"))}
        log.info("epoch %d: mean loss %.4f, %.1f images/s", epoch, loss,
                 stats["images_per_s"], extra={"epoch_stats": stats})
        tree = _state_tree(*whole(), epoch + 1)
        write(lambda: save_variables(state_path, tree))

    model = whole()[0].to(dev)  # a mesh gathers it on the host

    def final():
        save_variables(out_path, resnet50_flax_from_state_dict(model))
        if onnx_out:
            from imageclust_tpu_torch.models.onnx_export import (
                export_resnet50_onnx,
            )

            export_resnet50_onnx(model, onnx_out, input_size=input_size)
        with open(os.path.join(
                os.path.dirname(os.path.abspath(out_path)) or ".",
                "classes.txt"), "w") as fh:
            fh.write("\n".join(classes))

    write(final)
    return model, classes, loss
