"""Export the port's ResNet50-v1 to ONNX (gluon-style graph), the
counterpart of ``imageclust_tpu/models/onnx_export.py``.

A tower built or loaded by the port can be handed back to any ONNX
consumer, the reference's own runtime included (OpenCV DNN,
internal/embeddings/embeddings.go:28-43). The graph replicates the
MXNet-gluon export structure of resnet50-v1-7.onnx: node and initializer
names use the ``resnetv17_*`` scheme (stage-scoped conv/batchnorm counters,
body convs before the projection conv), so
:func:`imageclust_tpu_torch.models.resnet50.load_onnx_params` round-trips
it. The port's conv weights are OIHW and its dense weight (out, in), which
is ONNX's layout already: for the same float32 weights the file is byte
for byte the JAX exporter's.
"""

from __future__ import annotations

import numpy as np
import torch

from imageclust_tpu_torch.models.onnx_io import write_onnx_model
from imageclust_tpu_torch.models.resnet50 import ResNet50V1

__all__ = ["export_resnet50_onnx"]


class _GraphBuilder:
    """Nodes and initializers of the gluon graph, fed from a ``state_dict``
    of float32 numpy arrays in torch's layout."""

    def __init__(self, sd: dict[str, np.ndarray]):
        self.sd = sd
        self.nodes: list[dict] = []
        self.inits: dict[str, np.ndarray] = {}

    def conv(self, name: str, x: str, key: str, stride: int,
             pad: int) -> str:
        w = self.sd[f"{key}.weight"]  # OIHW, ONNX's layout
        self.inits[f"{name}_weight"] = w
        out = f"{name}_fwd"
        self.nodes.append({
            "op_type": "Conv", "name": name,
            "inputs": [x, f"{name}_weight"], "outputs": [out],
            "attrs": {
                "kernel_shape": [w.shape[2], w.shape[3]],
                "strides": [stride, stride],
                "pads": [pad, pad, pad, pad],
                "dilations": [1, 1],
                "group": 1,
            },
        })
        return out

    def bn(self, name: str, x: str, key: str) -> str:
        self.inits[f"{name}_gamma"] = self.sd[f"{key}.weight"]
        self.inits[f"{name}_beta"] = self.sd[f"{key}.bias"]
        self.inits[f"{name}_running_mean"] = self.sd[f"{key}.running_mean"]
        self.inits[f"{name}_running_var"] = self.sd[f"{key}.running_var"]
        out = f"{name}_fwd"
        self.nodes.append({
            "op_type": "BatchNormalization", "name": name,
            "inputs": [x, f"{name}_gamma", f"{name}_beta",
                       f"{name}_running_mean", f"{name}_running_var"],
            "outputs": [out],
            "attrs": {"epsilon": 1e-5, "momentum": 0.9},
        })
        return out

    def relu(self, name: str, x: str) -> str:
        out = f"{name}_fwd"
        self.nodes.append({"op_type": "Relu", "name": name, "inputs": [x],
                           "outputs": [out], "attrs": {}})
        return out

    def maxpool(self, name: str, x: str) -> str:
        out = f"{name}_fwd"
        self.nodes.append({
            "op_type": "MaxPool", "name": name, "inputs": [x],
            "outputs": [out],
            "attrs": {"kernel_shape": [3, 3], "strides": [2, 2],
                      "pads": [1, 1, 1, 1]},
        })
        return out

    def add(self, name: str, a: str, b: str) -> str:
        out = f"{name}_fwd"
        self.nodes.append({"op_type": "Add", "name": name, "inputs": [a, b],
                           "outputs": [out], "attrs": {}})
        return out

    def gap(self, name: str, x: str) -> str:
        out = f"{name}_fwd"
        self.nodes.append({"op_type": "GlobalAveragePool", "name": name,
                           "inputs": [x], "outputs": [out], "attrs": {}})
        return out

    def flatten(self, name: str, x: str) -> str:
        out = f"{name}_fwd"
        self.nodes.append({"op_type": "Flatten", "name": name, "inputs": [x],
                           "outputs": [out], "attrs": {"axis": 1}})
        return out

    def gemm(self, name: str, x: str, key: str) -> str:
        # (out, in) with transB=1, the gluon/ONNX layout
        self.inits[f"{name}_weight"] = self.sd[f"{key}.weight"]
        self.inits[f"{name}_bias"] = self.sd[f"{key}.bias"]
        out = f"{name}_fwd"
        self.nodes.append({
            "op_type": "Gemm", "name": name,
            "inputs": [x, f"{name}_weight", f"{name}_bias"],
            "outputs": [out],
            "attrs": {"alpha": 1.0, "beta": 1.0, "transB": 1},
        })
        return out


def export_resnet50_onnx(model: ResNet50V1, path: str,
                         input_size: int = 224) -> None:
    """Write ``model`` (an unfolded :class:`ResNet50V1`: the float32
    weights and BatchNorm statistics it holds, whatever its compute dtype)
    as a gluon-named ONNX model whose final node is
    ``resnetv17_dense0_fwd`` (embeddings.go:140)."""
    if model.fold_bn:
        raise ValueError("export needs the unfolded tower (BatchNorm "
                         "statistics are part of the gluon graph)")
    sd = {k: v.detach().to("cpu", torch.float32).numpy()
          for k, v in model.state_dict().items()}
    g = _GraphBuilder(sd)

    x = g.conv("resnetv17_conv0", "data", "conv0", 2, 3)
    x = g.bn("resnetv17_batchnorm0", x, "bn0")
    x = g.relu("resnetv17_relu0", x)
    x = g.maxpool("resnetv17_pool0", x)

    for si, n_blocks in enumerate(model.stage_layers):
        stage = f"resnetv17_stage{si + 1}"
        k = 0
        r = 0
        for bi in range(n_blocks):
            blk = f"stage{si + 1}_block{bi}"
            stride = (1 if si == 0 else 2) if bi == 0 else 1
            shortcut = x
            y = g.conv(f"{stage}_conv{k}", x, f"{blk}.conv0", stride, 0)
            y = g.bn(f"{stage}_batchnorm{k}", y, f"{blk}.bn0")
            k += 1
            y = g.relu(f"{stage}_activation{r}", y)
            r += 1
            y = g.conv(f"{stage}_conv{k}", y, f"{blk}.conv1", 1, 1)
            y = g.bn(f"{stage}_batchnorm{k}", y, f"{blk}.bn1")
            k += 1
            y = g.relu(f"{stage}_activation{r}", y)
            r += 1
            y = g.conv(f"{stage}_conv{k}", y, f"{blk}.conv2", 1, 0)
            y = g.bn(f"{stage}_batchnorm{k}", y, f"{blk}.bn2")
            k += 1
            if bi == 0:
                shortcut = g.conv(f"{stage}_conv{k}", x, f"{blk}.conv_proj",
                                  stride, 0)
                shortcut = g.bn(f"{stage}_batchnorm{k}", shortcut,
                                f"{blk}.bn_proj")
                k += 1
            x = g.add(f"{stage}_add{bi}", y, shortcut)
            x = g.relu(f"{stage}_activation{r}", x)
            r += 1

    x = g.gap("resnetv17_pool1", x)
    x = g.flatten("resnetv17_flatten0", x)
    x = g.gemm("resnetv17_dense0", x, "dense0")

    write_onnx_model(
        path,
        nodes=g.nodes,
        initializers=g.inits,
        inputs={"data": (1, 3, input_size, input_size)},
        outputs={x: (1, model.num_classes)},
    )
