"""resnet50-v1-7's initializers (Gluon names) as the program's variables."""

from __future__ import annotations

import numpy as np

from benchmark.reference.resnet50_v1 import PREFIX, STAGES


def to_program(weights: dict) -> dict:
    w = {k: v.detach().cpu().numpy() for k, v in weights.items()}
    params: dict = {}
    stats: dict = {}

    def conv(onnx: str, scope: dict, name: str) -> None:
        scope.setdefault(name, {})["kernel"] = np.transpose(
            w[f"{onnx}_weight"], (2, 3, 1, 0))

    def bnorm(onnx: str, pscope: dict, sscope: dict, name: str) -> None:
        pscope[name] = {"scale": w[f"{onnx}_gamma"],
                        "bias": w[f"{onnx}_beta"]}
        sscope[name] = {"mean": w[f"{onnx}_running_mean"],
                        "var": w[f"{onnx}_running_var"]}

    conv(f"{PREFIX}_conv0", params, "conv0")
    bnorm(f"{PREFIX}_batchnorm0", params, stats, "bn0")
    for si, (blocks, _width) in enumerate(STAGES, 1):
        k = 0
        for b in range(blocks):
            blk = f"stage{si}_block{b}"
            pb, sb = params.setdefault(blk, {}), stats.setdefault(blk, {})
            names = ["0", "1", "2"] + (["_proj"] if b == 0 else [])
            for n in names:
                conv(f"{PREFIX}_stage{si}_conv{k}", pb, f"conv{n}")
                bnorm(f"{PREFIX}_stage{si}_batchnorm{k}", pb, sb, f"bn{n}")
                k += 1
    params["dense0"] = {"kernel": w[f"{PREFIX}_dense0_weight"].T,
                        "bias": w[f"{PREFIX}_dense0_bias"]}
    return {"params": params, "batch_stats": stats}
