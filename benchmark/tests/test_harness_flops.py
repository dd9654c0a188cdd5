"""The towers' FLOPs per image, worked out from the published shapes,
equal what ``FlopCounterMode`` counts on the plain reference at the
published widths."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import weights
from benchmark.manifest import Manifest
from benchmark.reference import clip_vit, resnet50_v1

FAMILIES = {"resnet50_v1": resnet50_v1, "clip_vit": clip_vit}


@pytest.mark.parametrize("config", ["resnet50-v1-7", "clip-vit-b32"])
def test_flops_match_counter(config):
    cfg = Manifest().config(config)
    fam = FAMILIES[cfg["reference"]]
    shape = fam.shape_of(cfg["model"])
    w = weights.make(fam.initializers(shape), 7, "cpu")
    x = torch.zeros(1, 3, shape.image_size, shape.image_size)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fam.forward(w, shape, x)
    assert counter.get_total_flops() == fam.flops_per_image(shape)


def test_published_sizes():
    rn = resnet50_v1.Shape(224, 1000)
    vit = clip_vit.shape_of(Manifest().config("clip-vit-b32")["model"])
    params = {f: sum(torch.Size(s).numel() for _, s, _ in
                     fam.initializers(sh))
              for f, fam, sh in (("rn", resnet50_v1, rn),
                                 ("vit", clip_vit, vit))}
    assert params == {"rn": 25_610_152, "vit": 87_849_216}
    assert resnet50_v1.flops_per_image(rn) == 7_715_946_496
    assert clip_vit.flops_per_image(vit) == 8_817_623_040
