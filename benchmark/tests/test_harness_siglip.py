"""The SigLIP So400m/14@384 configuration's harness parts on the CPU: the
FLOPs per image worked out from the published shapes equal what
``FlopCounterMode`` counts on the plain reference (on the meta device, at
the published widths), the adapter's variables load through
``create_embedder(variables=...)`` and match the reference at a tiny size,
and the two readers of the new per-layer metrics on a hand-made run."""

from __future__ import annotations

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import weights
from benchmark.adapters import siglip_vit as adapter
from benchmark.manifest import Manifest
from benchmark.metrics import attn_long_roofline, tower_mfu
from benchmark.peaks import FLOPS_PER_S, HBM_BYTES_PER_S
from benchmark.record import JobRecord, RunRecord
from benchmark.reference import siglip_vit
from benchmark.trace import TraceSummary

CONFIG = "siglip-so400m-patch14-384"
CELL = "siglip384.stream_5k"


def _published():
    return siglip_vit.shape_of(Manifest().config(CONFIG)["model"])


def test_published_sizes():
    s = _published()
    assert (s.tokens, s.head_dim) == (729, 72)
    assert sum(math.prod(shape) for _, shape, _ in
               siglip_vit.initializers(s)) == 428_225_600
    assert siglip_vit.flops_per_image(s) == 670_346_449_920


def test_flops_match_counter():
    s = _published()
    w = {name: torch.empty(shape, device="meta")
         for name, shape, _ in siglip_vit.initializers(s)}
    x = torch.empty(1, 3, s.image_size, s.image_size, device="meta")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        out = siglip_vit.forward(w, s, x)
    assert out.shape == (1, s.hidden_size)
    assert counter.get_total_flops() == siglip_vit.flops_per_image(s)


def test_adapter_loads_into_the_port(monkeypatch):
    """A tiny tower of the configuration's kind (head dim 12, 46 px so the
    patch leaves a remainder, MLP 88 wide): the seeded published-layout
    weights through the adapter and ``create_embedder(variables=...)``
    give the reference's embeddings in float32."""
    from imageclust_tpu_torch.config import EmbedConfig
    from imageclust_tpu_torch.models import create_embedder, vit

    torch.set_num_threads(min(4, torch.get_num_threads()))
    s = siglip_vit.Shape(image_size=46, patch_size=6, hidden_size=48,
                         intermediate_size=88, num_hidden_layers=2,
                         num_attention_heads=4)
    name = "siglip_so400m_384"
    monkeypatch.setitem(vit.VIT_CONFIGS, name, vit.ViTConfig(
        **dict(vit.VIT_CONFIGS[name].__dict__, patch=6, width=48, depth=2,
               heads=4, proj_dim=48, image_size=46, mlp_dim=88)))
    w = weights.make(siglip_vit.initializers(s), 2 ** 31 + 5, "cpu")
    emb = create_embedder(
        EmbedConfig(model=name, dtype="float32", norm_dtype="float32",
                    batch_size=8, cache=False),
        device="cpu", variables=adapter.to_program(w))
    assert emb.spec.dim == 48
    images = torch.randint(0, 256, (5, 46, 46, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(3))
    got = torch.from_numpy(emb.embed(images.numpy()))
    want = siglip_vit.embed(w, s, images)
    rel = (got - want).norm(dim=1) / want.norm(dim=1)
    assert float(rel.max()) < 1e-5


def _run(trace: TraceSummary | None, config: str, images: int) -> RunRecord:
    m = Manifest()
    cfg = m.config(config)
    run = RunRecord(cell={}, config=cfg, traffic={}, seed=0, seconds=1.0,
                    flops_per_image=1_000_000_000)
    run.jobs = [JobRecord(images, 1.0, {}, {})]
    run.trace = trace
    return run


def test_readers_on_a_hand_made_run():
    t = TraceSummary(jobs=1, window_s=2.0, busy_s=1.0,
                     stage_device_s={"embed": 0.5, "name": 0.1},
                     op_s={"cudnn_generated_fort_native_sdpa_sm90_flash_"
                           "fprop_wgmma_f16_knob_7": 0.02, "gemm": 0.3},
                     op_count={"cudnn_generated_fort_native_sdpa_sm90_"
                               "flash_fprop_wgmma_f16_knob_7": 10,
                               "gemm": 40})
    run = _run(t, CONFIG, 5000)
    b, tok, d = 128, 729, 1152
    least = max(4 * b * tok ** 2 * d / FLOPS_PER_S["bfloat16"],
                4 * b * tok * d * 2 / HBM_BYTES_PER_S)
    assert attn_long_roofline.read(run) == pytest.approx(
        100 * least / 0.002)
    assert tower_mfu.read(run) == pytest.approx(
        100 * 5000 * 1e9 / 0.5 / FLOPS_PER_S["bfloat16"])
    # the ResNet50 cell: no such kernel, the embed stage's share all the same
    rn = _run(t, "resnet50-v1-7", 20000)
    rn.trace = TraceSummary(jobs=1, stage_device_s={"embed": 0.5})
    assert attn_long_roofline.read(rn) is None
    assert tower_mfu.read(rn) == pytest.approx(
        100 * 20000 * 1e9 / 0.5 / FLOPS_PER_S["bfloat16"])


def test_readers_without_a_trace():
    run = _run(None, CONFIG, 5000)
    assert attn_long_roofline.read(run) is None
    assert tower_mfu.read(run) is None
    run.trace = TraceSummary(jobs=1)
    assert attn_long_roofline.read(run) is None
    assert tower_mfu.read(run) is None


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [CELL, "rn50.stream_20k_coarse"])
def test_cell_sound_and_control_on_card(cell):
    """On the card: one sound job of the cell is correct, one job of the
    int8 control is not."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    from benchmark import control
    from imageclust_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    m = Manifest()
    sound = control.reading(m, cell, 2 ** 31 + 17, "sound", dev)
    assert sound["correct"], sound
    ctl = control.reading(m, cell, 2 ** 31 + 18, "control", dev)
    assert not ctl["correct"], ctl
