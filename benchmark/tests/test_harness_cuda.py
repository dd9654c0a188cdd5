"""On the card (marker ``cuda``): one sound job and one control job of
each cell at its own size. Skips without a card.

    python -m pytest -p no:cacheprovider benchmark/tests/test_harness_cuda.py
"""

from __future__ import annotations

import pytest
import torch

from benchmark import control
from benchmark.manifest import Manifest

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    from imageclust_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.parametrize("cell", ["rn50.stream_20k",
                                  "vitb32.stream_10k_coarse"])
def test_cell_sound_and_control(cuda, cell):
    m = Manifest()
    sound = control.reading(m, cell, 2 ** 31 + 17, "sound", cuda)
    assert sound["correct"], sound
    ctl = control.reading(m, cell, 2 ** 31 + 18, "control", cuda)
    assert not ctl["correct"], ctl
