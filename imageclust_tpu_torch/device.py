"""Device selection for every entry point of the port.

``resolve_device(None)`` and ``resolve_device("cuda")`` give the CUDA
device and raise when there is none: the port never drops to the CPU on its
own. Tests and CPU runs pass ``device="cpu"`` explicitly.

The first resolution also turns TF32 off for matmuls and cuDNN
convolutions, so that float32 on the card means float32 (the JAX package
runs its Ward Gram matrix at ``Precision.HIGHEST``), and stops cuBLAS from
reducing bf16 products partly in bf16 (XLA accumulates the towers' bf16
Dense layers in float32).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]

DEFAULT_DEVICE = "cuda"


def _strict_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The torch device an entry point runs on (default ``"cuda"``).

    Raises RuntimeError for a CUDA device when CUDA is not available."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (want cuda or cpu)")
    _strict_f32()
    return dev
