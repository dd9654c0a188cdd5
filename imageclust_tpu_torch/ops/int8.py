"""int8 products with exact int32 accumulation, for the int8 PTQ towers
(:mod:`imageclust_tpu_torch.models.quantize`,
:mod:`imageclust_tpu_torch.models.quantize_vit`).

The JAX package leaves these to XLA (``lax.conv_general_dilated`` and
``lax.dot_general`` with ``preferred_element_type=int32``,
``imageclust_tpu/models/quantize.py:52-70``, ``quantize_vit.py:64-76``); no
Pallas kernel computes them, so the port calls a library product:
``torch._int_mm``, cuBLASLt's int8 GEMM with int32 output on the card and
an exact int8 product on the CPU. An int32 sum of int8 products is exact
in any order, so on the same operands these results equal XLA's bit for
bit on either device. On a CUDA tensor the product runs on the card or
raises: nothing falls back to a float product.

A convolution is an im2col over the NHWC int8 activations (a 1x1 conv is
a reshape after the stride's subsampling; a k x k conv concatenates the
k * k shifted, strided slices of the zero-padded batch along the channel
axis, in (kh, kw, cin) order) times the OHWI kernel seen as a
(kh * kw * cin, cout) matrix. The columns live only for the one product.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["int8_mm", "int8_conv2d", "quantize_act"]

# cuBLASLt's int8 GEMM through torch._int_mm on CUDA: m > 16, k and n
# multiples of 8 (zero rows and columns leave the sums unchanged)
_CUDA_MIN_M = 17
_CUDA_MULT = 8


def _pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) int8 @ (k, n) int8 -> (m, n) int32, exact. ``b`` may be any
    layout; a column-major ``b`` (the transpose of a contiguous (n, k)
    weight) is what cuBLASLt takes without a copy."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_mm takes (m, k) @ (k, n), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_mm takes int8 operands, got {a.dtype} and "
                        f"{b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return torch._int_mm(a.contiguous(), b)
    if a.device.type != "cuda":
        raise ValueError(f"int8_mm runs on cuda or cpu, not {a.device}")
    m, k = a.shape
    n = b.shape[1]
    mp = max(m, _CUDA_MIN_M)
    kp, np_ = _pad_to(k, _CUDA_MULT), _pad_to(n, _CUDA_MULT)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    if b.stride(0) != 1:  # column-major, as cuBLASLt's int8 path takes it
        b = b.t().contiguous().t()
    out = torch._int_mm(a.contiguous(), b)
    if (mp, np_) != (m, n):
        out = out[:m, :n].contiguous()
    return out


def int8_conv2d(x: torch.Tensor, w: torch.Tensor, stride: int,
                pad: int) -> torch.Tensor:
    """Convolution of NHWC int8 ``x`` (B, H, W, cin) with the OHWI int8
    kernel ``w`` (cout, kh, kw, cin), symmetric zero padding ``pad`` and
    stride ``stride``: (B, Ho, Wo, cout) int32, exact (XLA's
    ``conv_general_dilated`` with ``preferred_element_type=int32`` on the
    NHWC/HWIO layout)."""
    if x.dim() != 4 or w.dim() != 4 or x.shape[3] != w.shape[3]:
        raise ValueError(f"int8_conv2d takes NHWC x and OHWI w with one cin,"
                         f" got {tuple(x.shape)} and {tuple(w.shape)}")
    b, h, wd, cin = x.shape
    cout, kh, kw, _ = w.shape
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (wd + 2 * pad - kw) // stride + 1
    if kh == kw == 1 and pad == 0:
        cols = x[:, ::stride, ::stride, :] if stride > 1 else x
    else:
        xp = F.pad(x, (0, 0, pad, pad, pad, pad)) if pad else x
        cols = torch.cat(
            [xp[:, i:i + stride * (ho - 1) + 1:stride,
                j:j + stride * (wo - 1) + 1:stride, :]
             for i in range(kh) for j in range(kw)], dim=-1)
    y = int8_mm(cols.reshape(b * ho * wo, kh * kw * cin),
                w.reshape(cout, kh * kw * cin).t())
    return y.reshape(b, ho, wo, cout)


def quantize_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor int8: ``clamp(round(x / scale), -127, 127)`` in
    float32 (``torch.round`` rounds half to even, as ``jnp.round``)."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(
        torch.int8)
