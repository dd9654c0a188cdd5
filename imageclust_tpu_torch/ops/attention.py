"""K5: short-sequence attention for the ViT towers, and its plain twin.

:func:`short_seq_attention` replaces
``imageclust_tpu/ops/attention.py:short_seq_attention`` (Pallas body
``_attn_kernel``): softmax(Q Kᵀ / sqrt(Dh)) V for every (batch, head) pair
of q, k, v in the towers' (B, T, H, Dh) layout, T <= 128. On a CUDA tensor
it launches the hand-written Hopper kernel (``csrc/short_seq_attention.cu``;
design notes there), which reads q, k and v in place and never writes the
(T, T) logits to device memory: it is bound by the bytes of one read of q,
k, v and one write of o. On a CPU tensor it runs
:func:`short_seq_attention_plain`, the torch translation of the Pallas body
step by step. Kernel and twin sum in different orders, so they agree to a
tolerance, not bit for bit (as the Pallas kernel and XLA's attention do).
No other device is accepted, and nothing falls back.

:func:`attention` is the towers' dispatch (JAX ``models/vit.py:40-59``):
on CUDA with T <= ``_FUSED_ATTN_MAX_SEQ`` it calls K5; on CUDA with longer
sequences in bf16 :func:`long_seq_attention`, PyTorch's fused
``scaled_dot_product_attention`` pinned to one backend (where the JAX
package leaves those lengths to ``jax.nn.dot_product_attention``, XLA's
work, a library call stands in the port); otherwise the twin: on the CPU
at every length, and for float32 above 128 tokens on the card, which the
backend does not take (a float32 tower, the int8 towers' float32
calibration forward). The JAX package's ``IMAGECLUST_VIT_ATTN`` switch is
not ported: it swaps the kernel out, which the port's runtime rules
forbid.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from imageclust_tpu_torch.ops._build import launch

__all__ = ["attention", "long_seq_attention", "short_seq_attention",
           "short_seq_attention_plain"]

# Sequences at or under this length take K5 on the card (JAX vit.py:40).
_FUSED_ATTN_MAX_SEQ = 128
_MAX_DH = 128


def short_seq_attention_plain(q, k, v):
    """The plain PyTorch version of K5 (attention.py:44-60): logits in f32,
    times ``1/sqrt(Dh)`` in f32, max-subtracted exp, divided by the row sum,
    cast to v's dtype, then p @ v accumulated in f32 and cast to q's dtype.
    q, k, v (B, T, H, Dh) of one dtype, any T; returns a contiguous
    (B, T, H, Dh) tensor."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhts,bshd->bthd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype).contiguous()


def _check(q, k, v):
    if q.dim() != 4:
        raise ValueError(f"q must be (B, T, H, Dh), got {tuple(q.shape)}")
    B, T, H, Dh = q.shape
    if not 1 <= T <= _FUSED_ATTN_MAX_SEQ:
        raise ValueError(f"short_seq_attention takes 1 <= T <= "
                         f"{_FUSED_ATTN_MAX_SEQ}, got T={T}")
    if not (8 <= Dh <= _MAX_DH and Dh % 8 == 0):
        raise ValueError(f"short_seq_attention takes Dh <= {_MAX_DH} with "
                         f"Dh % 8 == 0, got Dh={Dh}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if tuple(t.shape) != (B, T, H, Dh):
            raise ValueError(f"{name} must be {(B, T, H, Dh)}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def short_seq_attention(q, k, v):
    """K5. q, k, v contiguous (B, T, H, Dh), one dtype (bf16 or f32), one
    device, 1 <= T <= 128, Dh <= 128 with Dh % 8 == 0. Returns o (B, T, H,
    Dh) in q's dtype, without a host synchronisation on CUDA."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return short_seq_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"short_seq_attention runs on cuda or cpu, "
                         f"not {q.device}")
    B, T, H, Dh = q.shape
    out = torch.empty_like(q)
    launch("short_seq_attention", q.device, (q, k, v), q.data_ptr(),
           k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, H, Dh,
           1.0 / math.sqrt(Dh), int(q.dtype == torch.bfloat16))
    return out


def long_seq_attention(q, k, v):
    """softmax(Q Kᵀ / sqrt(Dh)) V on a CUDA device for q, k, v (B, T, H, Dh)
    of any T: ``F.scaled_dot_product_attention`` on their (B, H, T, Dh)
    views, pinned to cuDNN's fused backend, the fastest of flash, cuDNN and
    memory-efficient at every long shape of the towers on an H100
    (``tools/time_long_attention.py``, PERF.md); it never writes the
    (T, T) logits to device memory. The math backend is left out of the pin, so a shape
    or dtype the backend cannot take (float32, for one) raises a
    RuntimeError instead of falling back. Returns o as a (B, T, H, Dh)
    view in q's dtype."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.CUDNN_ATTENTION]):
        o = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    return o.transpose(1, 2)


def attention(q, k, v):
    """The towers' attention: on CUDA tensors K5 at T <= 128 and, in bf16,
    :func:`long_seq_attention` above; the plain twin otherwise."""
    if q.device.type == "cuda":
        if q.shape[1] <= _FUSED_ATTN_MAX_SEQ:
            return short_seq_attention(q, k, v)
        if q.dtype == torch.bfloat16:
            return long_seq_attention(q, k, v)
    return short_seq_attention_plain(q, k, v)
