"""K6: the ResNet50 tower's inference BatchNorm, residual and ReLU in one
pass, and its plain twin.

No TPU kernel stands behind it: on the TPU, XLA fused each BatchNorm into
its convolution's output. The port leaves the convolutions to cuDNN, so the
float32 BatchNorm of ``models/resnet50.py`` (the Flax cast points: widen to
float32, normalise, narrow to ``norm_dtype``) ran as one PyTorch pass per
operation. :func:`bn_act` does it in one read and one write of the
activation (``csrc/bn_act.cu``; design notes there) and is bound by those
bytes.

:func:`bn_act_plain` is the twin and the tower's expression on every other
path (CPU tensors, the train step): per element of channel c,
``y = ((float(x) - mean[c]) * mul[c] + bias[c]).to(out_dtype)``; with a
residual, ``y = y + residual.to(y.dtype)``, the residual first normalised
the same way with ``residual_vectors`` when given (a projection shortcut);
with ``relu``, ``y.relu()``. The kernel rounds at the same points, so the
two agree bit for bit.

:func:`batch_norm_act` is the tower's dispatch: K6 for CUDA tensors, the
twin for the others. On a CUDA tensor :func:`bn_act` launches or raises
(also where autograd tracks an operand: the kernel has no backward, so the
tower's inference runs under ``torch.inference_mode`` or ``no_grad``);
nothing falls back.
"""

from __future__ import annotations

import torch

__all__ = ["batch_norm_act", "bn_act", "bn_act_plain", "launches"]

_DTYPES = (torch.bfloat16, torch.float32)
_VEC = 8            # channels a kernel thread owns: C % 8 == 0
_MAX_CHANNELS = 2048

# Launches of the CUDA kernel by bn_act (one per call on a CUDA tensor).
# Plain-twin calls are not counted.
launches = 0


def _normalize(x, mean, mul, bias, out_dtype):
    shape = (1, -1, 1, 1)
    y = (x.float() - mean.view(shape)) * mul.view(shape)
    return (y + bias.view(shape)).to(out_dtype)


def bn_act_plain(x, mean, mul, bias, out_dtype, residual=None,
                 residual_vectors=None, relu=False):
    """The plain PyTorch version of K6: x (N, C, H, W) normalised with the
    float32 (C,) vectors ``mean``, ``mul`` and ``bias`` into ``out_dtype``,
    then ``residual`` added (normalised first with ``residual_vectors``, a
    (mean, mul, bias) triple, when given), then ReLU when ``relu``."""
    y = _normalize(x, mean, mul, bias, out_dtype)
    if residual is not None:
        if residual_vectors is not None:
            residual = _normalize(residual, *residual_vectors, out_dtype)
        y = y + residual.to(y.dtype)
    return y.relu() if relu else y


def _check(x, vectors, out_dtype, residual, residual_vectors):
    """The kernel's operands, on any device; a raw residual is the block's
    input (``out_dtype``), a projected one the projection conv's output
    (x's dtype)."""
    if x.dim() != 4:
        raise ValueError(f"x must be (N, C, H, W), got {tuple(x.shape)}")
    C = x.shape[1]
    if C % _VEC or not 0 < C <= _MAX_CHANNELS:
        raise ValueError(f"bn_act takes C % {_VEC} == 0 and C <= "
                         f"{_MAX_CHANNELS}, got C={C}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"out_dtype must be bfloat16 or float32, got "
                        f"{out_dtype}")
    tensors = [("x", x)]
    if residual is not None:
        if tuple(residual.shape) != tuple(x.shape):
            raise ValueError(f"residual is {tuple(residual.shape)}, x "
                             f"{tuple(x.shape)}")
        want = out_dtype if residual_vectors is None else x.dtype
        if residual.dtype != want:
            kind = "raw" if residual_vectors is None else "projected"
            raise TypeError(f"a {kind} residual must be {want}, got "
                            f"{residual.dtype}")
        tensors.append(("residual", residual))
    elif residual_vectors is not None:
        raise ValueError("residual_vectors without a residual")
    for name, t in tensors:
        if not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"{name} must be channels_last contiguous")
    for i, v in enumerate(vectors):
        if v.dtype != torch.float32:
            raise TypeError(f"vector {i} is {v.dtype}, not float32")
        if tuple(v.shape) != (C,) or not v.is_contiguous():
            raise ValueError(f"vector {i} must be a contiguous ({C},), got "
                             f"{tuple(v.shape)}")
        tensors.append((f"vector {i}", v))
    for name, t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def bn_act(x, mean, mul, bias, out_dtype, residual=None,
           residual_vectors=None, relu=False):
    """K6. x (N, C, H, W) bf16 or float32 in channels_last memory, C a
    multiple of 8 up to 2048; ``mean``, ``mul``, ``bias`` float32 (C,);
    ``residual`` None or x's shape in channels_last memory, with
    ``residual_vectors`` None (the residual in ``out_dtype``) or a float32
    (mean, mul, bias) triple (the residual in x's dtype). Returns
    ``out_dtype`` (bf16 or float32) in channels_last memory, without a host
    synchronisation on CUDA. On a CPU tensor it runs the twin. On CUDA it
    raises where autograd tracks an operand, and launches nothing for an
    empty x."""
    global launches
    vectors = [mean, mul, bias, *(residual_vectors or ())]
    if residual_vectors is not None and len(residual_vectors) != 3:
        raise ValueError("residual_vectors must be (mean, mul, bias)")
    _check(x, vectors, out_dtype, residual, residual_vectors)
    if x.device.type == "cpu":
        return bn_act_plain(x, mean, mul, bias, out_dtype, residual,
                            residual_vectors, relu)
    if x.device.type != "cuda":
        raise ValueError(f"bn_act runs on cuda or cpu, not {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in [x, residual, *vectors]):
        raise RuntimeError("bn_act has no backward: run the tower's "
                           "inference under torch.inference_mode() or "
                           "torch.no_grad(), or train=True")
    out = torch.empty_like(x, dtype=out_dtype,
                           memory_format=torch.channels_last)
    if x.numel() == 0:
        return out
    from imageclust_tpu_torch.ops._build import load_kernels
    from imageclust_tpu_torch.ops.merge_kernels import _raise_on

    lib = load_kernels()
    operands = [x, out, *vectors]
    if residual is not None:
        operands.append(residual)
    for t in operands:
        if t.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")
    mode = 0 if residual is None else 1 if residual_vectors is None else 2
    rvec = residual_vectors or (None, None, None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    n, c, h, w = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ic_bn_act(
            ptr(x), ptr(mean), ptr(mul), ptr(bias), ptr(residual),
            *(ptr(v) for v in rvec), ptr(out), n * h * w, c, mode, int(relu),
            int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            stream)
    _raise_on(lib, rc, "bn_act")
    launches += 1
    return out


def batch_norm_act(x, mean, mul, bias, out_dtype, residual=None,
                   residual_vectors=None, relu=False):
    """The tower's inference BatchNorm (with its residual and ReLU): K6 for
    CUDA tensors, the twin for the others."""
    fn = bn_act if x.device.type == "cuda" else bn_act_plain
    return fn(x, mean, mul, bias, out_dtype, residual, residual_vectors, relu)
