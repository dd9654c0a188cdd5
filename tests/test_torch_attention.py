"""K5's plain twin (``imageclust_tpu_torch/ops/attention.py``) against the
JAX package's Pallas kernel (interpret mode) and ``jax.nn.dot_product_attention``,
plus the wrapper's checks and the towers' dispatch.

Tolerances are those of tests/test_attention.py: float32 allclose at
rtol = atol = 1e-5 (the sums run in other orders); bfloat16 at 0.02 (bf16
inputs, f32 accumulation on both sides: output-rounding differences only).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageclust_tpu.ops.attention import short_seq_attention as pallas_attention
from imageclust_tpu_torch.ops import attention as at
from imageclust_tpu_torch.ops._build import launches

torch.set_num_threads(1)

_TOL = {"float32": 1e-5, "bfloat16": 0.02}

# (B, T, H, Dh, dtype): tests/test_attention.py's shapes, then the longest
# sequence K5 takes and a single token
_CASES = [
    (4, 50, 12, 64, "float32"),
    (2, 50, 12, 64, "bfloat16"),
    (3, 17, 5, 64, "float32"),
    (2, 128, 4, 64, "float32"),
    (2, 128, 4, 64, "bfloat16"),
    (3, 1, 2, 64, "float32"),
    (3, 1, 2, 64, "bfloat16"),
]


def _qkv(b, t, h, dh, dtype, seed=0):
    """The same inputs for both packages: numpy normals rounded to dtype."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, t, h, dh)).astype(np.float32)
            for _ in range(3)]
    if dtype == "bfloat16":
        arrs = [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                for a in arrs]
    jx = [jnp.asarray(a, dtype) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("ref", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("b,t,h,dh,dtype", _CASES,
                         ids=[f"{c[0]}x{c[1]}x{c[2]}x{c[3]}-{c[4]}"
                              for c in _CASES])
def test_twin_matches_jax(ref, b, t, h, dh, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(b, t, h, dh, dtype, seed=t + h)
    if ref == "xla":
        want = jax.nn.dot_product_attention(jq, jk, jv)
    else:
        want = pallas_attention(jq, jk, jv, interpret=True)
    got = at.short_seq_attention_plain(tq, tk, tv)
    assert got.shape == (b, t, h, dh) and got.dtype == tq.dtype
    assert got.is_contiguous()
    tol = _TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_twin_long_sequence_matches_xla():
    """The twin is also the plain path above T = 128 (ViT-B/16's 197)."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 197, 2, 64, "float32", seed=5)
    np.testing.assert_allclose(
        _np(at.short_seq_attention_plain(tq, tk, tv)),
        _np(jax.nn.dot_product_attention(jq, jk, jv)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrapper_on_cpu_runs_the_twin(dtype):
    _, (q, k, v) = _qkv(2, 50, 3, 64, dtype, seed=1)
    before = launches["short_seq_attention"]
    got = at.short_seq_attention(q, k, v)
    # the kernel never runs on the CPU
    assert launches["short_seq_attention"] == before
    assert torch.equal(got, at.short_seq_attention_plain(q, k, v))


@pytest.mark.parametrize("shape,exc", [
    ((1, 129, 1, 64), ValueError),   # T above 128
    ((1, 8, 1, 136), ValueError),    # Dh above 128
    ((1, 8, 1, 60), ValueError),     # Dh % 8 != 0
    ((8, 1, 64), ValueError),        # not 4-D
])
def test_wrapper_rejects_shapes(shape, exc):
    q = torch.zeros(shape)
    with pytest.raises(exc):
        at.short_seq_attention(q, q, q)


def test_wrapper_rejects_mixed_inputs():
    q = torch.zeros((1, 8, 2, 64))
    with pytest.raises(TypeError):
        at.short_seq_attention(q, q.bfloat16(), q)
    with pytest.raises(TypeError):
        at.short_seq_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        at.short_seq_attention(q, q.transpose(1, 2).contiguous()
                               .transpose(1, 2), q)
    with pytest.raises(ValueError):
        at.short_seq_attention(q, q[:, :4], q)
    with pytest.raises(ValueError):
        at.short_seq_attention(q.to("meta"), q.to("meta"), q.to("meta"))


def test_dispatch(monkeypatch):
    """attention(): K5 only for CUDA tensors with T <= 128, the fused
    library path for bf16 CUDA tensors above; the twin for CPU tensors at
    every length and for float32 CUDA tensors above 128."""
    calls = []
    monkeypatch.setattr(at, "short_seq_attention",
                        lambda q, k, v: calls.append(("k5", q.shape[1])))
    monkeypatch.setattr(at, "long_seq_attention",
                        lambda q, k, v: calls.append(("fused", q.shape[1])))
    monkeypatch.setattr(at, "short_seq_attention_plain",
                        lambda q, k, v: calls.append(("twin", q.shape[1])))
    for dev, dtype in (("cuda", torch.bfloat16), ("cpu", torch.bfloat16),
                       ("cuda", torch.float32)):
        for t in (1, 50, 128, 129):
            q = types.SimpleNamespace(device=torch.device(dev), dtype=dtype,
                                      shape=(2, t, 4, 64))
            at.attention(q, q, q)
    assert calls == [("k5", 1), ("k5", 50), ("k5", 128), ("fused", 129),
                     ("twin", 1), ("twin", 50), ("twin", 128),
                     ("twin", 129),
                     ("k5", 1), ("k5", 50), ("k5", 128), ("twin", 129)]


def test_dispatch_on_cpu_is_the_twin():
    _, (q, k, v) = _qkv(2, 50, 3, 64, "bfloat16", seed=2)
    assert torch.equal(at.attention(q, k, v),
                       at.short_seq_attention_plain(q, k, v))
