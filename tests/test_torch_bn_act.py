"""K6 (``ops/bn_act.py``): the ResNet50 tower's inference BatchNorm,
residual and ReLU in one call, on the CPU.

The plain twin is held bit for bit to the tower's expression as it stood
before K6 (copied below as ``_old_bn``), alone and with each residual kind;
the wrapper's checks and the dispatch are exercised without a card; the
tower's outputs, running statistics and gradients on the CPU are held bit
for bit to a forward written with that expression; the pipeline counts the
embed stage's launches. The kernel itself runs only on the card
(tests/test_torch_cuda.py, ``chip_smoke.py`` phase 31).

This file imports neither JAX nor the JAX package.
"""

import copy
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from imageclust_tpu_torch.models import resnet50 as rn
from imageclust_tpu_torch.ops import bn_act as ba

torch.set_num_threads(1)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_EPS = 1e-5


def _old_bn(bn, x, norm_dtype, train=False):
    """``_BatchNorm.forward`` as the tower ran it before K6."""
    shape = (1, -1, 1, 1)
    xf = x.float()
    if train:
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp_min(
            (xf * xf).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
        with torch.no_grad():
            bn.running_mean.copy_(0.9 * bn.running_mean + 0.1 * mean)
            bn.running_var.copy_(0.9 * bn.running_var + 0.1 * var)
    else:
        mean, var = bn.running_mean, bn.running_var
    mul = torch.rsqrt(var + _EPS) * bn.weight
    y = (xf - mean.view(shape)) * mul.view(shape)
    return (y + bn.bias.view(shape)).to(norm_dtype)


def _old_block(blk, x, dtype, norm_dtype, train):
    def bn(name, y):
        return (y if blk.fold_bn
                else _old_bn(getattr(blk, name), y, norm_dtype, train))

    y = bn("bn0", blk.conv0(x, dtype)).relu()
    y = bn("bn1", blk.conv1(y, dtype)).relu()
    y = bn("bn2", blk.conv2(y, dtype))
    if blk.conv_proj is not None:
        x = bn("bn_proj", blk.conv_proj(x, dtype))
    return (y + x.to(y.dtype)).relu()


def _old_tower(model, x, train=False):
    """``ResNet50V1.forward`` as it ran before K6: (logits, pooled)."""
    x = (model._stem_s2d(x) if model.stem_mode == "s2d_raw"
         else model._stem_standard(x))
    if not model.fold_bn:
        x = _old_bn(model.bn0, x, model.norm_dtype, train)
    x = F.max_pool2d(x.relu(), 3, 2, padding=1)
    for si, n_blocks in enumerate(model.stage_layers):
        for bi in range(n_blocks):
            x = _old_block(getattr(model, f"stage{si + 1}_block{bi}"), x,
                           model.dtype, model.norm_dtype, train)
    pooled = x.float().mean(dim=(2, 3)).to(x.dtype).float()
    return F.linear(pooled, model.dense0.weight, model.dense0.bias), pooled


def _channels_last(gen, shape, dtype, scale=1.0):
    x = torch.randn(shape, generator=gen) * scale
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


def _bn(gen, c):
    """A _BatchNorm with seeded statistics and affine (the init's 0/1 would
    leave the normalisation untested)."""
    bn = rn._BatchNorm(c)
    with torch.no_grad():
        bn.running_mean.copy_(torch.rand(c, generator=gen) - 0.5)
        bn.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
        bn.weight.copy_(torch.rand(c, generator=gen) + 0.5)
        bn.bias.copy_(torch.rand(c, generator=gen) - 0.5)
    return bn


def _seeded_tower(dtype, norm_dtype, stem_mode="standard",
                  stage_layers=(1, 1, 1, 1), seed=0):
    model = rn.ResNet50V1(num_classes=10, dtype=dtype, norm_dtype=norm_dtype,
                          stage_layers=stage_layers,
                          stem_mode=stem_mode).init_random(seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, rn._BatchNorm):
                seeded = _bn(gen, mod.weight.shape[0])
                mod.load_state_dict(seeded.state_dict())
    return model


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(-1).view(torch.int16 if a.element_size() == 2
                                     else torch.int32),
        b.contiguous().view(-1).view(torch.int16 if b.element_size() == 2
                                     else torch.int32))


# -- the twin against the tower's expression ---------------------------------

@pytest.mark.parametrize("residual", ["none", "raw", "projected"])
@pytest.mark.parametrize("out_name", ["bfloat16", "float32"])
@pytest.mark.parametrize("in_name", ["bfloat16", "float32"])
def test_twin_is_the_towers_expression(in_name, out_name, residual):
    gen = torch.Generator().manual_seed(7)
    dt, nd = _DTYPES[in_name], _DTYPES[out_name]
    shape = (3, 64, 5, 7)
    x = _channels_last(gen, shape, dt, 3.0)
    bn, bn_proj = _bn(gen, 64), _bn(gen, 64)
    want = _old_bn(bn, x, nd)
    res = rvec = None
    if residual == "raw":  # the block's input, in norm_dtype
        res = _channels_last(gen, shape, nd, 3.0)
        want = want + res.to(want.dtype)
    elif residual == "projected":  # the projection conv's output
        res = _channels_last(gen, shape, dt, 3.0)
        rvec = bn_proj.vectors()
        want = want + _old_bn(bn_proj, res, nd).to(want.dtype)
    with torch.no_grad():
        got = ba.bn_act_plain(x, *bn.vectors(), nd, res, rvec, relu=True)
        plain = ba.bn_act_plain(x, *bn.vectors(), nd, res, rvec)
    assert _same_bits(got, want.relu())
    assert _same_bits(plain, want)
    assert (got >= 0).all() and (plain < 0).any()


@pytest.mark.parametrize("res_name", ["bfloat16", "float32"])
def test_twin_rounds_a_raw_residual_to_the_output_dtype(res_name):
    """A raw residual of another dtype is cast to the output's first, as
    ``y + x.to(y.dtype)`` does."""
    gen = torch.Generator().manual_seed(8)
    x = _channels_last(gen, (2, 16, 3, 3), torch.bfloat16)
    res = _channels_last(gen, (2, 16, 3, 3), _DTYPES[res_name])
    bn = _bn(gen, 16)
    want = _old_bn(bn, x, torch.bfloat16)
    with torch.no_grad():
        got = ba.bn_act_plain(x, *bn.vectors(), torch.bfloat16, res)
    assert _same_bits(got, want + res.to(torch.bfloat16))


def test_wrapper_on_cpu_runs_the_twin():
    gen = torch.Generator().manual_seed(9)
    x = _channels_last(gen, (2, 128, 4, 4), torch.bfloat16)
    res = _channels_last(gen, (2, 128, 4, 4), torch.bfloat16)
    bn, bp = _bn(gen, 128), _bn(gen, 128)
    before = ba.launches
    with torch.no_grad():
        got = ba.bn_act(x, *bn.vectors(), torch.bfloat16, res, bp.vectors(),
                        relu=True)
        want = ba.bn_act_plain(x, *bn.vectors(), torch.bfloat16, res,
                               bp.vectors(), relu=True)
    assert ba.launches == before  # the kernel never runs on the CPU
    assert _same_bits(got, want)


# -- the wrapper's checks -----------------------------------------------------

def _operands(c=64, dtype=torch.bfloat16):
    x = torch.zeros((2, c, 3, 3), dtype=dtype).contiguous(
        memory_format=torch.channels_last)
    vec = torch.zeros(c)
    return x, vec


@pytest.mark.parametrize("case,exc", [
    ("x_float16", TypeError),
    ("out_float16", TypeError),
    ("vector_float64", TypeError),
    ("residual_float16", TypeError),
    ("raw_residual_not_out_dtype", TypeError),
    ("projected_residual_not_x_dtype", TypeError),
    ("x_nchw", ValueError),
    ("residual_nchw", ValueError),
    ("vector_short", ValueError),
    ("vector_2d", ValueError),
    ("c_not_multiple_of_8", ValueError),
    ("c_above_2048", ValueError),
    ("x_3d", ValueError),
    ("residual_shape", ValueError),
    ("residual_vectors_alone", ValueError),
    ("residual_vectors_two", ValueError),
    ("meta_device", ValueError),
])
def test_wrapper_rejects(case, exc):
    x, v = _operands()
    args = {"x": x, "mean": v, "mul": v, "bias": v,
            "out_dtype": torch.bfloat16, "residual": None,
            "residual_vectors": None}
    if case == "x_float16":
        args["x"] = x.half()
    elif case == "out_float16":
        args["out_dtype"] = torch.float16
    elif case == "vector_float64":
        args["mul"] = v.double()
    elif case == "residual_float16":
        args["residual"] = x.half()
    elif case == "raw_residual_not_out_dtype":
        args["residual"] = x.float()
    elif case == "projected_residual_not_x_dtype":
        args["residual"] = x.float()
        args["residual_vectors"] = (v, v, v)
    elif case == "x_nchw":
        args["x"] = x.contiguous()
    elif case == "residual_nchw":
        args["residual"] = x.contiguous()
    elif case == "vector_short":
        args["bias"] = v[:56]
    elif case == "vector_2d":
        args["mean"] = v.view(8, 8)
    elif case == "c_not_multiple_of_8":
        args["x"], args["mean"] = _operands(60)
        args["mul"] = args["bias"] = args["mean"]
    elif case == "c_above_2048":
        args["x"], args["mean"] = _operands(2056)
        args["mul"] = args["bias"] = args["mean"]
    elif case == "x_3d":
        args["x"] = x[0]
    elif case == "residual_shape":
        args["residual"] = x[:1]
    elif case == "residual_vectors_alone":
        args["residual_vectors"] = (v, v, v)
    elif case == "residual_vectors_two":
        args["residual"] = x
        args["residual_vectors"] = (v, v)
    elif case == "meta_device":
        args = {k: (t.to("meta") if isinstance(t, torch.Tensor) else t)
                for k, t in args.items()}
    before = ba.launches
    with pytest.raises(exc):
        ba.bn_act(**args)
    assert ba.launches == before


def test_wrapper_rejects_mixed_devices():
    x, v = _operands()
    with pytest.raises(ValueError):
        ba.bn_act(x, v.to("meta"), v, v, torch.bfloat16)


# -- the dispatch ---------------------------------------------------------------

def _fake(device, requires_grad=False):
    return types.SimpleNamespace(device=torch.device(device),
                                 requires_grad=requires_grad)


def test_dispatch(monkeypatch):
    """K6 for every CUDA tensor, tracked by autograd or not (the wrapper
    raises for a tracked one); the twin for CPU tensors."""
    calls = []
    monkeypatch.setattr(ba, "bn_act", lambda *a, **k: calls.append("k6"))
    monkeypatch.setattr(ba, "bn_act_plain",
                        lambda *a, **k: calls.append("twin"))
    for dev in ("cuda", "cpu"):
        for grad in (False, True):
            for tracked in ("x", "mul", "residual", "residual_mul", None):
                def op(name):
                    return _fake(dev, tracked == name)

                with torch.set_grad_enabled(grad):
                    ba.batch_norm_act(
                        op("x"), op("mean"), op("mul"), op("bias"),
                        torch.bfloat16, op("residual"),
                        (op("rm"), op("residual_mul"), op("rb")), relu=True)
    assert calls == ["k6"] * 10 + ["twin"] * 10


def test_dispatch_on_cpu_is_the_twin():
    gen = torch.Generator().manual_seed(10)
    x = _channels_last(gen, (2, 64, 3, 3), torch.bfloat16)
    bn = _bn(gen, 64)
    with torch.no_grad():
        got = ba.batch_norm_act(x, *bn.vectors(), torch.float32, relu=True)
        want = ba.bn_act_plain(x, *bn.vectors(), torch.float32, relu=True)
    assert _same_bits(got, want)


def _count_calls(monkeypatch):
    calls = []
    real = rn.batch_norm_act

    def spy(x, mean, mul, bias, out_dtype, residual=None,
            residual_vectors=None, relu=False):
        kind = ("none" if residual is None
                else "raw" if residual_vectors is None else "projected")
        calls.append((x.shape[1], kind, relu))
        return real(x, mean, mul, bias, out_dtype, residual,
                    residual_vectors, relu)

    monkeypatch.setattr(rn, "batch_norm_act", spy)
    return calls


def test_tower_makes_49_calls_a_batch(monkeypatch):
    """ResNet50 at inference: the stem's bn0 and three a block, each with
    ReLU, the last of each block with its residual (projected in the four
    first blocks)."""
    calls = _count_calls(monkeypatch)
    model = rn.ResNet50V1(num_classes=10, dtype="float32",
                          norm_dtype="float32").init_random(0)
    with torch.inference_mode():
        model(torch.zeros((1, 3, 32, 32)))
    assert len(calls) == 49 and all(relu for _, _, relu in calls)
    kinds = [k for _, k, _ in calls]
    assert kinds.count("projected") == 4 and kinds.count("raw") == 12
    assert {c for c, _, _ in calls} == {64, 128, 256, 512, 1024, 2048}


@pytest.mark.parametrize("layout", ["train", "fold_bn"])
def test_train_and_folded_towers_never_call_it(monkeypatch, layout):
    calls = _count_calls(monkeypatch)
    model = _seeded_tower("float32", "float32")
    x = torch.from_numpy(np.random.default_rng(0).random(
        (2, 3, 32, 32), dtype=np.float32))
    if layout == "train":
        model(x, train=True)
    else:
        with torch.inference_mode():
            rn.fold_bn_variables(model)(x)
    assert calls == []


# -- the tower on the CPU, unchanged --------------------------------------------

@pytest.mark.parametrize("stem_mode", ["standard", "s2d_raw"])
@pytest.mark.parametrize("dtype,norm_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"),
    ("bfloat16", "float32")])
def test_tower_outputs_unchanged(dtype, norm_dtype, stem_mode):
    model = _seeded_tower(dtype, norm_dtype, stem_mode)
    u8 = np.random.default_rng(1).integers(0, 256, (2, 32, 32, 3),
                                           dtype=np.uint8)
    x = (torch.from_numpy(u8) if stem_mode == "s2d_raw"
         else torch.from_numpy(u8[..., ::-1] / np.float32(255.0))
         .permute(0, 3, 1, 2).contiguous())
    with torch.inference_mode():
        logits, pooled = model(x, return_features=True)
        want_logits, want_pooled = _old_tower(model, x)
    assert _same_bits(logits, want_logits)
    assert _same_bits(pooled, want_pooled)


def test_train_step_unchanged():
    """train=True: the same logits, running statistics and gradients as the
    tower's code before K6, bit for bit."""
    model = _seeded_tower("float32", "float32")
    old = copy.deepcopy(model)
    x = torch.from_numpy(np.random.default_rng(2).random(
        (4, 3, 32, 32), dtype=np.float32))
    got = model(x, train=True)
    want, _ = _old_tower(old, x, train=True)
    assert _same_bits(got, want)
    got.square().sum().backward()
    want.square().sum().backward()
    for (name, p), q in zip(model.named_parameters(), old.parameters()):
        assert _same_bits(p.grad, q.grad), name
    for (name, b), c in zip(model.named_buffers(), old.buffers()):
        assert _same_bits(b, c), name


# -- the wrapper on the CPU: autograd and an empty batch ---------------------

def test_wrapper_on_cpu_keeps_autograd():
    """On a CPU tensor the wrapper is the twin, so gradients flow as through
    the tower's expression (on CUDA it raises instead)."""
    gen = torch.Generator().manual_seed(11)
    x = _channels_last(gen, (2, 64, 3, 3), torch.float32).requires_grad_()
    bn = _bn(gen, 64)
    got = ba.bn_act(x, *bn.vectors(), torch.float32, relu=True)
    got.sum().backward()
    mul = (torch.rsqrt(bn.running_var + _EPS) * bn.weight).view(1, -1, 1, 1)
    assert torch.equal(x.grad, torch.where(got > 0, mul, 0.0))
    assert bn.weight.grad is not None and bn.bias.grad is not None


@pytest.mark.parametrize("residual", ["none", "raw", "projected"])
def test_wrapper_on_cpu_takes_an_empty_batch(residual):
    x = torch.zeros((0, 64, 7, 7), dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    v = torch.zeros(64)
    res = None if residual == "none" else x
    rvec = (v, v, v) if residual == "projected" else None
    got = ba.bn_act(x, v, v, v, torch.bfloat16, res, rvec, relu=True)
    assert got.shape == x.shape and got.dtype == torch.bfloat16
