"""The port's sharded (DP x TP) train step and fine-tune over four gloo
ranks (data=2 x model=2) against the JAX package's ``make_train_step(
mesh=create_mesh(data=2, model=2))`` on the same weights and batch, run
here on four of the eight virtual CPU devices.

A ResNet50 with one block per stage, 16 classes, 64 x 64 inputs, a batch
of 8 whose two halves (one per ``data`` rank) come from different
distributions, so that per-rank BatchNorm statistics would give another
loss and other gradients than the global batch's.

Tolerances: the float32 loss within rtol 1e-5 of JAX's mesh step, and the
new BatchNorm statistics within rtol 1e-5 of each leaf's largest
magnitude (tests/test_torch_train.py's tolerance). The gradients are held,
as tests/test_torch_train.py holds them, to the float64 gradient (JAX with
x64 on the same batch): each leaf within a relative L2 distance of 1e-4.
They are not held to JAX's float32 gradient: the N(2, 3) half makes
BatchNorm's fast variance E[x^2] - E[x]^2 cancel, and JAX's float32
gradient lies 1.1e-2 from the float64 one on this batch (the port's,
sharded or not, 4e-6, measured on the CPU when the test was written). The
parameters after the step are held to AdamW's first step taken on the
float64 gradient, at rtol 1e-5 and atol 1e-5 of each leaf's largest
magnitude, wherever the gradient is above 1e-3 of its leaf's largest:
the first step moves a parameter by about lr * sign(g), so a gradient
that is zero up to rounding (a dead channel's) takes either sign on any
path; there the move is held to at most lr plus the decay.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imageclust_tpu.core.mesh import create_mesh as jax_mesh
from imageclust_tpu.models.resnet50 import ResNet50V1 as FlaxResNet
from imageclust_tpu.models.train import _opt_shardings
from imageclust_tpu.models.train import make_train_step as jax_train_step
from imageclust_tpu.models.train import variable_shardings
from imageclust_tpu.utils.checkpoint import restore_variables as jax_restore
from imageclust_tpu_torch.core.mesh import create_mesh
from imageclust_tpu_torch.models import train
from imageclust_tpu_torch.models.convert import (
    flax_params_from_named,
    resnet50_flax_from_state_dict,
    resnet50_state_dict_from_flax,
)
from imageclust_tpu_torch.models.resnet50 import ResNet50V1

from helpers import encode_png
import test_torch_mesh_targets as targets

torch.set_num_threads(2)

_LAYERS = (1, 1, 1, 1)
_CLASSES = 16
_LR = 1e-3


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), np.asarray(tree)


def _batch():
    """Two halves from different distributions: rank (data 0) gets N(0, 1)
    images, rank (data 1) N(2, 3)."""
    rng = np.random.default_rng(5)
    a = rng.normal(0.0, 1.0, (4, 3, 64, 64))
    b = rng.normal(2.0, 3.0, (4, 3, 64, 64))
    images = np.concatenate([a, b]).astype(np.float32)
    labels = rng.integers(0, _CLASSES, 8).astype(np.int32)
    return images, labels


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope="module")
def flax_vars():
    """The Flax module and the port's seeded weights in its tree (no JAX
    init to compile)."""
    model = FlaxResNet(dtype=jnp.float32, stage_layers=_LAYERS,
                       num_classes=_CLASSES)
    port = ResNet50V1(num_classes=_CLASSES, dtype="float32",
                      stage_layers=_LAYERS).init_random(0)
    return model, resnet50_flax_from_state_dict(port)


@pytest.fixture(scope="module")
def both(flax_vars, tmp_path_factory):
    flax_model, variables = flax_vars
    images, labels = _batch()
    state = {k: v.numpy() for k, v in
             resnet50_state_dict_from_flax(variables).items()}
    port = targets.run(
        [("step", "case_train", (2, 2), dict(
            state=state, images=images, labels=labels,
            num_classes=_CLASSES, stage_layers=_LAYERS))],
        4, tmp_path_factory.mktemp("train"))

    mesh = jax_mesh(data=2, model=2)
    tx = optax.adamw(_LR)
    step = jax_train_step(flax_model, tx, mesh=mesh,
                          variables_template=variables)
    with mesh:
        new_vars, _, loss = step(
            jax.device_put(variables, variable_shardings(variables, mesh)),
            tx.init(variables["params"]), jnp.asarray(images),
            jnp.asarray(labels))

    with jax.enable_x64(True):
        m64 = FlaxResNet(dtype=jnp.float64, norm_dtype=jnp.float64,
                         stage_layers=_LAYERS, num_classes=_CLASSES)
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)

        def loss64(params):
            logits, _ = m64.apply(
                {"params": params, "batch_stats": v64["batch_stats"]},
                jnp.asarray(images, jnp.float64), train=True,
                mutable=["batch_stats"])
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.asarray(labels)).mean()

        exact = jax.tree.map(np.asarray, jax.grad(loss64)(v64["params"]))
    return dict(port=[r["step"]["out"] for r in port], jloss=float(loss),
                jvars=jax.tree.map(np.asarray, new_vars), exact=exact,
                variables=variables)


def _port_flax(state):
    model = ResNet50V1(num_classes=_CLASSES, dtype="float32",
                       stage_layers=_LAYERS)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return resnet50_flax_from_state_dict(model)


class TestShardedStep:
    def test_loss(self, both):
        for out in both["port"]:
            np.testing.assert_allclose(out["loss"], both["jloss"], rtol=1e-5)

    def test_gradients(self, both):
        exact = dict(_leaves(both["exact"]))
        for out in both["port"]:
            got = dict(_leaves(flax_params_from_named(
                {k: torch.from_numpy(v) for k, v in out["grads"].items()})))
            assert got.keys() == exact.keys()
            for k in exact:
                assert _rel_l2(got[k], exact[k]) < 1e-4, k

    def test_batch_stats_are_global(self, both):
        want = dict(_leaves(both["jvars"]["batch_stats"]))
        for out in both["port"]:
            got = dict(_leaves(_port_flax(out["state"])["batch_stats"]))
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_allclose(
                    got[k], want[k], rtol=1e-5,
                    atol=1e-5 * np.abs(want[k]).max(), err_msg=k)

    def test_params_after_one_step(self, both):
        before = dict(_leaves(both["variables"]["params"]))
        grads = dict(_leaves(both["exact"]))
        # optax.adamw's first step on the exact gradient: the bias-corrected
        # moments are g and g^2
        want = {k: before[k] - _LR * (grads[k] / (np.abs(grads[k]) + 1e-8)
                                      + 1e-4 * before[k])
                for k in before}
        for out in both["port"]:
            got = dict(_leaves(_port_flax(out["state"])["params"]))
            for k in want:
                live = np.abs(grads[k]) > 1e-3 * np.abs(grads[k]).max()
                np.testing.assert_allclose(
                    got[k][live], want[k][live], rtol=1e-5,
                    atol=1e-5 * np.abs(want[k]).max(), err_msg=k)
                move = np.abs(got[k] - before[k])[~live]
                bound = _LR * (1 + 1e-4 * np.abs(before[k][~live])) * 1.01
                assert (move <= bound).all(), k

    def test_per_rank_statistics_would_fail(self, both):
        """The batch discriminates: BatchNorm over each rank's half alone
        (a plain DDP step, here the single-device port on each half) gives
        a loss 1e-2 or more away from the global batch's, a thousand times
        the tolerance above."""
        images, labels = _batch()
        model = ResNet50V1(num_classes=_CLASSES, dtype="float32",
                           stage_layers=_LAYERS)
        model.load_state_dict(resnet50_state_dict_from_flax(
            both["variables"]))
        halves = []
        with torch.no_grad():
            for s in (slice(0, 4), slice(4, 8)):
                logits = model(torch.from_numpy(images[s]), train=True)
                halves.append(float(torch.nn.functional.cross_entropy(
                    logits, torch.from_numpy(labels[s]).long())))
        per_rank = float(np.mean(halves))
        assert abs(per_rank - both["jloss"]) > 1e-2 * abs(both["jloss"])

    def test_head_is_sharded_and_moments_follow(self, both):
        """Each rank holds half of dense0's 16 output rows; AdamW's moments
        take their parameter's shard, everything else is whole."""
        for out in both["port"]:
            shapes, moments = out["shard_shapes"], out["moment_shapes"]
            assert shapes["dense0.weight"] == (_CLASSES // 2, 2048)
            assert shapes["dense0.bias"] == (_CLASSES // 2,)
            assert moments == shapes
            assert shapes["conv0.weight"] == (64, 3, 7, 7)

    def test_opt_shardings_match_jax(self, both):
        """The JAX ``_opt_shardings`` rule: a moment is sharded exactly where
        its parameter is; the count replicated."""
        from jax.sharding import PartitionSpec as P

        variables = both["variables"]
        mesh = jax_mesh(data=2, model=2)
        tx = optax.adamw(_LR)
        jspec = _opt_shardings(tx.init(variables["params"]),
                               variables["params"], mesh)
        model = ResNet50V1(num_classes=_CLASSES, stage_layers=_LAYERS)
        spec = train.opt_shardings(train.init_opt_state(model))
        var = train.variable_shardings(model.state_dict(),
                                       create_mesh(device="cpu"))
        assert {k for k, v in var.items() if v} == {"dense0.weight",
                                                    "dense0.bias"}
        assert spec[0]["count"] == ()
        mu_sharded = {k for k, v in spec[0]["mu"].items() if v}
        assert mu_sharded == {"dense0.weight", "dense0.bias"}
        jmu = jspec[0].mu["dense0"]
        assert jmu["kernel"].spec == P(None, "model")
        assert jmu["bias"].spec == P("model")


@pytest.fixture()
def labeled_dir(tmp_path):
    rng = np.random.default_rng(3)
    root = tmp_path / "data"
    for label, base in [("red", (0, 0, 220)), ("green", (0, 220, 0))]:
        d = root / label
        d.mkdir(parents=True)
        for i in range(6):
            img = np.full((40, 40, 3), base, np.uint8)
            img += rng.integers(0, 30, img.shape).astype(np.uint8)
            (d / f"{i}.png").write_bytes(encode_png(img))
    return str(root)


class TestShardedFinetune:
    def test_jax_reads_the_checkpoint(self, labeled_dir, tmp_path):
        """finetune_resnet50 over (data=2 x model=2): rank 0 writes the
        gathered weights and AdamW state; the JAX restore_variables reads
        both, bit for bit the model every rank returns, with the count of
        the 3 steps of a 12-image epoch at batch 4."""
        out = str(tmp_path / "ck")
        res = targets.run(
            [("ft", "case_finetune", (2, 2), dict(
                data_dir=labeled_dir, out=out, epochs=1, batch_size=4,
                learning_rate=1e-2, device="cpu",
                stage_layers=_LAYERS, input_size=32))],
            4, tmp_path / "w") if (tmp_path / "w").mkdir() is None else None
        outs = [r["ft"]["out"] for r in res]
        assert all(o["classes"] == ["green", "red"] for o in outs)
        assert all(np.isfinite(o["loss"]) for o in outs)
        for o in outs[1:]:
            for k, v in outs[0]["state"].items():
                np.testing.assert_array_equal(o["state"][k], v, err_msg=k)
        model = ResNet50V1(num_classes=2, dtype="bfloat16",
                           stage_layers=_LAYERS)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in outs[0]["state"].items()})
        want = dict(_leaves(resnet50_flax_from_state_dict(model)))
        got = dict(_leaves(jax_restore(out)))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        state = jax_restore(out + "_state")
        assert int(state["epoch"]) == 1
        assert int(state["opt_state"][0]["count"]) == 3
        mu = state["opt_state"][0]["mu"]["dense0"]
        assert mu["kernel"].shape == (2048, 2) and mu["bias"].shape == (2,)
