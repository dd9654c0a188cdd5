"""The port's train step against the JAX package's (models/train.py), on
the same weights carried over with models/convert.py: a ResNet50 with one
block per stage, 16 classes, 32 x 32 inputs, batch 4.

float32: the loss within rtol 1e-5 of JAX's make_train_step and
value_and_grad, the new batch_stats within rtol 1e-5 of each leaf's
largest magnitude (a running mean near zero is a sum that cancels). The
AdamW update against optax.adamw on identical gradients over three steps:
rtol 1e-6 of each leaf's largest magnitude (a bias that three steps of
about lr each bring back near zero differs below an ulp of the steps).

bfloat16 compute: the loss within rtol 1e-2. The gradients are not held
to a cosine of 0.99 of JAX's bfloat16 gradient: at this size bfloat16
gradients are noise-dominated in both packages (JAX's bfloat16 gradient
has a cosine of 0.85 with its own float32 one here, 0.80 on its worst
leaf). The port's bfloat16 gradient must be, as a whole, no further from
the float32 gradient than JAX's is (cosine within 0.01).

float32 gradients: each leaf within a relative L2 distance of 1e-4 of the
float64 gradient (JAX with x64 on the same batch), and no further from it
than JAX's own float32 gradient. They are not held to 1e-4 of JAX's
float32 gradient: at this shape the last stage is 1 x 1, its BatchNorm
reduces over four values and the fast variance E[x^2] - E[x]^2 cancels, so
JAX's float32 gradient itself lies 1.3e-4 from the float64 one (the
port's 6.7e-5); on other batches both lie up to 1e-2 from it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imageclust_tpu.models.resnet50 import ResNet50V1 as FlaxResNet
from imageclust_tpu.models.train import make_train_step as jax_train_step
from imageclust_tpu_torch.models import train
from imageclust_tpu_torch.models.convert import (
    flax_params_from_named,
    named_from_flax_params,
    resnet50_flax_from_state_dict,
    resnet50_state_dict_from_flax,
)
from imageclust_tpu_torch.models.resnet50 import ResNet50V1

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


def _batch(seed=1, n=4, size=32):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (n, 3, size, size)).astype(np.float32)
    labels = rng.integers(0, _CLASSES, n).astype(np.int32)
    return images, labels


def _flax(dtype=jnp.float32, seed=0):
    model = FlaxResNet(dtype=dtype, stage_layers=_LAYERS,
                       num_classes=_CLASSES)
    variables = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 3, 32, 32))))
    return model, variables


def _port(variables, dtype="float32"):
    model = ResNet50V1(num_classes=_CLASSES, dtype=dtype,
                       stage_layers=_LAYERS)
    model.load_state_dict(resnet50_state_dict_from_flax(variables))
    return model


def _jax_grads(model, variables, images, labels):
    def loss_fn(params):
        logits, upd = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(images), train=True, mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), jnp.asarray(labels)).mean()

    loss, grads = jax.value_and_grad(loss_fn)(variables["params"])
    return float(loss), jax.tree.map(np.asarray, grads)


def _port_step(model, images, labels):
    step = train.make_train_step(model, learning_rate=_LR)
    opt = train.init_opt_state(model)
    loss = step(model, opt, torch.from_numpy(images),
                torch.from_numpy(labels))
    grads = flax_params_from_named(
        {k: p.grad for k, p in model.named_parameters()})
    return float(loss), grads, opt


def _rel_l2(a, b):
    return np.linalg.norm(a.astype(np.float64) - b) / max(
        np.linalg.norm(b.astype(np.float64)), 1e-30)


def _cos(a, b):
    a = a.astype(np.float64).ravel()
    b = b.astype(np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))


class TestTrainStepF32:
    @pytest.fixture(scope="class")
    def both(self):
        flax_model, variables = _flax()
        images, labels = _batch()
        tx = optax.adamw(_LR)
        jstep = jax_train_step(flax_model, tx)
        new_vars, _, jloss = jstep(variables, tx.init(variables["params"]),
                                   jnp.asarray(images), jnp.asarray(labels))
        vloss, jgrads = _jax_grads(flax_model, variables, images, labels)
        with jax.enable_x64(True):
            m64 = FlaxResNet(dtype=jnp.float64, norm_dtype=jnp.float64,
                             stage_layers=_LAYERS, num_classes=_CLASSES)
            v64 = jax.tree.map(lambda a: np.asarray(a, np.float64),
                               variables)
            _, exact = _jax_grads(m64, v64, images.astype(np.float64),
                                  labels)
        port = _port(variables)
        ploss, pgrads, opt = _port_step(port, images, labels)
        return dict(jloss=float(jloss), vloss=vloss, jgrads=jgrads,
                    exact=exact, jvars=jax.tree.map(np.asarray, new_vars),
                    ploss=ploss, pgrads=pgrads, port=port, opt=opt)

    def test_loss(self, both):
        np.testing.assert_allclose(both["ploss"], both["jloss"], rtol=1e-5)
        np.testing.assert_allclose(both["ploss"], both["vloss"], rtol=1e-5)

    def test_gradients(self, both):
        exact = dict(_leaves(both["exact"]))
        jl = dict(_leaves(both["jgrads"]))
        pl = dict(_leaves(both["pgrads"]))
        assert jl.keys() == pl.keys() == exact.keys()
        port_err = max(_rel_l2(pl[k], exact[k]) for k in exact)
        jax_err = max(_rel_l2(jl[k], exact[k]) for k in exact)
        assert port_err < 1e-4, port_err
        assert port_err <= jax_err, (port_err, jax_err)

    def test_batch_stats(self, both):
        got = resnet50_flax_from_state_dict(both["port"])["batch_stats"]
        want = dict(_leaves(both["jvars"]["batch_stats"]))
        got = dict(_leaves(got))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(
                got[k], want[k], rtol=1e-5,
                atol=1e-5 * np.abs(want[k]).max(), err_msg=k)
        assert int(both["opt"][0]["count"]) == 1

    def test_running_var_is_biased(self):
        """The running variance takes E[x^2] - E[x]^2 (biased), not the
        unbiased estimate F.batch_norm would store."""
        from imageclust_tpu_torch.models.resnet50 import _BatchNorm

        bn = _BatchNorm(3)
        x = torch.from_numpy(np.random.default_rng(0).normal(
            2.0, 3.0, (2, 3, 2, 2)).astype(np.float32))
        bn(x, torch.float32, train=True)
        xd = x.double()
        var = xd.var(dim=(0, 2, 3), unbiased=False)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   (0.9 + 0.1 * var).numpy(), rtol=1e-5)
        np.testing.assert_allclose(
            bn.running_mean.numpy(),
            (0.1 * xd.mean(dim=(0, 2, 3))).numpy(), rtol=1e-5)


class TestAdamW:
    def test_three_steps_against_optax(self):
        rng = np.random.default_rng(3)
        model = ResNet50V1(num_classes=_CLASSES, dtype="float32",
                           stage_layers=_LAYERS).init_random(0)
        params = dict(model.named_parameters())
        tx = optax.adamw(_LR)
        jparams = flax_params_from_named(params)
        jstate = tx.init(jparams)
        opt = train.init_opt_state(model)
        for _ in range(3):
            g = {k: rng.normal(0, 1e-2, p.shape).astype(np.float32)
                 for k, p in params.items()}
            jg = flax_params_from_named(
                {k: torch.from_numpy(v) for k, v in g.items()})
            upd, jstate = tx.update(jg, jstate, jparams)
            jparams = optax.apply_updates(jparams, upd)
            train.adamw_update(params, {k: torch.from_numpy(v)
                                        for k, v in g.items()}, opt, _LR)
        got = dict(_leaves(flax_params_from_named(params)))
        for k, want in _leaves(jax.tree.map(np.asarray, jparams)):
            np.testing.assert_allclose(got[k], want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=k)
        np.testing.assert_allclose(
            dict(_leaves(train.opt_state_to_flax(opt)[0]["nu"]))[
                "dense0/kernel"],
            np.asarray(jstate[0].nu["dense0"]["kernel"]), rtol=1e-6)
        assert int(opt[0]["count"]) == int(jstate[0].count) == 3

    def test_state_round_trips_through_flax_layout(self):
        model = ResNet50V1(num_classes=_CLASSES, dtype="float32",
                           stage_layers=_LAYERS).init_random(1)
        opt = train.init_opt_state(model)
        rng = np.random.default_rng(4)
        for k, v in opt[0]["mu"].items():
            v.copy_(torch.from_numpy(rng.normal(size=v.shape)
                                     .astype(np.float32)))
        opt[0]["count"] = torch.tensor(7, dtype=torch.int32)
        back = train.opt_state_from_flax(train.opt_state_to_flax(opt), model)
        assert back[1] is None and back[2] is None
        assert int(back[0]["count"]) == 7
        for k, v in opt[0]["mu"].items():
            assert torch.equal(back[0]["mu"][k], v), k

    def test_optax_state_tree_matches(self):
        """The port's state has optax's tree: count int32, mu and nu shaped
        as params, two empty states."""
        model, variables = _flax()
        jstate = optax.adamw(_LR).init(variables["params"])
        port = _port(variables)
        flat = train.opt_state_to_flax(train.init_opt_state(port))
        assert len(flat) == len(jstate) == 3
        assert flat[0]["count"].dtype == np.int32
        assert jax.tree.structure(flat[0]["mu"]) == jax.tree.structure(
            jstate[0].mu)


class TestTrainStepBf16:
    def test_loss_and_gradient_cosine(self):
        flax_model, variables = _flax(jnp.bfloat16)
        images, labels = _batch(seed=5)
        vloss, jgrads = _jax_grads(flax_model, variables, images, labels)
        _, f32 = _jax_grads(_flax()[0], variables, images, labels)
        ploss, pgrads, _ = _port_step(_port(variables, "bfloat16"), images,
                                      labels)
        np.testing.assert_allclose(ploss, vloss, rtol=1e-2)

        def flat(tree):
            return np.concatenate([v.ravel() for _, v in _leaves(tree)])

        port_cos = _cos(flat(pgrads), flat(f32))
        jax_cos = _cos(flat(jgrads), flat(f32))
        assert port_cos >= jax_cos - 0.01, (port_cos, jax_cos)


class TestConvert:
    def test_inverse_round_trips_bit_identically(self):
        _, variables = _flax(seed=2)
        back = resnet50_flax_from_state_dict(_port(variables))
        want = dict(_leaves(variables))
        got = dict(_leaves(back))
        assert want.keys() == got.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    def test_state_dict_round_trips_bit_identically(self):
        model = ResNet50V1(num_classes=_CLASSES, stage_layers=_LAYERS,
                           fold_bn=True).init_random(3)
        sd = resnet50_state_dict_from_flax(
            resnet50_flax_from_state_dict(model))
        for k, v in model.state_dict().items():
            assert torch.equal(sd[k], v), k

    def test_named_params_reject_bad_shapes(self):
        model = ResNet50V1(num_classes=_CLASSES, stage_layers=_LAYERS)
        params = flax_params_from_named(dict(model.named_parameters()))
        params["dense0"]["bias"] = np.zeros(3, np.float32)
        shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
        with pytest.raises(ValueError, match="dense0.bias: shape"):
            named_from_flax_params(params, shapes)


class TestRefusals:
    def test_mesh_raises(self):
        """Formerly the refusal of the sharded step. An object that is not a
        Mesh is a TypeError; ``param_spec`` is the JAX package's rule on
        every leaf: the head's (out, in) weight sharded on its output rows
        where JAX shards the (in, out) kernel's columns, its bias likewise,
        every other leaf replicated. The sharded step itself:
        tests/test_torch_train_sharded.py."""
        from jax.sharding import PartitionSpec as P

        from imageclust_tpu.models.train import param_spec as jax_spec
        from imageclust_tpu_torch.models.convert import _flax_leaf

        model = ResNet50V1(num_classes=_CLASSES, stage_layers=_LAYERS)
        with pytest.raises(TypeError, match="Mesh"):
            train.make_train_step(model, mesh=object())
        with pytest.raises(TypeError, match="Mesh"):
            train.shard_variables({}, object())
        assert train.param_spec((), np.zeros(1)) == ()
        _, variables = _flax()
        want = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                variables)[0]:
            want["/".join(str(getattr(k, "key", k)) for k in path)] = \
                jax_spec(path, leaf)
        sharded = 0
        for name, t in model.state_dict().items():
            coll, path, _ = _flax_leaf(name, t.numpy())
            spec = want["/".join((coll, *path))]
            got = train.param_spec(name, t)
            if spec == P():
                assert got == (), name
            else:  # the torch layout transposes Flax's (in, out) kernel
                sharded += 1
                assert got == tuple(reversed(tuple(spec))) or (
                    len(spec) == 1 and got == tuple(spec)), (name, got, spec)
        assert sharded == 2  # dense0's kernel and bias

    def test_fold_bn_cannot_train(self):
        model = ResNet50V1(num_classes=_CLASSES, stage_layers=_LAYERS,
                           fold_bn=True)
        with pytest.raises(ValueError, match="fold_bn"):
            train.make_train_step(model)
        with pytest.raises(ValueError, match="fold_bn"):
            model(torch.zeros(1, 3, 32, 32), train=True)
