"""The embedder's train step on PyTorch (JAX ``models/train.py:69-131``).

One step is integer-label softmax cross entropy on the float32 logits,
averaged over the batch (train.py:98), through the tower in train mode
(BatchNorm on batch statistics, running statistics moved as Flax moves
them), autograd, and optax's ``adamw(lr)`` written out as torch ops in
optax's order:

    mu = b1*mu + (1-b1)*g            nu = b2*nu + (1-b2)*g^2
    mu_hat = mu / (1 - b1^t)         nu_hat = nu / (1 - b2^t)
    u = mu_hat / (sqrt(nu_hat) + eps) + wd * p;   p = p - lr * u

with b1 = 0.9, b2 = 0.999, eps = 1e-8 and wd = 1e-4 on every parameter,
BatchNorm scales and biases included. ``torch.optim.AdamW`` differs: its
default decay is 0.01 and it decays before the Adam step.

The optimizer state keeps optax's tree, ``(ScaleByAdamState(count, mu,
nu), EmptyState(), EmptyState())``, as ``({"count", "mu", "nu"}, None,
None)`` with ``mu``/``nu`` keyed by parameter name; :func:`opt_state_to_flax`
and :func:`opt_state_from_flax` turn it into the JAX package's layout, so
the two packages' ``_state`` checkpoints are interchangeable. ``count``
stays an int32 tensor on the host: the bias corrections are computed
there in float32 and no step waits on the card for them.

The JAX package shards this step over a (data, model) mesh; that half is
not ported yet (ROADMAP.md queue 1, item 15), so ``mesh=``,
:func:`param_spec` and :func:`shard_variables` raise.
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["make_train_step", "init_opt_state",
           "adamw_update", "opt_state_to_flax", "opt_state_from_flax",
           "param_spec", "shard_variables", "WEIGHT_DECAY"]

B1, B2, EPS = 0.9, 0.999, 1e-8
WEIGHT_DECAY = 1e-4  # optax.adamw's default


def _mesh_not_ported(what: str):
    raise NotImplementedError(
        f"{what}: the sharded (data x model mesh) train step is not ported "
        f"yet (ROADMAP.md queue 1, item 15)")


def param_spec(path, leaf):
    """The JAX package's sharding rule; waits for the multi-device half."""
    _mesh_not_ported("param_spec")


def shard_variables(variables, mesh):
    """The JAX package's mesh placement; waits for the multi-device half."""
    _mesh_not_ported("shard_variables")


def init_opt_state(model: torch.nn.Module) -> tuple:
    """``optax.adamw(lr).init(params)``: count 0 and zero moments."""
    params = dict(model.named_parameters())
    return ({"count": torch.zeros((), dtype=torch.int32),
             "mu": {k: torch.zeros_like(p) for k, p in params.items()},
             "nu": {k: torch.zeros_like(p) for k, p in params.items()}},
            None, None)


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], opt_state: tuple,
                 learning_rate: float,
                 weight_decay: float = WEIGHT_DECAY) -> None:
    """One optax ``adamw`` update of ``params`` in place from ``grads``,
    advancing ``opt_state`` (see the module docstring for the order)."""
    adam = opt_state[0]
    count = adam["count"] + 1  # optax safe_increment, int32 on the host
    t = count.item()
    # 1 - b^t in float32 from the float32 b, with the power rounded once
    # (what XLA's pow gives; numpy's float32 power is off by an ulp)
    bc1 = float(np.float32(1) - np.float32(float(np.float32(B1)) ** t))
    bc2 = float(np.float32(1) - np.float32(float(np.float32(B2)) ** t))
    names = list(params)
    p = [params[k] for k in names]
    g = [grads[k] for k in names]
    mu = [adam["mu"][k] for k in names]
    nu = [adam["nu"][k] for k in names]
    torch._foreach_mul_(mu, B1)
    torch._foreach_add_(mu, torch._foreach_mul(g, 1 - B1))
    g2 = torch._foreach_mul(g, g)
    torch._foreach_mul_(g2, 1 - B2)
    torch._foreach_mul_(nu, B2)
    torch._foreach_add_(nu, g2)
    denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
    torch._foreach_add_(denom, EPS)
    u = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
    torch._foreach_add_(u, torch._foreach_mul(p, weight_decay))
    torch._foreach_mul_(u, -learning_rate)
    torch._foreach_add_(p, u)
    adam["count"] = count


def make_train_step(model: torch.nn.Module, learning_rate: float = 1e-3,
                    weight_decay: float = WEIGHT_DECAY,
                    mesh=None) -> Callable:
    """Build ``step(model, opt_state, images, labels) -> loss``: one AdamW
    step of ``model`` (updated in place, its ``.grad`` left holding this
    step's gradients) on an NCHW float batch and integer labels. The
    loss comes back as a 0-d tensor on the model's device."""
    if mesh is not None:
        _mesh_not_ported("make_train_step(mesh=...)")
    if getattr(model, "fold_bn", False):
        raise ValueError("fold_bn is an inference layout; train needs BN")

    def step(model, opt_state, images, labels):
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        # batch statistics, running ones moved (JAX train.py:85-98)
        logits = model(images, train=True)
        loss = F.cross_entropy(logits.float(), labels.long())
        loss.backward()
        adamw_update(params, {k: p.grad for k, p in params.items()},
                     opt_state, learning_rate, weight_decay)
        return loss.detach()

    return step


def opt_state_to_flax(opt_state: tuple) -> tuple:
    """The state as the JAX package's optax tree of numpy arrays: moments
    as Flax ``params`` trees (HWIO kernels, (in, out) Dense)."""
    from imageclust_tpu_torch.models.convert import flax_params_from_named

    adam = opt_state[0]
    return ({"count": np.asarray(adam["count"].item(), np.int32),
             "mu": flax_params_from_named(adam["mu"]),
             "nu": flax_params_from_named(adam["nu"])}, None, None)


def opt_state_from_flax(tree, model: torch.nn.Module) -> tuple:
    """The inverse of :func:`opt_state_to_flax`, with the moments on
    ``model``'s device. Raises ValueError on a missing, extra or
    mis-shaped moment."""
    from imageclust_tpu_torch.models.convert import named_from_flax_params

    adam = tree[0]
    params = dict(model.named_parameters())
    moments = {}
    for which in ("mu", "nu"):
        named = named_from_flax_params(adam[which], {
            k: tuple(p.shape) for k, p in params.items()})
        moments[which] = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            params[k].device, torch.float32) for k, v in named.items()}
    count = torch.tensor(int(np.asarray(adam["count"])), dtype=torch.int32)
    return ({"count": count, **moments}, None, None)
