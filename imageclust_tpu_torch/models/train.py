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

With ``mesh=`` (JAX train.py:117-130) the step is DP x TP over a (data,
model) :class:`~imageclust_tpu_torch.core.mesh.Mesh`, one rank per device:
each rank takes its ``data`` share of the global batch; the head
``dense0`` (or a ``projection`` Linear) is sharded by output rows over
``model`` (:func:`param_spec`) and everything else replicated; BatchNorm
normalises with the global batch's statistics (the float32 sums of x and
x^2 psum'd over ``data``, differentiably); the head's logits are gathered
over ``model`` before the float32 softmax cross entropy; the loss is the
mean over the global batch and the gradients are psum'd over ``data``.
The AdamW moments follow their parameter (they are created from the
rank's shards); the count is replicated.
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["make_train_step", "init_opt_state",
           "adamw_update", "opt_state_to_flax", "opt_state_from_flax",
           "param_spec", "shard_variables", "variable_shardings",
           "opt_shardings", "shard_model", "gather_variables",
           "gather_opt_state", "shard_opt_state", "WEIGHT_DECAY"]

B1, B2, EPS = 0.9, 0.999, 1e-8
WEIGHT_DECAY = 1e-4  # optax.adamw's default


def param_spec(path, leaf) -> tuple:
    """The sharding rule (JAX train.py:41-51): the wide head (``dense0``, or
    a ``projection`` Linear) is sharded on its output dimension over
    ``model``; everything else is replicated. ``path`` is a state-dict
    name (``"dense0.weight"``) or a sequence of path components. Returns
    the mesh axis of each dimension of the torch tensor: ``("model",
    None)`` for the head's (out, in) weight (JAX's ``P(None, "model")`` on
    the (in, out) Flax kernel), ``("model",)`` for its bias, ``()`` for a
    replicated leaf."""
    names = (path.split(".") if isinstance(path, str)
             else [str(getattr(p, "key", p)) for p in path])
    joined = "/".join(names)
    if "dense0" in joined or "projection" in joined:
        ndim = len(getattr(leaf, "shape", ()))
        if names[-1] in ("weight", "kernel") and ndim == 2:
            return ("model", None)
        if names[-1] == "bias" and ndim == 1:
            return ("model",)
    return ()


def variable_shardings(variables: Mapping, mesh) -> dict:
    """Each leaf's :func:`param_spec` (JAX train.py:62)."""
    from imageclust_tpu_torch.core.mesh import check_mesh

    check_mesh(mesh)
    return {k: param_spec(k, v) for k, v in variables.items()}


def opt_shardings(opt_state: tuple) -> tuple:
    """The AdamW state's specs (JAX ``_opt_shardings``, train.py:133): the
    moments follow their parameter, the count is replicated."""
    adam = opt_state[0]
    return ({"count": (),
             "mu": {k: param_spec(k, v) for k, v in adam["mu"].items()},
             "nu": {k: param_spec(k, v) for k, v in adam["nu"].items()}},
            None, None)


def _shard(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``."""
    if "model" not in spec:
        return t
    dim = spec.index("model")
    parts = mesh.shape["model"]
    if t.shape[dim] % parts:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"split over model={parts}")
    return torch.chunk(t, parts, dim=dim)[mesh.index("model")]


def shard_variables(variables: Mapping, mesh) -> dict:
    """This rank's share of a state dict per :func:`param_spec`, on the
    mesh's device (JAX train.py:54)."""
    from imageclust_tpu_torch.core.mesh import check_mesh

    check_mesh(mesh)
    return {k: _shard(v, param_spec(k, v), mesh).to(mesh.device)
            for k, v in variables.items()}


@torch.no_grad()
def shard_model(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """``model`` moved to the mesh's device with its head cut to this
    rank's rows, in place (the layout :func:`make_train_step` with
    ``mesh`` takes)."""
    model.to(mesh.device)
    for name, p in list(model.named_parameters()):
        spec = param_spec(name, p)
        if spec:
            mod_name, _, attr = name.rpartition(".")
            mod = model.get_submodule(mod_name)
            setattr(mod, attr, torch.nn.Parameter(
                _shard(p.detach(), spec, mesh).clone()))
    return model


def gather_opt_state(opt_state: tuple, mesh) -> tuple:
    """The whole AdamW state of a sharded model on every rank (its head's
    moments all-gathered over ``model``), on the host."""
    from imageclust_tpu_torch.core.collectives import all_gather_rows

    adam = opt_state[0]
    out = {"count": adam["count"]}
    for which in ("mu", "nu"):
        out[which] = {
            k: (all_gather_rows(v.contiguous(), mesh, "model")
                if param_spec(k, v) else v).cpu()
            for k, v in adam[which].items()}
    return (out, None, None)


def shard_opt_state(opt_state: tuple, mesh) -> tuple:
    """This rank's share of a whole AdamW state (:func:`opt_shardings`),
    on the mesh's device."""
    adam = opt_state[0]
    return ({"count": adam["count"],
             "mu": shard_variables(adam["mu"], mesh),
             "nu": shard_variables(adam["nu"], mesh)}, None, None)


def gather_variables(model: torch.nn.Module, mesh) -> dict:
    """The whole state dict of a sharded model on every rank (its head's
    rows all-gathered over ``model``), on the host."""
    from imageclust_tpu_torch.core.collectives import all_gather_rows

    out = {}
    for k, v in model.state_dict().items():
        spec = param_spec(k, v)
        if spec:  # the sharded dim is dim 0 of torch's (out, in) layout
            v = all_gather_rows(v.detach().contiguous(), mesh, "model")
        out[k] = v.detach().cpu()
    return out


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
    loss comes back as a 0-d tensor on the model's device.

    With ``mesh`` the step is the sharded one (module docstring): every
    rank calls it with the same global batch (its size a multiple of the
    ``data`` axis) and a model from :func:`shard_model`; each rank's
    ``.grad`` holds the global gradient of its shard, and every rank gets
    the global loss."""
    from imageclust_tpu_torch.core.mesh import check_mesh

    if getattr(model, "fold_bn", False):
        raise ValueError("fold_bn is an inference layout; train needs BN")
    if check_mesh(mesh) is not None:
        return _sharded_step(learning_rate, weight_decay, mesh)

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


class _SumOverData(torch.autograd.Function):
    """A psum over ``data`` whose gradient is the psum of the gradients
    (each rank's loss reads the global sum)."""

    @staticmethod
    def forward(ctx, x, mesh):
        from imageclust_tpu_torch.core.collectives import psum

        ctx.mesh = mesh
        return psum(x, mesh, "data")

    @staticmethod
    def backward(ctx, g):
        from imageclust_tpu_torch.core.collectives import psum

        return psum(g.contiguous(), ctx.mesh, "data"), None


class _CopyToModel(torch.autograd.Function):
    """Identity on the head's input; its gradient is psum'd over ``model``
    (every head shard contributes to it)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from imageclust_tpu_torch.core.collectives import psum

        return psum(g.contiguous(), ctx.mesh, "model"), None


class _GatherFromModel(torch.autograd.Function):
    """The head shards' (b, out / M) logits gathered to (b, out) over
    ``model``; the gradient is this rank's columns."""

    @staticmethod
    def forward(ctx, x, mesh):
        from imageclust_tpu_torch.core.collectives import all_gather_rows

        ctx.mesh, ctx.cols = mesh, x.shape[1]
        return all_gather_rows(x.T.contiguous(), mesh, "model").T

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh.index("model")
        return g[:, m * ctx.cols:(m + 1) * ctx.cols], None


def _sharded_step(learning_rate: float, weight_decay: float, mesh):
    from imageclust_tpu_torch.core.collectives import psum
    from imageclust_tpu_torch.core.mesh import row_block
    from imageclust_tpu_torch.models.resnet50 import _BatchNorm

    ndata = mesh.shape["data"]

    def stat_sum(sums, count):
        return _SumOverData.apply(sums, mesh), count * ndata

    def step(model, opt_state, images, labels):
        total = images.shape[0]
        if total % ndata:
            raise ValueError(f"global batch {total} does not split over "
                             f"data={ndata}")
        r0, b = row_block(total, mesh)
        images, labels = images[r0:r0 + b], labels[r0:r0 + b]
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        bns = [m for m in model.modules() if isinstance(m, _BatchNorm)]
        for bn in bns:
            bn.stat_sum = stat_sum
        try:
            _, pooled = model(images, return_features=True, train=True)
        finally:
            for bn in bns:
                bn.stat_sum = None
        head = model.dense0
        logits = _GatherFromModel.apply(F.linear(
            _CopyToModel.apply(pooled, mesh), head.weight, head.bias), mesh)
        loss = F.cross_entropy(logits.float(), labels.long(),
                               reduction="sum") / total
        loss.backward()
        names = list(params)
        flat = psum(torch.cat([params[k].grad.reshape(-1) for k in names]),
                    mesh, "data")
        grads, at = {}, 0
        for k in names:
            p = params[k]
            p.grad.copy_(flat[at:at + p.numel()].view_as(p))
            grads[k] = p.grad
            at += p.numel()
        adamw_update(params, grads, opt_state, learning_rate, weight_decay)
        return psum(loss.detach(), mesh, "data")

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
