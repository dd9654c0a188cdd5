"""Targets that the port's mesh tests start on every rank through
``imageclust_tpu_torch.parallel.launch_processes``.

It holds no test (pytest collects nothing here) and imports no JAX: a
worker imports torch and the port alone. :func:`run_cases` reads a pickled
list of cases from ``IMAGECLUST_MP_IN``, runs each on the mesh its case
names, and writes every rank's results, with the collective counters of
each case, to ``IMAGECLUST_MP_OUT/rank<r>.pkl``; the tests compare them
with the JAX package and the single-device port in their own process.
"""

from __future__ import annotations

import os
import pickle
import time


def _mesh(spec):
    from imageclust_tpu_torch.core.mesh import create_mesh

    data, model = spec
    return create_mesh(data=data, model=model,
                       device=os.environ.get("IMAGECLUST_MP_DEVICE", "cpu"))


def _summary(res) -> dict:
    out = {"cluster_map": res.cluster_map, "dropped": res.dropped,
           "merges": res.merges}
    for k in ("loop_stats", "n_buckets"):
        if hasattr(res, k):
            out[k] = getattr(res, k)
    return out


def case_exact(mesh, x, **kw):
    from imageclust_tpu_torch.cluster.ward import constrained_ward

    return _summary(constrained_ward(x, mesh=mesh, **kw))


def case_bucketed(mesh, x, sharded=False, kmeans_idx=None, **kw):
    """``kmeans_idx``: the rows k-means starts from (the JAX package's
    draw, so that the buckets are the JAX engine's)."""
    import torch

    from imageclust_tpu_torch.cluster import sharded as tsh
    from imageclust_tpu_torch.core.mesh import local_rows

    draw = tsh._kmeans_init_idx
    if kmeans_idx is not None:
        tsh._kmeans_init_idx = (
            lambda n, k, seed: torch.from_numpy(kmeans_idx[:k].copy()))
    try:
        arg = local_rows(x, mesh) if sharded else x
        res = tsh.constrained_ward_bucketed(arg, mesh=mesh, **kw)
    finally:
        tsh._kmeans_init_idx = draw
    out = _summary(res)
    out["exchange"] = getattr(res, "exchange", None)
    return out


def case_chain(mesh, x, impl="rnn", sharded=False, **kw):
    from imageclust_tpu_torch.cluster.chain import constrained_ward_chain
    from imageclust_tpu_torch.core.mesh import local_rows

    os.environ["IMAGECLUST_CHAIN_IMPL"] = impl
    try:
        arg = local_rows(x, mesh) if sharded else x
        return _summary(constrained_ward_chain(arg, mesh=mesh, **kw))
    finally:
        os.environ.pop("IMAGECLUST_CHAIN_IMPL", None)


def case_train(mesh, state, images, labels, num_classes, stage_layers):
    """One sharded step of a float32 ResNet50V1 loaded from ``state`` (a
    torch state dict of numpy arrays) on the global batch: the loss, the
    whole new state, the whole gradient of every parameter."""
    import torch

    from imageclust_tpu_torch.core.collectives import all_gather_rows
    from imageclust_tpu_torch.models.resnet50 import ResNet50V1
    from imageclust_tpu_torch.models.train import (
        gather_variables,
        init_opt_state,
        make_train_step,
        param_spec,
        shard_model,
    )

    model = ResNet50V1(num_classes=num_classes, dtype="float32",
                       stage_layers=stage_layers)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           state.items()})
    shard_model(model, mesh)
    opt = init_opt_state(model)
    loss = make_train_step(model, mesh=mesh)(
        model, opt, torch.from_numpy(images).to(mesh.device),
        torch.from_numpy(labels).to(mesh.device))
    grads = {}
    for k, p in model.named_parameters():
        g = p.grad
        if param_spec(k, p):
            g = all_gather_rows(g.contiguous(), mesh, "model")
        grads[k] = g.cpu().numpy()
    return {"loss": float(loss), "grads": grads,
            "state": {k: v.numpy() for k, v in
                      gather_variables(model, mesh).items()},
            "shard_shapes": {k: tuple(p.shape) for k, p in
                             model.named_parameters()},
            "moment_shapes": {k: tuple(v.shape)
                              for k, v in opt[0]["mu"].items()}}


def case_finetune(mesh, data_dir, out, **kw):
    """``finetune_resnet50`` over the mesh; every rank returns the whole
    tuned model's state and the last epoch's loss."""
    from imageclust_tpu_torch.models.finetune import finetune_resnet50

    model, classes, loss = finetune_resnet50(data_dir, out, mesh=mesh, **kw)
    return {"loss": loss, "classes": classes,
            "state": {k: v.numpy() for k, v in model.state_dict().items()}}


def case_pipeline(mesh, paths, work, cluster, labels="fake", run="paths",
                  kmeans_idx=None, max_size=8, fail_naming=False):
    """``Pipeline.run_paths`` (or ``run_stream`` on the decoded images,
    ``run="stream"``) over the mesh with the mean-colour tower, k-means
    started from ``kmeans_idx`` when given; returns the partition by image
    name, the dropped names and what the job wrote. ``fail_naming`` makes
    rank 0's namer raise."""
    import torch

    from imageclust_tpu_torch.cluster import sharded as tsh

    if kmeans_idx is not None:
        tsh._kmeans_init_idx = (
            lambda n, k, seed: torch.from_numpy(kmeans_idx[:k].copy()))
    from imageclust_tpu_torch.config import (
        AppConfig,
        ClusterConfig,
        LabelConfig,
        NamingConfig,
    )
    from imageclust_tpu_torch.parallel._worker import mean_color_embedder
    from imageclust_tpu_torch.pipeline import Pipeline

    cfg = AppConfig(labels=LabelConfig(backend=labels),
                    naming=NamingConfig(services=("fake",), retries=1),
                    cluster=ClusterConfig(**cluster))
    pipe = Pipeline(cfg, mesh=mesh, embedder=mean_color_embedder(mesh))
    if fail_naming and mesh.rank == 0:
        def name_clusters(*args, **kwargs):
            raise RuntimeError("namer down on rank 0")

        pipe.naming.name_clusters = name_clusters
    if run == "stream":
        from imageclust_tpu_torch.data.loader import decode_images

        blobs = [open(p, "rb").read() for p in paths]
        imgs = decode_images(blobs, size=16)
        chunks = (imgs[s:s + 8] for s in range(0, len(imgs), 8))
        res = pipe.run_stream(chunks, len(imgs), work, min_size=3,
                              max_size=max_size)
    else:
        res = pipe.run_paths(paths, work, min_size=3, max_size=max_size)
    return {"partition": sorted(sorted(d.images)
                                for d in res.clusters.values()),
            "dropped": res.dropped,
            "labels": all(d.labels for d in res.clusters.values()),
            "titles": all(d.title for d in res.clusters.values()),
            "report": os.path.exists(res.html_path),
            "counters": res.metrics.counters}


def case_collectives(mesh):
    """Every collective wrapper on rank-dependent values."""
    import torch

    from imageclust_tpu_torch.core import collectives as cc

    r = mesh.rank
    dev = mesh.device
    out = {"rank": r, "coords": mesh.coords}
    x = torch.arange(3, dtype=torch.float32, device=dev) + 10 * r
    out["psum_data"] = cc.psum(x, mesh).cpu().numpy()
    out["psum_model"] = cc.psum(x, mesh, axis="model").cpu().numpy()
    out["psum_world"] = cc.psum(x, mesh, axis=None).cpu().numpy()
    out["gather"] = cc.all_gather_rows(x[None], mesh).cpu().numpy()
    size = mesh.shape["data"]
    send = torch.stack([torch.full((2,), 100 * r + j, dtype=torch.int32,
                                   device=dev) for j in range(size)])
    out["all_to_all"] = cc.all_to_all_rows(send, mesh).cpu().numpy()
    # ties: every rank holds distance 1.0 at element 0 (the smallest index
    # must win), the smallest distance once at element 1, inf at element 2
    d = torch.tensor([1.0, 5.0 - r, float("inf")], device=dev)
    idx = torch.tensor([7 - r, 50 + r, 90 + r], dtype=torch.int64,
                       device=dev)
    gd, gi = cc.pmin_pair(d, idx, mesh)
    out["pmin"] = (gd.cpu().numpy(), gi.cpu().numpy())
    out["bcast"] = cc.broadcast(torch.tensor([r + 1.0], device=dev),
                                mesh, src=mesh.size - 1).cpu().numpy()
    out["objects"] = cc.gather_objects({"r": r}, mesh)
    out["strict_f32"] = {
        "cudnn_tf32": torch.backends.cudnn.allow_tf32,
        "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
        "bf16_reduced": torch.backends.cuda.matmul.
        allow_bf16_reduced_precision_reduction}
    return out


def case_rows(mesh):
    """Global rows of a row-sharded array (float32 and int8), the
    elementwise max and a call on one rank, on rank-dependent values."""
    import torch

    from imageclust_tpu_torch.core import collectives as cc
    from imageclust_tpu_torch.core.mesh import local_rows

    r = mesh.rank
    host = torch.arange(7 * 2, dtype=torch.float32).reshape(7, 2) - 5
    idx = torch.tensor([6, 0, 3, 3])
    out = {"take": local_rows(host, mesh).take(idx).cpu().numpy(),
           "take_int8": local_rows(host.to(torch.int8), mesh).take(idx)}
    out["take_int8"] = out["take_int8"].cpu().numpy()
    out["pmax"] = cc.pmax(torch.tensor([float(r), -float(r)],
                                       device=mesh.device), mesh)
    out["pmax"] = out["pmax"].cpu().numpy()
    out["on_rank"] = cc.on_rank(lambda: {"from": r}, mesh, src=mesh.size - 1)
    return out


def case_verify(mesh, fn: str) -> str:
    """One of ``parallel/_worker.py``'s ``verify_*`` bodies on the world's
    process group; returns what it printed."""
    import contextlib
    import io

    from imageclust_tpu_torch.parallel import _worker

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        getattr(_worker, fn)()
    return out.getvalue()


def run_cases() -> None:
    import torch.distributed as dist

    from imageclust_tpu_torch.core.collectives import COUNTERS

    with open(os.environ["IMAGECLUST_MP_IN"], "rb") as fh:
        cases = pickle.load(fh)
    results = {}
    meshes = {}
    for name, fn_name, mesh_spec, kw in cases:
        if mesh_spec not in meshes:
            meshes[mesh_spec] = _mesh(mesh_spec)
        COUNTERS.reset()
        t0 = time.perf_counter()
        out = globals()[fn_name](meshes[mesh_spec], **kw)
        results[name] = {"out": out, "counters": COUNTERS.snapshot(),
                         "s": time.perf_counter() - t0}
    path = os.path.join(os.environ["IMAGECLUST_MP_OUT"],
                        f"rank{dist.get_rank()}.pkl")
    with open(path, "wb") as fh:
        pickle.dump(results, fh)


def no_jax() -> None:
    """A rank runs the mesh engines, the embedder and the train step
    without JAX or the JAX package in its interpreter."""
    import sys

    from imageclust_tpu_torch.parallel._worker import (
        verify_bucketed,
        verify_psum,
    )

    verify_psum()
    verify_bucketed()
    import imageclust_tpu_torch.cluster.chain  # noqa: F401
    import imageclust_tpu_torch.models.finetune  # noqa: F401
    import imageclust_tpu_torch.pipeline  # noqa: F401

    loaded = sorted(m for m in ("jax", "jaxlib", "flax", "optax",
                                "imageclust_tpu") if m in sys.modules)
    assert not loaded, loaded
    print("no jax ok", flush=True)


def hang() -> None:
    """Target for the launcher's timeout: never returns."""
    while True:
        time.sleep(1)


def run(cases, ranks: int, tmp_path, timeout: float = 110.0, env=None,
        logs: list | None = None):
    """Run ``cases`` over ``ranks`` CPU ranks (gloo); returns the list of
    each rank's results. ``logs``, when given, receives each rank's log."""
    from imageclust_tpu_torch.parallel import launch_processes

    src = os.path.join(str(tmp_path), "cases.pkl")
    with open(src, "wb") as fh:
        pickle.dump(cases, fh)
    outs = launch_processes(
        "tests.test_torch_mesh_targets:run_cases", ranks, timeout=timeout,
        env={**(env or {}), "IMAGECLUST_MP_IN": src,
             "IMAGECLUST_MP_OUT": str(tmp_path)})
    if logs is not None:
        logs.extend(outs)
    out = []
    for r in range(ranks):
        with open(os.path.join(str(tmp_path), f"rank{r}.pkl"), "rb") as fh:
            out.append(pickle.load(fh))
    return out
