"""Entry point of one rank started by
:func:`imageclust_tpu_torch.parallel.launch_processes`.

Each worker is a fresh interpreter: it takes one thread, joins the process
group through :func:`imageclust_tpu_torch.core.mesh.init_distributed` (the
function a torchrun job calls), runs the ``module:function`` in
``IMAGECLUST_MP_TARGET``, prints the OK sentinel and leaves the group.

The ``verify_*`` bodies below (counterparts of
``imageclust_tpu/parallel/_worker.py``) are targets for it; each asserts on
the global result, so a run that passes shows the ranks exchanged data.
"""

from __future__ import annotations

import importlib
import os


def main() -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from imageclust_tpu_torch.core.mesh import init_distributed
    from imageclust_tpu_torch.parallel import OK_SENTINEL

    if not init_distributed():
        raise RuntimeError(
            "worker launched without RANK / WORLD_SIZE in its environment")
    mod_name, fn_name = os.environ["IMAGECLUST_MP_TARGET"].rsplit(":", 1)
    getattr(importlib.import_module(mod_name), fn_name)()
    dist.barrier()
    print(OK_SENTINEL, flush=True)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Verification bodies (targets for launch_processes)
# ---------------------------------------------------------------------------


def _device() -> str:
    return os.environ.get("IMAGECLUST_MP_DEVICE", "cpu")


def global_mesh():
    """The (data, model) mesh over every rank: model=2 when the world is
    even, as the JAX workers lay theirs."""
    import torch.distributed as dist

    from imageclust_tpu_torch.core.mesh import create_mesh

    n = dist.get_world_size()
    model = 2 if n % 2 == 0 else 1
    return create_mesh(data=n // model, model=model, device=_device())


def data_mesh():
    """Every rank on ``data``."""
    from imageclust_tpu_torch.core.mesh import create_mesh

    return create_mesh(data=-1, model=1, device=_device())


def verify_psum() -> None:
    """A psum over ``data`` and over the world."""
    import torch

    from imageclust_tpu_torch.core.collectives import psum

    mesh = global_mesh()
    n = mesh.size
    x = torch.tensor([float(mesh.rank)], device=mesh.device)
    world = float(psum(x, mesh, axis=None))
    want = n * (n - 1) / 2
    assert world == want, f"psum over the world: got {world}, want {want}"
    data = float(psum(x, mesh, axis="data"))
    m = mesh.index("model")
    want_d = sum(d * mesh.shape["model"] + m
                 for d in range(mesh.shape["data"]))
    assert data == want_d, f"psum over data: got {data}, want {want_d}"
    print(f"psum ok: {world} over {n} ranks", flush=True)


def verify_train_step() -> None:
    """One DP x TP step of a narrow ResNet on the global mesh against the
    single-device step on the same weights and batch: the float32 loss
    within rtol 1e-5, the new BatchNorm statistics within 1e-5 relative
    L2, and each gradient leaf within 1e-4 relative L2. (The parameters
    themselves are not compared: AdamW's first step moves each by about
    lr * sign(g), so a gradient that is zero up to rounding, such as a
    dead channel's, can take either sign on either path.)"""
    import copy

    import numpy as np
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

    mesh = global_mesh()
    full = ResNet50V1(num_classes=8, dtype="float32",
                      stage_layers=(1, 1, 1, 1)).init_random(0)
    ref = copy.deepcopy(full).to(mesh.device)
    model = shard_model(copy.deepcopy(full), mesh)
    rng = np.random.default_rng(0)
    batch = 4 * mesh.shape["data"]
    images = torch.from_numpy(rng.normal(size=(batch, 3, 64, 64)).astype(
        np.float32)).to(mesh.device)
    labels = torch.from_numpy(rng.integers(0, 8, batch)).to(mesh.device)
    loss = make_train_step(model, mesh=mesh)(
        model, init_opt_state(model), images, labels)
    ref_loss = make_train_step(ref)(ref, init_opt_state(ref), images, labels)
    assert np.isfinite(float(loss)), f"non-finite loss {float(loss)}"
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)

    def rel(a, b):
        a, b = a.double().cpu(), b.double().cpu()
        return float(torch.linalg.vector_norm(a - b)
                     / max(float(torch.linalg.vector_norm(b)), 1e-30))

    ref_params = dict(ref.named_parameters())
    for k, p in model.named_parameters():
        g = p.grad
        if param_spec(k, p):
            g = all_gather_rows(g.contiguous(), mesh, "model")
        err = rel(g, ref_params[k].grad)
        assert err <= 1e-4, f"{k}: gradient relative L2 {err}"
    got = gather_variables(model, mesh)
    for k, v in ref.state_dict().items():
        if "running" in k:
            assert rel(got[k], v) <= 1e-5, f"{k}: {rel(got[k], v)}"
    print(f"train step ok: loss {float(loss):.4f} on {mesh}", flush=True)


def verify_bucketed() -> None:
    """The bucketed engine over the mesh's ``data`` ranks equals the
    single-device engine (the exchange only moves rows), in float32 and
    int8 residency."""
    import numpy as np

    from imageclust_tpu_torch.cluster.sharded import constrained_ward_bucketed

    mesh = data_mesh()
    x = np.random.default_rng(0).normal(
        size=(mesh.size * 24, 16)).astype(np.float32)
    for dtype in ("float32", "int8"):
        kw = dict(min_size=3, max_size=6, bucket_size=32,
                  feature_dtype=dtype, device=mesh.device)
        res = constrained_ward_bucketed(x, mesh=mesh, **kw)
        ref = constrained_ward_bucketed(x, **kw)
        assert res.cluster_map == ref.cluster_map, f"{dtype}: diverged"
        assert res.dropped == ref.dropped == []
    print(f"bucketed ok: {res.n_clusters} clusters on {mesh}", flush=True)


def mean_color_embedder(mesh=None, device="cpu", batch_size: int = 8):
    """An ``Embedder`` around a tiny tower for mesh pipeline runs: ten
    times each image's mean colour plus a bias, the JAX package's mesh
    tests' tower."""
    import torch

    from imageclust_tpu_torch.models.registry import Embedder, EmbedderSpec

    class _Tower(torch.nn.Module):
        stem_mode = "standard"

        def __init__(self):
            super().__init__()
            self.b = torch.nn.Parameter(torch.zeros(3))

        def forward(self, x, return_features=False, stem_mode=None):
            y = x.float().mean(dim=(1, 2)) * 10.0 + self.b
            return (y, y) if return_features else y

    spec = EmbedderSpec(name="toy", input_size=16, dim=3, scale=1 / 255.0,
                        mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0),
                        bgr_input=True)
    return Embedder(spec, _Tower(), batch_size=batch_size,
                    device=mesh.device if mesh else device,
                    tag="toy:mp-pipeline", mesh=mesh)


def verify_pipeline() -> None:
    """``Pipeline.run_paths`` over the mesh (each rank decodes and embeds
    its row block; bucketed clustering over the ranks) against the
    single-process pipeline in the same interpreter: the same partition.

    Needs IMAGECLUST_MP_IMAGES (a directory of images every rank reads)
    and IMAGECLUST_MP_WORK (scratch root)."""
    import glob

    from imageclust_tpu_torch.config import (
        AppConfig,
        ClusterConfig,
        LabelConfig,
        NamingConfig,
    )
    from imageclust_tpu_torch.pipeline import Pipeline

    mesh = data_mesh()
    paths = sorted(glob.glob(os.path.join(
        os.environ["IMAGECLUST_MP_IMAGES"], "*")))
    assert paths, "no images shared with the workers"
    work = os.environ["IMAGECLUST_MP_WORK"]

    def cfg():
        return AppConfig(
            labels=LabelConfig(backend="fake"),
            naming=NamingConfig(services=("fake",), retries=1),
            cluster=ClusterConfig(exact_limit=4, bucket_size=16))

    res = Pipeline(cfg(), mesh=mesh,
                   embedder=mean_color_embedder(mesh)).run_paths(
        paths, os.path.join(work, f"mesh_r{mesh.rank}"), min_size=3,
        max_size=8)
    ref = Pipeline(cfg(), device=mesh.device,
                   embedder=mean_color_embedder(device=mesh.device)).run_paths(
        paths, os.path.join(work, f"one_r{mesh.rank}"), min_size=3,
        max_size=8)
    part = {frozenset(d.images) for d in res.clusters.values()}
    assert part == {frozenset(d.images) for d in ref.clusters.values()}, \
        "mesh pipeline partition diverged"
    assert res.dropped == ref.dropped == []
    if mesh.rank == 0:
        assert os.path.exists(res.html_path), "mesh job wrote no report"
    for d in res.clusters.values():
        assert d.labels and d.title  # labels and naming flowed through
    print(f"pipeline ok: {len(res.clusters)} clusters on {mesh}", flush=True)


def verify_all() -> None:
    """psum, the train step and the bucketed engine in one launch."""
    verify_psum()
    verify_train_step()
    verify_bucketed()


def _fail() -> None:  # target for the launcher's failure report
    raise RuntimeError("intentional worker failure")


if __name__ == "__main__":
    main()
