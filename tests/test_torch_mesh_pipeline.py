"""``Pipeline`` over a mesh of four gloo ranks against the single-process
port and the JAX package's mesh pipeline (tests/test_mesh_pipeline.py:79
and tests/test_multiprocess.py:33): the same partition and dropped set,
exactly, on colour-group images. The bucketed engine's k-means starts from
the JAX package's rows in every run (its own draw comes from a
``torch.Generator``, so its buckets would differ from JAX's).

Every rank reads, labels (fake labeler), decodes and embeds its row block
with the mean-colour tower (ten times the mean colour, as the JAX tests'
toy tower), the labels are gathered and fused, and the engine runs over
the ranks: the bucketed engine above ``exact_limit`` (float32 and int8
residency, and ``run_stream``), the chain engine, and the exact engine
below it. Rank 0 alone writes the report; every rank returns the same
result.
"""

import numpy as np
import pytest
import torch

from imageclust_tpu.config import AppConfig as JaxAppConfig
from imageclust_tpu.config import ClusterConfig as JaxClusterConfig
from imageclust_tpu.config import LabelConfig as JaxLabelConfig
from imageclust_tpu.config import NamingConfig as JaxNamingConfig
from imageclust_tpu.pipeline import Pipeline as JaxPipeline
from imageclust_tpu_torch.config import (
    AppConfig,
    ClusterConfig,
    LabelConfig,
    NamingConfig,
)
from imageclust_tpu_torch.parallel._worker import mean_color_embedder
from imageclust_tpu_torch.pipeline import Pipeline

from helpers import color_group_images
import test_torch_mesh_targets as targets

torch.set_num_threads(2)

CASES = {  # name: (cluster config, run)
    "bucketed": (dict(exact_limit=4, bucket_size=16), "paths"),
    "bucketed_int8": (dict(exact_limit=4, bucket_size=16,
                           feature_dtype="int8"), "paths"),
    "chain": (dict(exact_limit=4, scale_engine="chain"), "paths"),
    "exact": (dict(exact_limit=1000), "paths"),
    "stream": (dict(exact_limit=4, bucket_size=16), "stream"),
}


def _jax_embedder(mesh):
    import jax.numpy as jnp

    from imageclust_tpu.models.registry import Embedder, EmbedderSpec

    spec = EmbedderSpec(name="toy", input_size=16, dim=3, scale=1 / 255.0,
                        mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0),
                        bgr_input=True)
    return Embedder(spec, lambda v, x: jnp.mean(x, axis=(1, 2)) * 10.0
                    + v["b"], {"b": jnp.zeros((3,))}, batch_size=8,
                    mesh=mesh, tag="toy:mesh-test")


def _partition(res):
    return sorted(sorted(d.images) for d in res.clusters.values())


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The image directory and every case's result on each of 4 ranks."""
    root = tmp_path_factory.mktemp("mp")
    names, blobs = color_group_images(np.random.default_rng(1234),
                                      n_groups=3, per_group=8, size=16)
    paths = _write(root / "imgs", names, blobs)
    idx = _jax_init(len(paths))
    cases = [(name, "case_pipeline", (4, 1), dict(
        paths=paths, work=str(root / f"w_{name}"), cluster=cl, run=run,
        labels="none" if run == "stream" else "fake", kmeans_idx=idx))
        for name, (cl, run) in CASES.items()]
    # tests/test_mesh_pipeline.py's recovery job: 3 groups of 4, max 6
    names, blobs = color_group_images(np.random.default_rng(99),
                                      n_groups=3, per_group=4, size=16)
    cases.append(("groups", "case_pipeline", (4, 1), dict(
        paths=_write(root / "groups", names, blobs), work=str(root / "g"),
        cluster=dict(exact_limit=4, bucket_size=16), max_size=6)))
    outs = targets.run(cases, 4, root)
    return paths, root, outs


def _write(d, names, blobs):
    d.mkdir()
    for n, b in zip(names, blobs):
        (d / n).write_bytes(b)
    return [str(d / n) for n in names]


def _jax_init(n):
    import jax

    return np.asarray(jax.random.permutation(jax.random.PRNGKey(0), n))


@pytest.fixture()
def jax_init(monkeypatch):
    """The single-process port's k-means from the JAX package's rows."""
    from imageclust_tpu_torch.cluster import sharded as tsh

    monkeypatch.setattr(tsh, "_kmeans_init_idx", lambda n, k, seed: (
        torch.from_numpy(_jax_init(n)[:k].copy())))


def _cfg(jax, cluster, labels="fake"):
    if jax:
        return JaxAppConfig(
            labels=JaxLabelConfig(backend=labels),
            naming=JaxNamingConfig(services=("fake",), retries=1),
            cluster=JaxClusterConfig(**cluster))
    return AppConfig(labels=LabelConfig(backend=labels),
                     naming=NamingConfig(services=("fake",), retries=1),
                     cluster=ClusterConfig(**cluster))


@pytest.mark.parametrize("name", list(CASES))
def test_run_paths_over_four_ranks(job, mesh8, tmp_path, name, jax_init):
    paths, root, outs = job
    cluster, run = CASES[name]
    per_rank = [o[name]["out"] for o in outs]
    for o in per_rank:
        assert o["partition"] == per_rank[0]["partition"]
        assert o["dropped"] == per_rank[0]["dropped"] == []
        assert o["titles"] and (run == "stream" or o["labels"])
        assert o["counters"]["images"] == len(paths)
    assert per_rank[0]["report"]  # rank 0 wrote the report
    if run == "stream":  # against the single-process port's run_stream
        from imageclust_tpu_torch.data.loader import decode_images

        imgs = decode_images([open(p, "rb").read() for p in paths],
                             size=16)
        one = Pipeline(_cfg(False, cluster, "none"), device="cpu",
                       embedder=mean_color_embedder()).run_stream(
            (imgs[s:s + 8] for s in range(0, len(imgs), 8)), len(imgs),
            str(tmp_path / "one"), min_size=3, max_size=8)
        assert per_rank[0]["partition"] == _partition(one)
        return
    one = Pipeline(_cfg(False, cluster), device="cpu",
                   embedder=mean_color_embedder()).run_paths(
        paths, str(tmp_path / "one"), min_size=3, max_size=8)
    want = JaxPipeline(_cfg(True, cluster), mesh=mesh8,
                       embedder=_jax_embedder(mesh8)).run_paths(
        paths, str(tmp_path / "jax"), min_size=3, max_size=8)
    assert per_rank[0]["partition"] == _partition(one) == _partition(want)
    assert one.dropped == want.dropped == []


def test_recovers_the_colour_groups(job):
    """Well-separated groups (3 of 4 images, max 6): the mesh job recovers
    them on every rank (tests/test_mesh_pipeline.py's contract)."""
    _, _, outs = job
    want = sorted(sorted(f"g{g}_img{i}.png" for i in range(4))
                  for g in range(3))
    for o in outs:
        assert o["groups"]["out"]["partition"] == want


def test_naming_failure_on_rank0_fails_every_rank(tmp_path):
    """Rank 0 names the clusters alone; when its namer raises, every rank
    fails at once with rank 0's error (none waits in the broadcast for
    the process group's timeout)."""
    names, blobs = color_group_images(np.random.default_rng(5), n_groups=2,
                                      per_group=4, size=16)
    paths = _write(tmp_path / "imgs", names, blobs)
    with pytest.raises(RuntimeError) as err:
        targets.run([("fail", "case_pipeline", (2, 1), dict(
            paths=paths, work=str(tmp_path / "w"),
            cluster=dict(exact_limit=1000), max_size=6,
            fail_naming=True))], 2, tmp_path, timeout=90.0)
    msg = str(err.value)
    assert "TIMEOUT" not in msg
    assert "worker 0: rc=1" in msg and "worker 1: rc=1" in msg
    assert "RuntimeError: namer down on rank 0" in msg  # rank 0's own
    assert "rank 0 failed: RuntimeError: namer down on rank 0" in msg


def test_mesh_pipeline_needs_a_mesh_embedder():
    from imageclust_tpu_torch.core.mesh import create_mesh

    with pytest.raises(ValueError, match="same mesh"):
        Pipeline(_cfg(False, {}), mesh=create_mesh(device="cpu"),
                 embedder=mean_color_embedder())
    with pytest.raises(TypeError, match="Mesh"):
        Pipeline(_cfg(False, {}), mesh=object(),
                 embedder=mean_color_embedder())
