"""The port's partition-agreement metrics and quality scoreboards
(``cluster/agreement.py``, ``cluster/quality.py``) against the JAX
package's.

``agreement`` is a copy and must return the JAX function's dict exactly
(``ami`` None included). The scoreboards are held to
tests/test_agreement.py's floors at its sizes; the port's mixtures come
from a ``torch.Generator``, so they are not the JAX package's. With the JAX
mixture and the JAX package's k-means seed rows injected into the port's
``_kmeans_init`` (as tests/test_torch_sharded.py does), the residency rows
must be equal exactly.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import imageclust_tpu.cluster.agreement as jag
import imageclust_tpu.cluster.quality as jq
from imageclust_tpu_torch.cluster import agreement as tag
from imageclust_tpu_torch.cluster import quality as tq
from imageclust_tpu_torch.cluster import sharded as tsh

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture()
def jax_init(monkeypatch):
    """Make the port's k-means start from the JAX package's rows."""

    def init(x, k, seed):
        idx = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed),
                                                x.shape[0])[:k])
        return x[torch.from_numpy(idx.copy()).to(x.device)].float()

    monkeypatch.setattr(tsh, "_kmeans_init", init)


class TestAgreementEqualsJax:
    def test_module_is_a_copy(self):
        assert (ROOT / "imageclust_tpu_torch/cluster/agreement.py").read_text() \
            == (ROOT / "imageclust_tpu/cluster/agreement.py").read_text()

    @settings(max_examples=60, deadline=None)
    @given(seed=st.integers(0, 2**31 - 1), n=st.integers(2, 400),
           ka=st.integers(1, 40), kb=st.integers(1, 40),
           drop=st.floats(0.0, 0.3), copy=st.floats(0.0, 1.0))
    def test_random_partitions(self, seed, n, ka, kb, drop, copy):
        rng = np.random.default_rng(seed)
        a = rng.integers(0, ka, n)
        b = np.where(rng.random(n) < copy, a, rng.integers(0, kb, n))
        a[rng.random(n) < drop] = -1
        b[rng.random(n) < drop] = -1
        try:
            want = jag.agreement(a, b)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:12]):
                tag.agreement(a, b)
            return
        assert tag.agreement(a, b) == want

    def test_ami_none_above_budget(self):
        a = np.arange(1500)
        b = np.arange(1500) // 2  # 1500 x 750 cells: above _AMI_MAX_CELLS
        got, want = tag.agreement(a, b), jag.agreement(a, b)
        assert got == want and got["ami"] is None

    @settings(max_examples=30, deadline=None)
    @given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 60),
           k=st.integers(1, 12))
    def test_partition_vector(self, seed, n, k):
        rng = np.random.default_rng(seed)
        ids = [f"i{j}" for j in range(n)]
        labels = rng.integers(-1, k, n)
        cmap = {}
        for iid, c in zip(ids, labels):
            if c >= 0:
                cmap.setdefault(int(rng.integers(0, 1000)) * 100 + int(c),
                                []).append(iid)
        np.testing.assert_array_equal(tag.partition_vector(cmap, ids),
                                      jag.partition_vector(cmap, ids))


class TestQualityFloors:
    """tests/test_agreement.py's floors (TestQualityFloors), on the port's
    scoreboards at the same sizes on the CPU."""

    @pytest.fixture(scope="class")
    def residency(self):
        return tq.residency_scoreboard(2000, 64, sep=1.0, device="cpu")

    def test_modes_beat_seed_yardstick(self, residency):
        yard = residency["f32_seed_yardstick"]["ari"]
        for mode in ("bfloat16", "int8"):
            assert residency[mode]["ari"] > yard

    def test_residency_agreement_floors(self, residency):
        for mode in ("bfloat16", "int8"):
            assert residency[mode]["ari"] >= 0.30
            assert residency[mode]["same_pair_f1"] >= 0.30
            assert residency[mode]["nmi"] >= 0.80

    def test_residency_truth_quality_preserved(self, residency):
        f32 = residency["f32"]["ari_vs_truth"]
        for mode in ("bfloat16", "int8"):
            assert residency[mode]["ari_vs_truth"] >= f32 - 0.05

    def test_fusion_text_floor(self):
        row = tq.fusion_scoreboard(1500, 64, sep=1.0, device="cpu")
        assert row["ari"] >= 0.30
        assert abs(row["ari_vs_truth_text"]
                   - row["ari_vs_truth_onehot"]) <= 0.10

    def test_separated_blobs_agree_exactly(self):
        sb = tq.residency_scoreboard(600, 32, sep=50.0, k=120, balanced=True,
                                     device="cpu")
        for mode in ("bfloat16", "int8"):
            assert sb[mode]["ari"] >= 0.99, sb[mode]


class TestResidencyRowsEqualJax:
    @pytest.mark.parametrize("n,d,sep", [(600, 16, 1.0), (1000, 32, 3.0)])
    def test_same_mixture_same_rows(self, monkeypatch, jax_init, n, d, sep):
        feats, truth = jq.synth_mixture(n, d, sep=sep)
        x = np.asarray(feats)
        monkeypatch.setattr(tq, "synth_mixture", lambda *a, **k: (
            torch.from_numpy(x.copy()), truth))
        assert tq.residency_scoreboard(n, d, sep=sep, device="cpu") \
            == jq.residency_scoreboard(n, d, sep=sep)


class TestMixtureGenerators:
    def test_synth_mixture_shapes_and_overlap(self):
        feats, truth = tq.synth_mixture(500, 16, sep=1.0, seed=3,
                                        device="cpu")
        assert feats.shape == (500, 16) and feats.dtype == torch.float32
        assert truth.shape == (500,) and truth.dtype == np.int64
        assert truth.max() >= 50  # k defaults to n//5 = 100 components
        again, t2 = tq.synth_mixture(500, 16, sep=1.0, seed=3, device="cpu")
        assert torch.equal(feats, again) and np.array_equal(truth, t2)

    def test_balanced_components(self):
        _, truth = tq.synth_mixture(600, 4, k=120, balanced=True,
                                    device="cpu")
        assert np.bincount(truth).tolist() == [5] * 120

    def test_synth_mixture_labels_equal_jax(self):
        _, truth = tq.synth_mixture(300, 8, sep=1.0, device="cpu")
        got, got_set = tq.synth_mixture_labels(truth, seed=1)
        want, want_set = jq.synth_mixture_labels(truth, seed=1)
        assert got_set == want_set
        assert [[(lb.name, lb.confidence) for lb in labs] for labs in got] \
            == [[(lb.name, lb.confidence) for lb in labs] for labs in want]
        by_comp = {}
        for z, labs in zip(truth, got):
            by_comp.setdefault(int(z), set()).add(labs[0].name)
        assert all(len(v) == 1 for v in by_comp.values())
        assert len(got_set) < truth.max() + 1

    def test_needs_cuda_by_default(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            tq.synth_mixture(10, 2)


class _MeanTower:
    """A stand-in for ``create_embedder``'s towers: channel means of 4x4
    cells; the int8 variant rounds them to a coarse grid."""

    batch_size = 16

    class spec:
        input_size = 16

    def __init__(self, quantize):
        self.quantize = quantize

    def embed_stream(self, chunks, total=None):
        out = []
        for c in chunks:
            x = c.to(torch.float32).reshape(c.shape[0], 4, 4, 4, 4, 3)
            e = x.mean(dim=(2, 4)).reshape(c.shape[0], -1) / 255.0
            out.append(torch.round(e * 8) / 8 if self.quantize else e)
        emb = torch.cat(out)
        assert emb.shape[0] == total
        return emb


def test_ptq_scoreboard_plumbing(monkeypatch):
    """The PTQ scenario with stand-in towers: both towers see the same
    images, the truth row replays the base-pattern ids (a mean-colour tower
    recovers them), and the rows carry the JAX function's keys."""
    from imageclust_tpu_torch.models import registry

    seen = []

    def fake(cfg, device=None):
        seen.append((cfg.model, cfg.quantize, str(device)))
        return _MeanTower(cfg.quantize)

    monkeypatch.setattr(registry, "create_embedder", fake)
    row = tq.ptq_scoreboard("resnet50", 150, n_base=12, device="cpu")
    assert seen == [("resnet50", "", "cpu"), ("resnet50", "int8", "cpu")]
    assert {"ari", "nmi", "seed_yardstick", "ari_vs_truth_f32",
            "ari_vs_truth_int8"} <= set(row)
    assert row["n"] + row["excluded"] == 150
    assert row["ari_vs_truth_f32"] > 0.3
