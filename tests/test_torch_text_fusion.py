"""The port's dense text-label fusion (``imageclust_tpu_torch/labels/
text_fusion.py``) against the JAX package's: the label-name bank through a
shared text tower (converted Flax weights), the confidence weights (bit
for bit) and the fused matrix (allclose at 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageclust_tpu.labels import text_fusion as jax_fusion
from imageclust_tpu.labels.base import Label as JaxLabel
from imageclust_tpu.models import text as jax_text
from imageclust_tpu_torch.labels import text_fusion
from imageclust_tpu_torch.labels.base import Label
from imageclust_tpu_torch.labels.onehot import build_label_set
from imageclust_tpu_torch.models import text
from imageclust_tpu_torch.models.convert import text_state_dict_from_flax

torch.set_num_threads(2)

_TOL = dict(rtol=1e-5, atol=1e-5)
_NAMES = ["Shoe", "Hat", "Bag", "Red", "Running shoe", "Person"]


@pytest.fixture(scope="module")
def encoders():
    """(JAX TextEncoder, port TextEncoder) on the same weights."""
    cfg = dict(vocab=400, width=48, depth=2, heads=2, proj_dim=24,
               context=16, eot_id=2)
    variables = jax_text.TextTransformer(jax_text.TextConfig(**cfg)).init(
        jax.random.PRNGKey(5), jnp.zeros((1, 16), jnp.int32))
    variables = jax.tree.map(np.asarray, variables)
    return (jax_text.TextEncoder(jax_text.TextConfig(**cfg),
                                 variables=variables),
            text.TextEncoder(text.TextConfig(**cfg),
                             state_dict=text_state_dict_from_flax(variables),
                             device="cpu"))


def _labels(seed, n=40):
    """Per-image (name, confidence) lists for both packages' Label types;
    some images unlabeled, some with an unknown label."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        k = int(rng.integers(0, 4))
        picks = rng.choice(len(_NAMES) + 1, k, replace=False)
        rows.append([((_NAMES + ["Unknown"])[i],
                      float(rng.uniform(40, 100))) for i in picks])
    return ([[Label(a, c) for a, c in r] for r in rows],
            [[JaxLabel(a, c) for a, c in r] for r in rows])


def _label_set(rows):
    known = [[l for l in r if l.name != "Unknown"] for r in rows]
    return build_label_set(known)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_confidence_weights_bit_equal(seed):
    port_rows, jax_rows = _labels(seed)
    label_set = _label_set(port_rows)
    got = text_fusion.confidence_weights(port_rows, label_set)
    want = jax_fusion.confidence_weights(jax_rows, label_set)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_label_text_bank_matches_jax(encoders):
    jenc, penc = encoders
    label_set = {n: i for i, n in enumerate(reversed(_NAMES))}
    got = text_fusion.label_text_bank(label_set, penc)
    want = jax_fusion.label_text_bank(label_set, jenc)
    assert got.shape == (len(_NAMES), 24)
    np.testing.assert_allclose(got, want, **_TOL)
    for template in ("{}", "an image of a {}, cropped"):
        np.testing.assert_allclose(
            text_fusion.label_text_bank(label_set, penc, template),
            jax_fusion.label_text_bank(label_set, jenc, template), **_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_text_label_matrix_matches_jax(encoders, seed):
    jenc, penc = encoders
    port_rows, jax_rows = _labels(seed)
    label_set = _label_set(port_rows)
    got = text_fusion.text_label_matrix(port_rows, label_set, penc)
    want = jax_fusion.text_label_matrix(jax_rows, label_set, jenc)
    assert got.shape == want.shape == (40, 24)
    np.testing.assert_allclose(got, want, **_TOL)
    labeled = np.array([any(l.name != "Unknown" for l in r)
                        for r in port_rows])
    np.testing.assert_allclose(np.linalg.norm(got[labeled], axis=1), 1.0,
                               rtol=1e-5)
    assert not got[~labeled].any()


def test_empty_label_set(encoders):
    _, penc = encoders
    rows = [[], [Label("Shoe", 90.0)]]
    assert text_fusion.text_label_matrix(rows, {}, penc).shape == (2, 0)
    assert text_fusion.label_text_bank({}, penc).shape == (0, 0)
    assert text_fusion._TEMPLATE == jax_fusion._TEMPLATE == "a photo of {}"
