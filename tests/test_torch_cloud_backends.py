"""The port's cloud backends against the JAX package's: Rekognition labels,
Bedrock (Claude, Nova) and OpenAI naming, the payload shrink, and one
``Pipeline.run`` through both packages on stubbed answers.

The port's one transport function (``utils.aws.http_request``) and the JAX
package's ``requests.post`` are each replaced by a recorder that answers
from the same canned function. With the clock fixed in both packages, the
URLs, signed headers and body bytes must be equal.
"""

import base64
import hashlib
import json
import os
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import requests
import torch

import imageclust_tpu.utils.aws as jaws
import imageclust_tpu_torch.utils.aws as paws
from imageclust_tpu.config import AppConfig as JaxAppConfig
from imageclust_tpu.config import LabelConfig as JaxLabelConfig
from imageclust_tpu.config import NamingConfig as JaxNamingConfig
from imageclust_tpu.labels import rekognition as jrek
from imageclust_tpu.labels.base import create_labeler as jax_create_labeler
from imageclust_tpu.models.registry import Embedder as JaxEmbedder
from imageclust_tpu.models.registry import EmbedderSpec as JaxSpec
from imageclust_tpu.models.resnet50 import ResNet50V1 as FlaxResNet
from imageclust_tpu.naming import bedrock as jbed
from imageclust_tpu.naming import openai_backend as joai
from imageclust_tpu.naming.registry import build_namer as jax_build_namer
from imageclust_tpu.pipeline import Pipeline as JaxPipeline
from imageclust_tpu.types import UploadedImage as JaxUpload
from imageclust_tpu_torch.config import AppConfig, LabelConfig, NamingConfig
from imageclust_tpu_torch.labels import rekognition as prek
from imageclust_tpu_torch.labels.base import CachedLabeler, create_labeler
from imageclust_tpu_torch.models.registry import Embedder, EmbedderSpec
from imageclust_tpu_torch.models.resnet50 import ResNet50V1
from imageclust_tpu_torch.naming import bedrock as pbed
from imageclust_tpu_torch.naming import openai_backend as poai
from imageclust_tpu_torch.naming.base import FALLBACK_PHRASE, FALLBACK_TITLE
from imageclust_tpu_torch.naming.registry import build_namer
from imageclust_tpu_torch.pipeline import Pipeline
from imageclust_tpu_torch.types import UploadedImage

from helpers import color_group_images, encode_png

torch.set_num_threads(1)

_FIXED = __import__("datetime").datetime(
    2026, 3, 4, 5, 6, 7, tzinfo=__import__("datetime").timezone.utc)
_NAMERS = ("claude_haiku", "claude_sonnet", "nova_micro", "gpt-3.5-turbo",
           "gpt-4", "gpt35", "gpt4")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch, tmp_path):
    """Static test credentials, no other credential source, a fixed clock
    and empty credential caches in both packages."""
    for var in ("AWS_SESSION_TOKEN", "AWS_WEB_IDENTITY_TOKEN_FILE",
                "AWS_PROFILE", "AWS_CONTAINER_CREDENTIALS_RELATIVE_URI",
                "AWS_CONTAINER_CREDENTIALS_FULL_URI", "OPENAI_API_KEY"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "AKTEST")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "SKTEST")
    monkeypatch.setenv("AWS_SHARED_CREDENTIALS_FILE", str(tmp_path / "none"))
    monkeypatch.setenv("AWS_CONFIG_FILE", str(tmp_path / "none"))
    monkeypatch.setenv("AWS_EC2_METADATA_DISABLED", "true")
    for mod in (jaws, paws):
        monkeypatch.setattr(mod, "_CACHE", None)
        sign = mod.sign_request
        monkeypatch.setattr(
            mod, "sign_request",
            lambda *a, _sign=sign, **k: _sign(*a, **{"now": _FIXED, **k}))


class _Seams:
    """Recorders at both packages' transport seams. ``respond(url, body)``
    gives ``(status, body bytes)`` or raises ``OSError``; each side keeps
    its own list of requests as (url, body bytes, lower-cased headers,
    timeout)."""

    def __init__(self, monkeypatch, respond, per_side=False):
        # per_side: ``respond`` is a factory of responders, one a side
        port_respond, jax_respond = ((respond(), respond()) if per_side
                                     else (respond, respond))
        self.port, self.jax = [], []

        def port_http(method, url, body, headers, timeout):
            assert method == "POST"
            self.port.append((url, body, _lower(headers), timeout))
            return port_respond(url, body)

        def jax_post(url, data=None, json=None, headers=None, timeout=None):
            prep = requests.Request("POST", url, data=data, json=json,
                                    headers=headers).prepare()
            body = prep.body.encode() if isinstance(prep.body, str) \
                else prep.body
            sent = _lower(prep.headers)
            sent.pop("content-length", None)
            self.jax.append((url, body, sent, timeout))
            status, raw = jax_respond(url, body)
            resp = requests.Response()
            resp.status_code, resp._content, resp.encoding = status, raw, \
                "utf-8"
            return resp

        monkeypatch.setattr(paws, "http_request", port_http)
        monkeypatch.setattr(requests, "post", jax_post)


def _lower(headers) -> dict:
    return {k.lower(): v for k, v in dict(headers).items()}


def _prompt_of(url: str, body: bytes) -> str:
    req = json.loads(body)
    if "openai" in url:
        return req["messages"][1]["content"]
    if "messages" in req:
        return req["messages"][0]["content"]
    return req["inputText"]


def _answer(url: str, body: bytes, title_prefix: str = "") -> bytes:
    """A service's success answer to a naming request: a title and phrase
    derived from the prompt, in that service's response shape."""
    sha = hashlib.sha256(_prompt_of(url, body).encode()).hexdigest()
    service = ("openai" if "openai" in url else "nova" if "nova" in url
               else "claude")
    text = json.dumps({"title": f"{title_prefix}{service}-{sha[:8]}",
                       "catchy_phrase": f"phrase {sha[8:20]}"})
    if service == "openai":
        return json.dumps({"choices": [{"message": {"content": text}}]}
                          ).encode()
    if service == "nova":
        return json.dumps({"Results": [{"outputText": text}]}).encode()
    return json.dumps({"content": [{"type": "text", "text": text}]}).encode()


def _both(port_fn, jax_fn):
    """Run the port's call, then the JAX package's; each returns what it
    returned or the exception's type name and message."""
    out = []
    for fn in (port_fn, jax_fn):
        try:
            out.append(("ok", fn()))
        except Exception as exc:  # compared below, type by type
            out.append((type(exc).__name__, str(exc)))
    return out


# -- the registries -----------------------------------------------------------

class TestRegistry:
    @pytest.mark.parametrize("name", _NAMERS)
    def test_namer_matches_jax(self, name):
        got = build_namer(name, NamingConfig(bedrock_region="eu-west-1",
                                             retry_delay_s=0.5))
        want = jax_build_namer(name, JaxNamingConfig(
            bedrock_region="eu-west-1", retry_delay_s=0.5))
        assert type(got).__name__ == type(want).__name__
        assert type(got).__module__.startswith("imageclust_tpu_torch.")
        for attr in ("name", "order", "model_id", "region", "retry_delay_s",
                     "model", "timeout_s"):
            assert getattr(got, attr, None) == getattr(want, attr, None)

    @pytest.mark.parametrize("cache", [True, False])
    def test_rekognition_labeler_matches_jax(self, cache, tmp_path):
        kw = dict(backend="rekognition", region="eu-west-1",
                  max_payload_bytes=1234)
        got = create_labeler(LabelConfig(**kw), str(tmp_path / "p")
                             if cache else None)
        want = jax_create_labeler(JaxLabelConfig(**kw), str(tmp_path / "j")
                                  if cache else None)
        assert type(got).__name__ == type(want).__name__
        inner = got.inner if cache else got
        assert isinstance(inner, prek.RekognitionLabeler)
        assert (inner.region, inner.max_payload_bytes, inner.creds) == (
            "eu-west-1", 1234, None)
        if cache:
            assert isinstance(got, CachedLabeler)
            assert got.namespace == want.namespace == "RekognitionLabeler"


# -- Rekognition --------------------------------------------------------------

def _labels_answer(url, body):
    img = base64.b64decode(json.loads(body)["Image"]["Bytes"])
    sha = hashlib.sha256(img).hexdigest()
    return 200, json.dumps({"Labels": [
        {"Name": f"Thing{sha[:4]}", "Confidence": 99.5},
        {"Name": "Photo", "Confidence": 80.25},
        {"Name": "NoConfidence"}]}).encode()


class TestRekognition:
    @pytest.mark.parametrize("region", ["us-east-1", "ap-south-1"])
    @pytest.mark.parametrize("token", ["", "session-token"])
    def test_same_request_and_labels(self, monkeypatch, rng, region, token):
        if token:
            monkeypatch.setenv("AWS_SESSION_TOKEN", token)
        seams = _Seams(monkeypatch, _labels_answer)
        blob = encode_png(rng.integers(0, 256, (32, 48, 3), np.uint8))
        got, want = _both(
            lambda: prek.RekognitionLabeler(region).detect_labels(blob, 7,
                                                                   60.0),
            lambda: jrek.RekognitionLabeler(region).detect_labels(blob, 7,
                                                                   60.0))
        assert got[0] == "ok"
        assert [(l.name, l.confidence) for l in got[1]] == [
            (l.name, l.confidence) for l in want[1]]
        assert got[1][2].confidence == 0.0
        assert seams.port == seams.jax
        url, body, headers, timeout = seams.port[0]
        assert url == f"https://rekognition.{region}.amazonaws.com/"
        assert headers["x-amz-target"] == "RekognitionService.DetectLabels"
        assert json.loads(body)["MaxLabels"] == 7

    def test_explicit_credentials(self, monkeypatch, rng):
        seams = _Seams(monkeypatch, _labels_answer)
        blob = encode_png(rng.integers(0, 256, (8, 8, 3), np.uint8))
        prek.RekognitionLabeler(creds=paws.AwsCredentials(
            "AKX", "SKX", "T")).detect_labels(blob, 3, 50.0)
        jrek.RekognitionLabeler(creds=jaws.AwsCredentials(
            "AKX", "SKX", "T")).detect_labels(blob, 3, 50.0)
        assert seams.port == seams.jax
        assert "Credential=AKX/" in seams.port[0][2]["authorization"]

    @pytest.mark.parametrize("status", [400, 403, 429, 500])
    def test_error_status_raises(self, monkeypatch, status):
        _Seams(monkeypatch, lambda u, b: (status, b'{"message": "denied"}'))
        got, want = _both(
            lambda: prek.RekognitionLabeler().detect_labels(b"x", 5, 1.0),
            lambda: jrek.RekognitionLabeler().detect_labels(b"x", 5, 1.0))
        assert got == want
        assert got[0] == "AwsError" and f"HTTP {status}" in got[1]

    def test_no_credentials_raises(self, monkeypatch):
        monkeypatch.delenv("AWS_ACCESS_KEY_ID")
        seams = _Seams(monkeypatch, _labels_answer)
        got, want = _both(
            lambda: prek.RekognitionLabeler().detect_labels(b"x", 5, 1.0),
            lambda: jrek.RekognitionLabeler().detect_labels(b"x", 5, 1.0))
        assert got == want and "no AWS credentials" in got[1]
        assert seams.port == seams.jax == []

    def test_labeling_service_retries_then_succeeds(self, monkeypatch, rng,
                                                    tmp_path):
        """A 429 costs one attempt of the labeling service; the labels are
        cached, so a second call sends nothing."""
        from imageclust_tpu_torch.labels.service import LabelingService

        calls = []

        def flaky(url, body):
            calls.append(url)
            return (429, b"slow down") if len(calls) == 1 else \
                _labels_answer(url, body)

        _Seams(monkeypatch, flaky)
        labeler = create_labeler(LabelConfig(backend="rekognition"),
                                 str(tmp_path))
        svc = LabelingService(labeler, 10, 75.0, retry_delay_s=0.0,
                              concurrency=1)
        blob = encode_png(rng.integers(0, 256, (8, 8, 3), np.uint8))
        (labels,) = svc.detect_all([blob])
        assert len(calls) == 2 and labels[1].name == "Photo"
        assert svc.detect_all([blob]) == [labels] and len(calls) == 2


class TestShrink:
    @pytest.mark.parametrize("shape,limit", [((900, 1300), 60_000),
                                             ((1500, 700), 30_000),
                                             ((3000, 2200), 200_000)])
    def test_same_bytes_as_jax_with_cv2(self, rng, shape, limit):
        img = rng.integers(0, 256, (*shape, 3), np.uint8)
        blob = encode_png(img)
        assert len(blob) > limit
        got = prek.shrink_to_payload_limit(blob, limit)
        assert got == jrek.shrink_to_payload_limit(blob, limit)
        out = cv2.imdecode(np.frombuffer(got, np.uint8), cv2.IMREAD_COLOR)
        assert got[:2] == b"\xff\xd8" and max(out.shape[:2]) <= 2048

    def test_under_limit_passes_through_without_cv2(self, monkeypatch):
        monkeypatch.setitem(sys.modules, "cv2", None)
        assert prek.shrink_to_payload_limit(b"abc", 3) == b"abc"

    def test_over_limit_without_cv2_names_cv2(self, monkeypatch, rng):
        """The JAX package fails there too (ImportError); the port raises
        a ValueError that says why."""
        blob = encode_png(rng.integers(0, 256, (64, 64, 3), np.uint8))
        monkeypatch.setitem(sys.modules, "cv2", None)
        with pytest.raises(ValueError, match="cv2"):
            prek.shrink_to_payload_limit(blob, 100)
        with pytest.raises(ImportError):
            jrek.shrink_to_payload_limit(blob, 100)

    def test_detect_labels_sends_the_shrunk_image(self, monkeypatch, rng):
        seams = _Seams(monkeypatch, _labels_answer)
        blob = encode_png(rng.integers(0, 256, (400, 500, 3), np.uint8))
        prek.RekognitionLabeler(max_payload_bytes=50_000).detect_labels(
            blob, 5, 1.0)
        jrek.RekognitionLabeler(max_payload_bytes=50_000).detect_labels(
            blob, 5, 1.0)
        assert seams.port == seams.jax
        sent = base64.b64decode(json.loads(seams.port[0][1])["Image"]["Bytes"])
        assert sent == prek.shrink_to_payload_limit(blob, 50_000) != blob


# -- Bedrock and OpenAI -------------------------------------------------------

_PAIRS = {
    "claude_haiku": (lambda **k: pbed.ClaudeBedrockNamer("haiku", **k),
                     lambda **k: jbed.ClaudeBedrockNamer("haiku", **k)),
    "claude_sonnet": (lambda **k: pbed.ClaudeBedrockNamer("sonnet", **k),
                      lambda **k: jbed.ClaudeBedrockNamer("sonnet", **k)),
    "nova_micro": (lambda **k: pbed.NovaBedrockNamer(**k),
                   lambda **k: jbed.NovaBedrockNamer(**k)),
    "gpt-3.5-turbo": (lambda **k: poai.OpenAINamer("gpt-3.5-turbo", **k),
                      lambda **k: joai.OpenAINamer("gpt-3.5-turbo", **k)),
    "gpt-4": (lambda **k: poai.OpenAINamer("gpt-4", **k),
              lambda **k: joai.OpenAINamer("gpt-4", **k)),
}
_TEXT = 'Dog "Beach" & Sand\\\n#Sunset\t' + "x" * 1200


def _namers(name):
    port_cls, jax_cls = _PAIRS[name]
    return port_cls(retry_delay_s=0.0), jax_cls(retry_delay_s=0.0)


def _scripted(statuses):
    """A responder that answers each request in turn with the next status
    (200: a success, "junk": a 200 whose body is not JSON, "nokey": a 200
    JSON body without the expected fields, "oserror": a connection
    failure); the last one repeats."""
    sent = []

    def respond(url, body):
        sent.append(url)
        status = statuses[min(len(sent) - 1, len(statuses) - 1)]
        if status == 200:
            return 200, _answer(url, body)
        if status == "junk":
            return 200, b"<html>oops</html>"
        if status == "nokey":
            return 200, b'{"unexpected": []}'
        if status == "oserror":
            raise ConnectionRefusedError("refused")
        return status, b'{"message": "error"}'
    return respond


class TestNamers:
    @pytest.mark.parametrize("name", sorted(_PAIRS))
    def test_same_request_and_title(self, monkeypatch, name):
        monkeypatch.setenv("OPENAI_API_KEY", "sk-test")
        seams = _Seams(monkeypatch, lambda u, b: (200, _answer(u, b)))
        port, jax_namer = _namers(name)
        got = port.generate(_TEXT, 3)
        assert got == jax_namer.generate(_TEXT, 3)
        assert got[0] != FALLBACK_TITLE
        assert seams.port == seams.jax and len(seams.port) == 1
        url, body, headers, timeout = seams.port[0]
        if name.startswith("gpt"):
            assert url == "https://api.openai.com/v1/chat/completions"
            assert headers["authorization"] == "Bearer sk-test"
            assert headers["content-type"] == "application/json"
            assert timeout == 60.0
            assert json.loads(body)["model"] == name
        else:
            assert url.startswith(
                "https://bedrock-runtime.us-west-2.amazonaws.com/model/")
            assert url.endswith("/invoke") and "%3A0" in url
            assert headers["authorization"].startswith(
                "AWS4-HMAC-SHA256 Credential=AKTEST/20260304/us-west-2/"
                "bedrock/aws4_request")
            assert timeout == 30.0

    @pytest.mark.parametrize("name", sorted(_PAIRS))
    @pytest.mark.parametrize("script,expect_calls,falls_back", [
        ((429, 200), 2, False),
        ((403,), 3, True),
        ((500, 500, 200), 3, False),
        (("junk", 200), 2, False),
        (("nokey",), 3, True),
        (("oserror", 200), 2, False),
    ], ids=["429-then-200", "403", "500-500-200", "junk-then-200", "nokey",
            "oserror-then-200"])
    def test_retries_match_jax(self, monkeypatch, name, script, expect_calls,
                               falls_back):
        monkeypatch.setenv("OPENAI_API_KEY", "sk-test")
        seams = _Seams(monkeypatch, lambda: _scripted(script), per_side=True)
        port, jax_namer = _namers(name)
        got = port.generate("cat, dog", 3)
        want = jax_namer.generate("cat, dog", 3)
        assert got == want
        assert (got == (FALLBACK_TITLE, FALLBACK_PHRASE)) == falls_back
        assert len(seams.port) == len(seams.jax) == expect_calls
        assert seams.port == seams.jax

    @pytest.mark.parametrize("name", sorted(_PAIRS))
    def test_fallback_without_credentials_or_key(self, monkeypatch, name):
        monkeypatch.delenv("AWS_ACCESS_KEY_ID")
        seams = _Seams(monkeypatch, lambda u, b: (200, _answer(u, b)))
        port, jax_namer = _namers(name)
        got = port.generate("cat", 2)
        assert got == jax_namer.generate("cat", 2) == (FALLBACK_TITLE,
                                                       FALLBACK_PHRASE)
        assert seams.port == seams.jax == []

    def test_retry_sleeps(self, monkeypatch):
        """``retry_delay_s`` between attempts, none after the last."""
        monkeypatch.setenv("OPENAI_API_KEY", "sk-test")
        _Seams(monkeypatch, lambda u, b: (500, b"{}"))
        slept = []
        monkeypatch.setattr(pbed.time, "sleep", slept.append)
        pbed.NovaBedrockNamer(retry_delay_s=0.25).generate("x", 3)
        poai.OpenAINamer(retry_delay_s=0.5).generate("x", 2)
        assert slept == [0.25, 0.25, 0.5]

    def test_naming_service_orders_outputs(self, monkeypatch):
        from imageclust_tpu_torch.naming import create_naming_service

        monkeypatch.setenv("OPENAI_API_KEY", "sk-test")
        _Seams(monkeypatch, lambda u, b: (200, _answer(u, b)))
        svc = create_naming_service(NamingConfig(
            services=("claude_haiku", "gpt-4", "nova_micro",
                      "gpt-3.5-turbo"), retry_delay_s=0.0))
        outs = svc.generate_multi("cat, dog")
        assert [o.order for o in outs] == [1, 2, 3, 4]
        assert [o.service_name for o in outs] == [
            "Amazon Nova Micro", "OpenAI GPT-3.5 Turbo", "Open AI GPT-4",
            "Claude Haiku v3.5"]


# -- one job through both packages --------------------------------------------

_LAYERS = (1, 1, 1, 1)
_DIM = 64


@pytest.fixture(scope="module")
def towers():
    """(JAX embedder, port embedder) on the same float32 weights (the small
    ResNet of tests/test_torch_pipeline.py)."""
    flax_model = FlaxResNet(dtype=jnp.float32, norm_dtype=jnp.float32,
                            stage_layers=_LAYERS, num_classes=_DIM)
    raw_model = FlaxResNet(dtype=jnp.float32, norm_dtype=jnp.float32,
                           stage_layers=_LAYERS, num_classes=_DIM,
                           stem_mode="s2d_raw")
    variables = flax_model.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 3, 224, 224)))
    spec = dict(name="resnet50", input_size=224, dim=_DIM, scale=1 / 255.0,
                mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0), bgr_input=True)
    jax_emb = JaxEmbedder(
        JaxSpec(**spec), lambda v, x: flax_model.apply(v, x), variables,
        batch_size=16, tag="jax-test",
        raw_apply_fn=lambda v, u8: raw_model.apply(v, u8))
    port_emb = Embedder(
        EmbedderSpec(**spec),
        ResNet50V1(num_classes=_DIM, dtype="float32", norm_dtype="float32",
                   stage_layers=_LAYERS, stem_mode="s2d_raw"),
        batch_size=16, device=torch.device("cpu"), tag="torch-test")
    port_emb.load_flax_variables(jax.tree.map(np.asarray, variables))
    return jax_emb, port_emb


class TestJobAgainstJax:
    def test_same_clusters_names_and_report(self, towers, rng, tmp_path,
                                            monkeypatch):
        jax_emb, port_emb = towers
        names, blobs = color_group_images(rng, n_groups=4, per_group=5)
        group_of = {hashlib.sha256(b).hexdigest(): n.split("_")[0]
                    for n, b in zip(names, blobs)}
        monkeypatch.setenv("OPENAI_API_KEY", "sk-test")

        def respond(url, body):
            if "rekognition" in url:
                img = base64.b64decode(json.loads(body)["Image"]["Bytes"])
                g = group_of[hashlib.sha256(img).hexdigest()]
                return 200, json.dumps({"Labels": [
                    {"Name": f"Colour {g}", "Confidence": 98.0},
                    {"Name": "Texture", "Confidence": 77.0}]}).encode()
            return 200, _answer(url, body)

        seams = _Seams(monkeypatch, respond)
        services = ("claude_haiku", "nova_micro", "gpt-3.5-turbo")
        jcfg = JaxAppConfig(
            labels=JaxLabelConfig(backend="rekognition", retry_delay_s=0.0),
            naming=JaxNamingConfig(services=services, retry_delay_s=0.0))
        pcfg = AppConfig(
            labels=LabelConfig(backend="rekognition", retry_delay_s=0.0),
            naming=NamingConfig(services=services, retry_delay_s=0.0))
        want = JaxPipeline(jcfg, embedder=jax_emb).run(
            [JaxUpload(n, b) for n, b in zip(names, blobs)],
            str(tmp_path / "job"), min_size=3, max_size=6)
        jax_report = open(want.html_path).read()
        got = Pipeline(pcfg, device="cpu", embedder=port_emb).run(
            [UploadedImage(n, b) for n, b in zip(names, blobs)],
            str(tmp_path / "job2"), min_size=3, max_size=6)
        port_report = open(got.html_path).read()
        assert got.to_dict()["clusters"] == want.to_dict()["clusters"]
        assert got.dropped == want.dropped
        assert port_report == jax_report
        assert sorted(seams.port, key=repr) == sorted(seams.jax, key=repr)
        # every image labelled once, every cluster named by each service
        n_rek = sum("rekognition" in s[0] for s in seams.port)
        assert n_rek == len(names)
        assert len(seams.port) == n_rek + 3 * len(got.clusters)
        for c in got.clusters.values():
            assert [o.service_name for o in c.service_outputs] == [
                "Amazon Nova Micro", "OpenAI GPT-3.5 Turbo",
                "Claude Haiku v3.5"]
            assert all(o.title != FALLBACK_TITLE for o in c.service_outputs)
            assert c.labels.startswith("Colour g")
        # a re-run on the same label cache sends no Rekognition request
        seams.port.clear()
        again = Pipeline(pcfg, device="cpu", embedder=port_emb).run(
            [UploadedImage(n, b) for n, b in zip(names, blobs)],
            str(tmp_path / "job2"), min_size=3, max_size=6)
        assert not any("rekognition" in s[0] for s in seams.port)
        assert again.metrics.counters["label_cache_hits"] == len(names)
        assert again.to_dict()["clusters"] == got.to_dict()["clusters"]
        assert os.path.exists(again.html_path)
