"""The port's stdlib HTTP server against the JAX package's aiohttp app.

Both serve a pipeline with the fast MeanColorEmbedder from tests/helpers.py
(the port's Pipeline on device="cpu"). Each scenario drives the same raw
requests through both servers and compares status codes, content types and
JSON key sets (full bodies where the reference fixes them).
"""

import asyncio
import io
import json
import threading
import time
import urllib.error
import urllib.request
import uuid

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from imageclust_tpu.config import AppConfig as JaxAppConfig
from imageclust_tpu.config import LabelConfig as JaxLabelConfig
from imageclust_tpu.config import NamingConfig as JaxNamingConfig
from imageclust_tpu.config import ServiceConfig as JaxServiceConfig
from imageclust_tpu.pipeline import Pipeline as JaxPipeline
from imageclust_tpu.service.app import create_app
from imageclust_tpu.service.jobs import JobStore as JaxJobStore
from imageclust_tpu_torch.config import (
    AppConfig,
    LabelConfig,
    NamingConfig,
    ServiceConfig,
)
from imageclust_tpu_torch.pipeline import Pipeline
from imageclust_tpu_torch.service.app import create_server
from imageclust_tpu_torch.service.jobs import JobStore

from helpers import MeanColorEmbedder, color_group_images, encode_png

torch.set_num_threads(1)


def _form(names=(), blobs=(), **fields):
    bnd = uuid.uuid4().hex
    out = io.BytesIO()
    for k, v in fields.items():
        out.write(f'--{bnd}\r\nContent-Disposition: form-data; name="{k}"'
                  f'\r\n\r\n{v}\r\n'.encode())
    for n, b in zip(names, blobs):
        out.write(f'--{bnd}\r\nContent-Disposition: form-data; '
                  f'name="images"; filename="{n}"\r\n'
                  f'Content-Type: image/png\r\n\r\n'.encode())
        out.write(b)
        out.write(b"\r\n")
    out.write(f"--{bnd}--\r\n".encode())
    return out.getvalue(), f"multipart/form-data; boundary={bnd}"


class _Reply:
    def __init__(self, status, headers, body):
        self.status = status
        self.headers = headers
        self.body = body

    @property
    def ctype(self):
        return self.headers.get("Content-Type", "").split(";")[0]

    def json(self):
        return json.loads(self.body)

    def sig(self):
        """What the two servers must agree on."""
        keys = None
        if self.ctype == "application/json":
            data = self.json()
            keys = sorted(data) if isinstance(data, dict) else None
        return self.status, self.ctype, keys


class PortClient:
    def __init__(self, server):
        self.server = server
        self.base = f"http://127.0.0.1:{server.server_address[1]}"

    def request(self, method, path, body=None, ctype=None, chunked=False):
        if chunked:  # an iterable body: urllib sends it chunked
            whole = body
            body = (whole[i:i + 4096] for i in range(0, len(whole), 4096))
        req = urllib.request.Request(self.base + path, data=body,
                                     method=method)
        if ctype:
            req.add_header("Content-Type", ctype)
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return _Reply(r.status, dict(r.headers), r.read())
        except urllib.error.HTTPError as e:
            return _Reply(e.code, dict(e.headers), e.read())

    def sleep(self, s):
        time.sleep(s)


class JaxClient:
    def __init__(self, app):
        self.loop = asyncio.new_event_loop()

        async def start():
            client = TestClient(TestServer(app))
            await client.start_server()
            return client

        self.client = self.loop.run_until_complete(start())

    def request(self, method, path, body=None, ctype=None, chunked=False):
        async def go():
            headers = {"Content-Type": ctype} if ctype else {}
            r = await self.client.request(method, path, data=body,
                                          headers=headers,
                                          chunked=chunked or None)
            return _Reply(r.status, dict(r.headers), await r.read())

        return self.loop.run_until_complete(go())

    def sleep(self, s):
        self.loop.run_until_complete(asyncio.sleep(s))

    def close(self):
        self.loop.run_until_complete(self.client.close())
        self.loop.close()


@pytest.fixture()
def both(tmp_path):
    """factory(**service_fields) -> (jax client, port client)."""
    made = []

    def factory(**service):
        jcfg = JaxAppConfig(
            labels=JaxLabelConfig(backend="fake"),
            naming=JaxNamingConfig(services=("fake",), retries=1),
            service=JaxServiceConfig(work_dir=str(tmp_path / "jax"),
                                     **service))
        pcfg = AppConfig(
            labels=LabelConfig(backend="fake"),
            naming=NamingConfig(services=("fake",), retries=1),
            service=ServiceConfig(work_dir=str(tmp_path / "port"), **service))
        jax_client = JaxClient(create_app(
            jcfg, JaxPipeline(jcfg, embedder=MeanColorEmbedder()),
            JaxJobStore(str(tmp_path / "jax"))))
        server = create_server(
            pcfg, Pipeline(pcfg, device="cpu", embedder=MeanColorEmbedder()),
            JobStore(str(tmp_path / "port")), host="127.0.0.1", port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        made.append((jax_client, server, thread))
        return jax_client, PortClient(server)

    yield factory
    for jax_client, server, thread in made:
        jax_client.close()
        server.shutdown()
        server.server_close()
        server.service.wait_background(30)
        thread.join(30)


def _both(both, scenario, **service):
    j, p = both(**service)
    return scenario(j), scenario(p)


class TestParity:
    def test_success_contract(self, both, rng):
        names, blobs = color_group_images(rng, n_groups=3, per_group=4)
        body, ctype = _form(names, blobs, minClusterSize=3, maxClusterSize=6)

        def scenario(c):
            out = []
            r = c.request("POST", "/api/cluster", body, ctype)
            data = r.json()
            out.append(r.sig())
            out.append(sorted(len(v["images"]) for v in
                              data["clusters"].values()))
            out.append(sorted(data["clusters"]["Cluster-0"]))
            out.append(data["clusters"]["Cluster-0"]["serviceOutputs"][0]
                       ["serviceName"])
            out.append(data["filePath"].endswith("clusters.html"))
            job = data["jobId"]
            for path in ("/api/view", f"/api/view?job={job}",
                         f"/api/image/{names[0]}",
                         f"/api/image/{names[0]}?job={job}",
                         f"/api/result?job={job}", "/api/jobs"):
                out.append(c.request("GET", path).sig())
            result = c.request("GET", f"/api/result?job={job}").json()
            out.append({k: v["images"] for k, v in result["clusters"].items()})
            return out

        a, b = _both(both, scenario)
        assert a == b
        assert a[0][0] == 200 and a[1] == [4, 4, 4]

    def test_error_shapes(self, both, rng):
        names, blobs = color_group_images(rng, n_groups=1, per_group=3)
        two_n, two_b = color_group_images(rng, n_groups=1, per_group=2)

        def scenario(c):
            out = []
            body, ctype = _form(minClusterSize=3)
            for req in ((body, ctype), (b"junk", "application/octet-stream"),
                        _form(names, blobs, minClusterSize=6,
                              maxClusterSize=2),
                        _form(names, blobs, minClusterSize="abc",
                              maxClusterSize=6),
                        _form(names, blobs, minClusterSize=3,
                              maxClusterSize="x")):
                r = c.request("POST", "/api/cluster", *req)
                out.append((r.status, r.json()))
            r = c.request("POST", "/api/cluster",
                          *_form(two_n, two_b, minClusterSize=3,
                                 maxClusterSize=6))
            out.append((r.status, sorted(r.json()), r.json()["success"]))
            out.append(c.request("GET", "/api/jobs").json()["jobs"][0]
                       ["status"])
            return out

        a, b = _both(both, scenario)
        assert a == b
        assert a[0] == (400, {"success": False,
                              "error": "No valid images uploaded"})
        assert a[1] == (400, {"success": False,
                              "error": "Failed to parse form data"})
        assert a[5][0] == 500 and a[6] == "failed"

    def test_not_found_routes(self, both, rng):
        names, blobs = color_group_images(rng, n_groups=1, per_group=3)

        def scenario(c):
            out = [c.request("GET", "/api/image/x.png").sig(),
                   c.request("GET", "/api/view").sig(),
                   c.request("GET", "/api/result?job=nope").sig()]
            c.request("POST", "/api/cluster",
                      *_form(names, blobs, minClusterSize=3,
                             maxClusterSize=6))
            for path in ("/api/image/nope.png",
                         "/api/image/..%2F..%2Fjob.json",
                         "/api/view?job=zzzz", "/api/view?page=abc",
                         "/api/view?page=99"):
                r = c.request("GET", path)
                out.append((r.status, r.json()))
            return out

        a, b = _both(both, scenario)
        assert a == b

    def test_cors_and_health(self, both):
        def scenario(c):
            r = c.request("OPTIONS", "/api/cluster")
            cors = {k: r.headers[k] for k in (
                "Access-Control-Allow-Origin",
                "Access-Control-Allow-Methods",
                "Access-Control-Allow-Headers")}
            h = c.request("GET", "/healthz")
            health = h.json()
            return r.status, cors, h.status, health["ok"], health["model"], \
                set(health)

        a, b = _both(both, scenario)
        assert a[:5] == b[:5]
        assert a[0] == 200 and a[1]["Access-Control-Allow-Origin"] == "*"
        assert a[5] <= b[5]  # the port adds the CUDA version
        assert "cuda" in b[5]

    def test_head_answers_as_get(self, both):
        """aiohttp's add_get answers HEAD on every GET route: GET's status,
        Content-Type and CORS headers, and no body."""
        def scenario(c):
            out = []
            for path in ("/api/jobs", "/healthz", "/",
                         "/api/image/nope.png"):
                r = c.request("HEAD", path)
                out.append((path, r.status, r.ctype, r.body,
                            c.request("GET", path).status,
                            {k: r.headers.get(k) for k in (
                                "Access-Control-Allow-Origin",
                                "Access-Control-Allow-Methods",
                                "Access-Control-Allow-Headers")}))
            return out

        a, b = _both(both, scenario)
        assert a == b
        assert [r[1] for r in a] == [200, 200, a[2][4], 404]
        assert all(r[1] == r[4] and r[3] == b"" for r in a)
        assert all(r[5]["Access-Control-Allow-Origin"] == "*" for r in a)

    def test_async_submit_and_poll(self, both, rng):
        names, blobs = color_group_images(rng, n_groups=1, per_group=3)

        def scenario(c):
            r = c.request("POST", "/api/cluster?async=1",
                          *_form(names, blobs, minClusterSize=3,
                                 maxClusterSize=6))
            d = r.json()
            out = [r.sig(), d["status"], d["resultUrl"].startswith(
                "/api/result?job=")]
            for _ in range(200):
                body = c.request("GET", d["resultUrl"]).json()
                if "clusters" in body:
                    out.append((sorted(body), len(body["clusters"])))
                    return out
                assert body["status"] in ("queued", "running", "done")
                c.sleep(0.05)
            raise AssertionError("async job never finished")

        a, b = _both(both, scenario)
        assert a == b
        assert a[0][0] == 202

    def test_metrics_counters(self, both, rng):
        names, blobs = color_group_images(rng, n_groups=1, per_group=3)
        two_n, two_b = color_group_images(rng, n_groups=1, per_group=2)

        def scenario(c):
            c.request("POST", "/api/cluster",
                      *_form(names, blobs, minClusterSize=3,
                             maxClusterSize=6))
            c.request("POST", "/api/cluster",
                      *_form(two_n, two_b, minClusterSize=3,
                             maxClusterSize=6))
            r = c.request("GET", "/metrics")
            text = r.body.decode()
            lines = {ln.split(" ")[0]: ln.split(" ")[1]
                     for ln in text.splitlines()
                     if ln and not ln.startswith("#") and "seconds" not in ln}
            # the port's own: its naming service's calls, fallbacks,
            # resumes and clusters named in the calling thread
            naming = {k: lines.pop(k) for k in list(lines)
                      if k.startswith("imageclust_naming_")}
            typed = {ln.split(" ")[2] for ln in text.splitlines()
                     if ln.startswith("# TYPE ")}
            return (r.status, r.ctype, lines,
                    'imageclust_stage_seconds_total{stage="embed"}' in text,
                    naming, typed)

        a, b = _both(both, scenario)
        assert a[:4] == b[:4]
        assert a[2]["imageclust_jobs_total"] == "2"
        assert a[2]["imageclust_jobs_failed_total"] == "1"
        assert a[4] == {}
        # one cluster named by the fake namer, inline; the failed job
        # counts none
        assert b[4] == {"imageclust_naming_calls_total": "1",
                        "imageclust_naming_fallbacks_total": "0",
                        "imageclust_naming_resumed_total": "0",
                        "imageclust_naming_inline_total": "1"}
        assert set(b[4]) <= b[5]

    def test_oversized_upload_rejected(self, both, rng):
        big = rng.integers(0, 256, (300, 300, 3), dtype=np.uint8)
        blob = encode_png(big)

        def scenario(c):
            r = c.request("POST", "/api/cluster",
                          *_form(["big.png"], [blob], minClusterSize=3,
                                 maxClusterSize=6))
            return r.status, r.json()["success"]

        a, b = _both(both, scenario, max_upload_bytes=64 * 1024)
        assert a == b == (413, False)

    @pytest.mark.parametrize("over", [False, True])
    def test_cap_counts_image_bytes(self, both, rng, over):
        """The cap counts image bytes only: many small parts whose images
        sum to just under it get 200 from both servers although the whole
        body (part headers, fields) is larger; one byte over gets 413."""
        names, blobs = color_group_images(rng, n_groups=3, per_group=5,
                                          size=16)
        body, ctype = _form(names, blobs, minClusterSize=3, maxClusterSize=6)
        images = sum(map(len, blobs))
        cap = images - 1 if over else images
        assert len(body) > cap + 1000  # the multipart overhead

        def scenario(c):
            r = c.request("POST", "/api/cluster", body, ctype)
            data = r.json()
            return r.status, data["success"] if over else sorted(
                len(v["images"]) for v in data["clusters"].values())

        a, b = _both(both, scenario, max_upload_bytes=cap)
        assert a == b
        assert a[0] == (413 if over else 200)
        assert a[1] is False if over else sum(a[1]) >= 12

    def test_chunked_body(self, both, rng):
        """A chunked request (no Content-Length) is decoded, not read as
        empty: the same clusters as the request sent whole."""
        names, blobs = color_group_images(rng, n_groups=3, per_group=4)
        body, ctype = _form(names, blobs, minClusterSize=3, maxClusterSize=6)

        def scenario(c):
            out = []
            for chunked in (True, False):
                r = c.request("POST", "/api/cluster", body, ctype,
                              chunked=chunked)
                out.append((r.sig(), {k: sorted(v["images"]) for k, v in
                                      r.json()["clusters"].items()}))
            r = c.request("POST", "/api/cluster", b"junk",
                          "application/octet-stream", chunked=True)
            out.append((r.status, r.json()))
            return out

        a, b = _both(both, scenario)
        assert a == b
        assert a[0] == a[1] and a[0][0][0] == 200
        assert a[2] == (400, {"success": False,
                              "error": "Failed to parse form data"})

    def test_spa_fallback(self, both, tmp_path):
        static = tmp_path / "static"
        static.mkdir()
        (static / "index.html").write_text("<html>SPA</html>")
        (static / "app.js").write_text("console.log(1)")

        def scenario(c):
            out = []
            for path in ("/app.js", "/some/client/route", "/../job.json",
                         "/view"):
                r = c.request("GET", path)
                out.append((r.status, r.body.decode(errors="replace")))
            return out

        a, b = _both(both, scenario, static_dir=str(static))
        assert a == b
        assert a[0] == (200, "console.log(1)")
        assert a[1] == (200, "<html>SPA</html>")

    def test_paginated_view(self, both, rng):
        names, blobs = color_group_images(rng, n_groups=3, per_group=4)

        def scenario(c):
            d = c.request("POST", "/api/cluster",
                          *_form(names, blobs, minClusterSize=3,
                                 maxClusterSize=6)).json()
            job = d["jobId"]
            idx = c.request("GET", f"/api/view?job={job}")
            page = c.request("GET", f"/api/view?job={job}&page=1")
            return (idx.status, f"job={job}&amp;page=1" in idx.body.decode(),
                    page.status, page.ctype)

        a, b = _both(both, scenario, report_page_size=1)
        assert a == b
        assert a[:3] == (200, True, 200)

    def test_job_isolation(self, both, rng):
        n1, b1 = color_group_images(rng, n_groups=1, per_group=3, size=32)
        n2, b2 = color_group_images(np.random.default_rng(99), n_groups=1,
                                    per_group=3, size=48)
        n2 = [f"second_{x}" for x in n2]

        def scenario(c):
            d1 = c.request("POST", "/api/cluster",
                           *_form(n1, b1, minClusterSize=3,
                                  maxClusterSize=6)).json()
            d2 = c.request("POST", "/api/cluster",
                           *_form(n2, b2, minClusterSize=3,
                                  maxClusterSize=6)).json()
            return (d1["jobId"] != d2["jobId"],
                    c.request("GET", f"/api/image/{n1[0]}?job={d1['jobId']}"
                              ).status,
                    c.request("GET", f"/api/image/{n2[0]}").status,
                    c.request("GET", f"/api/image/{n1[0]}").status,
                    len(c.request("GET", "/api/jobs").json()["jobs"]))

        a, b = _both(both, scenario)
        assert a == b == (True, 200, 200, 404, 2)


class TestPortServer:
    def test_concurrent_posts_serialised(self, both, rng):
        _, port = both()
        n1, b1 = color_group_images(rng, n_groups=1, per_group=3, size=32)
        n2, b2 = color_group_images(np.random.default_rng(7), n_groups=2,
                                    per_group=3, size=48)
        n2 = [f"b_{x}" for x in n2]
        results = {}

        def post(key, names, blobs):
            results[key] = port.request(
                "POST", "/api/cluster",
                *_form(names, blobs, minClusterSize=3, maxClusterSize=6))

        threads = [threading.Thread(target=post, args=a)
                   for a in (("a", n1, b1), ("b", n2, b2))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        imgs = {k: {m for v in r.json()["clusters"].values()
                    for m in v["images"]} for k, r in results.items()}
        assert results["a"].status == results["b"].status == 200
        assert imgs == {"a": set(n1), "b": set(n2)}

    def test_healthz_reports_device(self, both):
        _, port = both()
        h = port.request("GET", "/healthz").json()
        assert h["backend"] == "cpu" and h["devices"] == ["cpu"]
        assert h["cuda"] == torch.version.cuda

    def test_default_device_needs_cuda(self, monkeypatch, tmp_path):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = AppConfig(service=ServiceConfig(work_dir=str(tmp_path)))
        with pytest.raises(RuntimeError, match="CUDA"):
            create_server(cfg, host="127.0.0.1", port=0)
