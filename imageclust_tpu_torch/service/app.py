"""HTTP service: the reference's REST surface on the standard library.

The same routes, JSON shapes, CORS headers and status codes as the JAX
package's aiohttp app (``imageclust_tpu/service/app.py``), on
``http.server.ThreadingHTTPServer`` (GPU hosts may have no aiohttp):

* ``POST /api/cluster`` — multipart ``images`` files plus optional
  ``minClusterSize`` / ``maxClusterSize``; ``?async=1`` enqueues and
  returns 202, poll ``GET /api/result``. The body (``Content-Length`` or
  chunked) is parsed as it arrives, in chunks of at most 64 KiB, and the
  upload cap counts image bytes only, mid-stream, as the JAX app counts
  them (413 past ``service.max_upload_bytes``).
* ``GET /api/view`` (``?job=``, ``&page=``, ``&sec=``), ``/api/image/{name}``,
  ``/api/result``, ``/api/jobs``, ``/metrics``, ``/healthz`` and the SPA
  static fallback with the ``/view`` alias.

One lock serialises pipeline runs: one model, one device queue.
``/healthz`` reports the CUDA device name and CUDA version.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from email.parser import BytesParser
from email.policy import HTTP
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlsplit

from imageclust_tpu_torch.config import AppConfig
from imageclust_tpu_torch.data.loader import sanitize_filename
from imageclust_tpu_torch.service.jobs import JobStore
from imageclust_tpu_torch.types import UploadedImage

log = logging.getLogger(__name__)

__all__ = ["create_server", "run_server", "ClusterService"]

_MIME = {  # handlers.go:161-171 table (default image/jpeg)
    ".png": "image/png",
    ".gif": "image/gif",
    ".webp": "image/webp",
}
_CORS = (
    ("Access-Control-Allow-Origin", "*"),
    ("Access-Control-Allow-Methods", "POST, GET, OPTIONS, PUT, DELETE"),
    ("Access-Control-Allow-Headers", "Content-Type"),
)


class _Reply:
    """A finished response: status, body bytes, content type."""

    def __init__(self, status: int, body: bytes, ctype: str):
        self.status, self.body, self.ctype = status, body, ctype


def _json(status: int, obj) -> _Reply:
    return _Reply(status, json.dumps(obj).encode(), "application/json")


def _error(status: int, message: str) -> _Reply:
    return _json(status, {"success": False, "error": message})


def _file(path: str, ctype: str | None = None) -> _Reply:
    with open(path, "rb") as fh:
        body = fh.read()
    if ctype is None:
        ext = os.path.splitext(path)[1].lower()
        ctype = {".html": "text/html", ".js": "application/javascript",
                 ".css": "text/css", ".json": "application/json"}.get(
                     ext, _MIME.get(ext, "application/octet-stream"))
    return _Reply(200, body, ctype)


_CHUNK = 1 << 16  # body reads, as the JAX app's read_chunk(64 KiB)
_MAX_PART_HEADERS = 1 << 16
_MAX_FIELD = 1 << 16  # a form field's value (minClusterSize, ...)


class _MultipartStream:
    """Incremental multipart/form-data parser. :meth:`feed` takes body
    bytes as they arrive and returns events: ``("part", (name, filename))``
    at a part's start, ``("data", bytes)`` for its raw content (no
    transfer decoding, as the JAX app reads it), ``("end", None)`` at its
    end. Raises ValueError on a content type that is not multipart with a
    boundary (aiohttp's check) or on malformed part headers."""

    def __init__(self, ctype: str):
        msg = BytesParser(policy=HTTP).parsebytes(
            b"Content-Type: " + ctype.encode("latin-1") + b"\r\n\r\n")
        boundary = msg.get_param("boundary")
        if msg.get_content_maintype() != "multipart" or not boundary:
            raise ValueError("multipart/* content type with a boundary "
                             "expected")
        self._delim = b"--" + str(boundary).encode("latin-1")
        self._buf = b""
        self._state = "preamble"

    def feed(self, data: bytes) -> list:
        self._buf += data
        events: list = []
        while self._step(events):
            pass
        return events

    def events(self, body):
        """Every event of ``body`` (an iterable of byte chunks), lazily:
        the caller stops reading where it stops iterating."""
        for chunk in body:
            yield from self.feed(chunk)
        yield from self.close()

    def close(self) -> list:
        """Events at the end of the body: a part cut off by it ends there
        (the lenient reading the email parser gave)."""
        if self._state == "body":
            self._state = "done"
            return [("data", self._buf), ("end", None)]
        return []

    def _step(self, events: list) -> bool:
        buf, delim = self._buf, self._delim
        if self._state == "preamble":
            i = buf.find(delim)
            if i < 0:
                self._buf = buf[max(0, len(buf) - len(delim) + 1):]
                return False
            self._buf, self._state = buf[i + len(delim):], "after_delim"
            return True
        if self._state == "after_delim":
            if len(buf) < 2:
                return False
            if buf[:2] == b"--":  # the closing delimiter
                self._buf, self._state = b"", "done"
                return False
            i = buf.find(b"\r\n")
            if i < 0:
                if len(buf) > _MAX_PART_HEADERS:
                    raise ValueError("malformed delimiter line")
                return False
            self._buf, self._state = buf[i + 2:], "headers"
            return True
        if self._state == "headers":
            i = buf.find(b"\r\n\r\n")
            if i < 0:
                if len(buf) > _MAX_PART_HEADERS:
                    raise ValueError("part headers too long")
                return False
            part = BytesParser(policy=HTTP).parsebytes(buf[:i + 4])
            name = part.get_param("name", header="content-disposition")
            events.append(("part", (name, part.get_filename())))
            self._buf, self._state = buf[i + 4:], "body"
            return True
        if self._state == "body":
            i = buf.find(b"\r\n" + delim)
            if i < 0:  # keep what could be the start of the delimiter
                keep = len(delim) + 1
                if len(buf) > keep:
                    events.append(("data", buf[:-keep]))
                    self._buf = buf[-keep:]
                return False
            if i:
                events.append(("data", buf[:i]))
            events.append(("end", None))
            self._buf = buf[i + 2 + len(delim):]
            self._state = "after_delim"
            return True
        self._buf = b""  # done: the epilogue is ignored
        return False


class ClusterService:
    """Route handlers, independent of the HTTP server that calls them."""

    def __init__(self, config: AppConfig, pipeline, jobs: JobStore):
        from imageclust_tpu_torch.utils.metrics import ServiceMetrics

        self.config = config
        self.pipeline = pipeline
        self.jobs = jobs
        self.run_lock = threading.Lock()  # one pipeline run at a time
        self.svc_metrics = ServiceMetrics()
        self._threads: set[threading.Thread] = set()
        self.static_dir = self._resolve_static(config.service.static_dir)

    @staticmethod
    def _resolve_static(static_dir: str) -> str:
        if static_dir and not os.path.isabs(static_dir) \
                and not os.path.isdir(static_dir):
            # resolve the default "frontend/build" relative to the repo root
            repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
            candidate = os.path.join(repo_root, static_dir)
            if os.path.isdir(candidate):
                return candidate
        return static_dir

    # -- pipeline runs -------------------------------------------------------

    def _record_run(self, result, ok: bool) -> None:
        self.svc_metrics.inc("imageclust_jobs_total")
        if ok:
            self.svc_metrics.observe_run(result.metrics)
        else:
            self.svc_metrics.inc("imageclust_jobs_failed_total")

    def _write_result(self, job, result) -> None:
        # atomic: a concurrent GET /api/result must never read a partial file
        path = os.path.join(job.work_dir, "result.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(result.to_dict(), fh)
        os.replace(tmp, path)

    def _run_pipeline(self, job, uploads, min_size, max_size):
        with self.run_lock:
            return self.pipeline.run(
                uploads, job.work_dir, min_size, max_size,
                image_route=f"/api/image/{{name}}?job={job.job_id}",
                report_routes=(
                    f"/api/view?job={job.job_id}&page={{page}}",
                    f"/api/view?job={job.job_id}",
                    f"/api/view?job={job.job_id}&sec={{sec}}",
                ),
            )

    def _prune(self) -> None:
        self.jobs.prune(self.config.service.max_jobs,
                        self.config.service.max_job_age_s)

    def _run_job_background(self, job, uploads, min_size, max_size) -> None:
        try:
            result = self._run_pipeline(job, uploads, min_size, max_size)
            self._write_result(job, result)
            self.jobs.set_status(job, "done")
            self._record_run(result, True)
        except Exception as exc:
            log.exception("async job %s failed", job.job_id)
            self.jobs.set_status(job, "failed", str(exc))
            self._record_run(None, False)
        finally:
            self._prune()

    def _spawn(self, fn, *args) -> None:
        def run():
            try:
                fn(*args)
            finally:
                self._threads.discard(threading.current_thread())

        t = threading.Thread(target=run, daemon=True)
        self._threads.add(t)
        t.start()

    def wait_background(self, timeout: float | None = None) -> None:
        """Join the background job threads (used at shutdown and in tests)."""
        for t in list(self._threads):
            t.join(timeout)

    # -- routes ----------------------------------------------------------------

    def cluster(self, query: dict, ctype: str, body) -> _Reply:
        """``POST /api/cluster``. ``body``: the request body as an iterable
        of byte chunks, read only as far as the reply needs."""
        cfg = self.config
        cap = cfg.service.max_upload_bytes
        uploads: list[UploadedImage] = []
        sizes = {"minClusterSize": cfg.cluster.min_size,
                 "maxClusterSize": cfg.cluster.max_size}
        total_bytes = 0
        name = filename = None
        data: list[bytes] = []
        field_len = 0
        try:
            for kind, value in _MultipartStream(ctype).events(body):
                if kind == "part":
                    (name, filename), data, field_len = value, [], 0
                elif kind == "data" and name == "images" and filename:
                    # the cap counts image bytes, mid-stream (JAX
                    # app.py:151-169): one oversized request never
                    # sits in memory whole
                    total_bytes += len(value)
                    if total_bytes > cap:
                        return _error(
                            413, f"upload exceeds {cap} bytes")
                    data.append(value)
                elif kind == "data" and name in sizes:
                    field_len += len(value)
                    if field_len <= _MAX_FIELD:
                        data.append(value)
                elif kind == "end" and name == "images" and filename:
                    if data:
                        uploads.append(UploadedImage(
                            sanitize_filename(filename), b"".join(data)))
                elif kind == "end" and name in sizes:
                    try:
                        if field_len > _MAX_FIELD:
                            raise ValueError(name)
                        sizes[name] = int(b"".join(data).decode().strip())
                    except (ValueError, UnicodeDecodeError):
                        return _error(400, f"invalid {name}")
        except ValueError:
            return _error(400, "Failed to parse form data")  # handlers.go:73
        min_size = sizes["minClusterSize"]
        max_size = sizes["maxClusterSize"]
        if not uploads:
            return _error(400, "No valid images uploaded")  # handlers.go:107
        if min_size < 1 or max_size < min_size:
            return _error(400,
                          f"invalid cluster sizes [{min_size}, {max_size}]")

        job = self.jobs.create()
        self.jobs.set_status(job, "running")

        # ?async=1 — enqueue and return immediately; poll GET /api/result.
        if query.get("async") in ("1", "true"):
            self._spawn(self._run_job_background, job, uploads, min_size,
                        max_size)
            return _json(202, {"status": "accepted", "jobId": job.job_id,
                               "resultUrl": f"/api/result?job={job.job_id}"})

        try:
            result = self._run_pipeline(job, uploads, min_size, max_size)
        except Exception as exc:
            log.exception("job %s failed", job.job_id)
            self.jobs.set_status(job, "failed", str(exc))
            self._record_run(None, False)
            return _error(500, str(exc))
        finally:
            # retention applies on failures too, off the request thread
            self._spawn(self._prune)
        self._write_result(job, result)  # before 'done': pollers of
        self.jobs.set_status(job, "done")  # /api/result never see done-
        self._record_run(result, True)  # without-result
        return _json(200, {
            "status": "success",  # handlers.go:123-127 contract
            "filePath": result.html_path,
            "jobId": job.job_id,
            "viewUrl": f"/api/view?job={job.job_id}",
            "clusters": {k: v.to_dict() for k, v in result.clusters.items()},
            "dropped": result.dropped,
            "metrics": result.metrics.to_dict(),
        })

    def view(self, query: dict) -> _Reply:
        job = self.jobs.get(query.get("job"))
        if job is None or not os.path.exists(job.html_path):
            return _error(404, "No HTML file available")  # handlers.go:134
        # page=N -> card page; sec=N -> section index (two-level reports)
        for param, stem in (("page", "clusters_p"), ("sec", "clusters_ix")):
            value = query.get(param)
            if value is None:
                continue
            if not value.isdigit():  # int-only: no path material in the name
                return _error(400, f"invalid {param}")
            ppath = os.path.join(os.path.dirname(job.html_path),
                                 f"{stem}{int(value)}.html")
            if not os.path.exists(ppath):
                return _error(404, "no such report page")
            return _file(ppath)
        return _file(job.html_path)

    def image(self, raw_name: str, query: dict) -> _Reply:
        name = sanitize_filename(raw_name)
        job = self.jobs.get(query.get("job"))
        if job is None:
            return _error(404, "No images available")  # handlers.go:148
        path = os.path.join(job.image_dir, name)
        if not os.path.isfile(path):
            return _error(404, "Image not found")  # handlers.go:157
        ext = os.path.splitext(name)[1].lower()
        return _file(path, _MIME.get(ext, "image/jpeg"))

    def result(self, query: dict) -> _Reply:
        job = self.jobs.get(query.get("job"))
        if job is None:
            return _error(404, "no such job")
        path = os.path.join(job.work_dir, "result.json")
        if not os.path.exists(path):
            return _json(200, job.meta_dict())
        try:
            with open(path) as fh:
                return _json(200, json.load(fh))
        except (OSError, json.JSONDecodeError):
            # pruned or mid-write: report the job meta instead of a 500
            return _json(200, job.meta_dict())

    def health(self) -> _Reply:
        import torch

        dev = self.pipeline.device
        cuda = dev.type == "cuda"
        return _json(200, {
            "ok": True,
            "backend": dev.type,
            "devices": [torch.cuda.get_device_name(dev) if cuda else "cpu"],
            "cuda": torch.version.cuda,
            "model": self.pipeline.embedder.spec.name,
        })

    def spa(self, path: str) -> _Reply:
        # handlers.go:199-214: static file, then index.html
        static_dir = self.static_dir
        rel = path.lstrip("/")
        if rel and static_dir:
            candidate = os.path.realpath(os.path.join(static_dir, rel))
            if (candidate.startswith(os.path.realpath(static_dir) + os.sep)
                    and os.path.isfile(candidate)):
                return _file(candidate)
        index = os.path.join(static_dir, "index.html") if static_dir else ""
        if index and os.path.isfile(index):
            return _file(index, "text/html")
        return _error(404, "not found")

    def handle(self, method: str, target: str, headers, body) -> _Reply:
        """Route one request. ``body``: an iterable of byte chunks, which
        only ``POST /api/cluster`` reads."""
        url = urlsplit(target)
        path = unquote(url.path)
        query = {k: v[-1] for k, v in parse_qs(url.query).items()}
        if method == "OPTIONS":
            return _Reply(200, b"", "text/plain")
        if method == "POST":
            if path == "/api/cluster":
                return self.cluster(query, headers.get("Content-Type", ""),
                                    body)
            return _error(405, "method not allowed")
        if method not in ("GET", "HEAD"):  # HEAD: GET without the body
            return _error(405, "method not allowed")
        if path in ("/api/view", "/view"):
            return self.view(query)
        if path.startswith("/api/image/"):
            return self.image(path[len("/api/image/"):], query)
        if path == "/api/result":
            return self.result(query)
        if path == "/api/jobs":
            return _json(200, {"jobs": self.jobs.list_jobs()})
        if path == "/metrics":
            return _Reply(200, self.svc_metrics.render().encode(),
                          "text/plain")
        if path == "/healthz":
            return self.health()
        return self.spa(path)


def _handler_class(service: ClusterService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route to logging, not stderr
            log.debug("%s " + fmt, self.address_string(), *args)

        def _send(self, reply: _Reply) -> None:
            self.send_response(reply.status)
            self.send_header("Content-Type", reply.ctype)
            self.send_header("Content-Length", str(len(reply.body)))
            for k, v in _CORS:
                self.send_header(k, v)
            self.end_headers()
            if self.command != "HEAD":
                self.wfile.write(reply.body)

        def _body(self, state: dict):
            """The request body in chunks of at most 64 KiB: its
            ``Content-Length`` bytes, or a chunked transfer coding decoded.
            ``state["done"]`` turns True once the body was read whole."""
            if "chunked" in self.headers.get("Transfer-Encoding", "").lower():
                while True:
                    line = self.rfile.readline(_CHUNK + 1)
                    size = int(line.split(b";")[0].strip(), 16)
                    if size == 0:  # the last chunk, then trailers
                        while self.rfile.readline(_CHUNK + 1) not in (
                                b"\r\n", b"\n", b""):
                            pass
                        break
                    while size > 0:
                        data = self.rfile.read(min(size, _CHUNK))
                        if not data:
                            return
                        size -= len(data)
                        yield data
                    self.rfile.readline(_CHUNK + 1)  # the chunk's CRLF
            else:
                length = int(self.headers.get("Content-Length") or 0)
                while length > 0:
                    data = self.rfile.read(min(length, _CHUNK))
                    if not data:
                        return
                    length -= len(data)
                    yield data
            state["done"] = True

        def _serve(self) -> None:
            state = {"done": False}
            body = self._body(state)
            try:
                reply = service.handle(self.command, self.path, self.headers,
                                       body)
            except Exception as exc:  # a route bug must not kill the server
                log.exception("request %s %s failed", self.command, self.path)
                reply = _error(500, str(exc))
            try:
                for _ in body:  # drain what the route left unread (the
                    pass        # client may still be sending)
            except ValueError:  # a malformed chunk size
                pass
            if not state["done"] or reply.status == 413:
                self.close_connection = True
            self._send(reply)

        do_GET = do_HEAD = do_POST = do_OPTIONS = do_PUT = do_DELETE = _serve

    return Handler


def create_server(
    config: AppConfig | None = None,
    pipeline=None,
    job_store: JobStore | None = None,
    *,
    device=None,
    host: str | None = None,
    port: int | None = None,
) -> ThreadingHTTPServer:
    """Build the server (not yet serving). Without ``pipeline`` a
    :class:`~imageclust_tpu_torch.pipeline.Pipeline` is built on ``device``
    (default ``"cuda"``). ``server.service`` is the :class:`ClusterService`;
    ``port=0`` binds a free port (``server.server_address[1]``)."""
    config = config or AppConfig()
    if pipeline is None:
        from imageclust_tpu_torch.pipeline import Pipeline

        pipeline = Pipeline(config, device=device)
    jobs = job_store or JobStore(config.service.work_dir or None)
    service = ClusterService(config, pipeline, jobs)
    server = ThreadingHTTPServer(
        (config.service.host if host is None else host,
         config.service.port if port is None else port),
        _handler_class(service))
    server.daemon_threads = True
    server.service = service
    return server


def run_server(config: AppConfig | None = None, device=None) -> None:
    config = config or AppConfig()
    server = create_server(config, device=device)
    log.info("Server starting on %s:%d", *server.server_address[:2])
    try:
        server.serve_forever()
    finally:
        server.server_close()
