"""Multi-service naming fan-out with stable display ordering.

Parity with internal/ai/wrapper.go: a registry of services each with a
display ``order`` (wrapper.go:20-33), concurrent fan-out — one worker per
enabled service (wrapper.go:90-127), results sorted by order (:128-139), and
per-service graceful degradation to the fallback pair. The reference enables
only Claude Haiku (wrapper.go:36-69, others commented out); our default is
the offline fake so the system works with zero credentials, and any
combination can be enabled via NamingConfig.services.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from concurrent.futures import ThreadPoolExecutor

from imageclust_tpu_torch.config import NamingConfig
from imageclust_tpu_torch.naming.base import (
    FALLBACK_PHRASE,
    FALLBACK_TITLE,
    ModelOutput,
    Namer,
)
from imageclust_tpu_torch.utils.ratelimit import RateLimiter

log = logging.getLogger(__name__)

__all__ = ["NamingService", "RateLimiter", "create_naming_service",
           "build_namer"]


def build_namer(name: str, cfg: NamingConfig) -> Namer:
    if name == "fake":
        from imageclust_tpu_torch.naming.fake import FakeNamer

        return FakeNamer()
    if name in ("claude_haiku", "claude_sonnet"):
        from imageclust_tpu_torch.naming.bedrock import ClaudeBedrockNamer

        return ClaudeBedrockNamer(
            variant=name.split("_")[1],
            region=cfg.bedrock_region,
            retry_delay_s=cfg.retry_delay_s,
        )
    if name == "nova_micro":
        from imageclust_tpu_torch.naming.bedrock import NovaBedrockNamer

        return NovaBedrockNamer(region=cfg.bedrock_region,
                                retry_delay_s=cfg.retry_delay_s)
    if name in ("gpt-3.5-turbo", "gpt-4", "gpt35", "gpt4"):
        from imageclust_tpu_torch.naming.openai_backend import OpenAINamer

        model = {"gpt35": "gpt-3.5-turbo", "gpt4": "gpt-4"}.get(name, name)
        return OpenAINamer(model=model, retry_delay_s=cfg.retry_delay_s)
    raise ValueError(f"unknown naming service {name!r}")


class NamingService:
    def __init__(self, namers: list[Namer], retries: int = 3,
                 cluster_concurrency: int = 16,
                 rate_limit_rps: float = 0.0):
        self.namers = namers
        self.retries = retries
        self.cluster_concurrency = max(1, cluster_concurrency)
        self.limiter = RateLimiter(rate_limit_rps)

    def generate_multi(self, aggregated_text: str) -> list[ModelOutput]:
        """Fan out to every enabled service concurrently; return outputs
        sorted by display order (wrapper.go:90-139 semantics)."""
        if not self.namers:
            return []

        def run(namer: Namer) -> ModelOutput:
            try:
                self.limiter.acquire()
                title, phrase = namer.generate(aggregated_text, self.retries)
            except Exception as exc:  # a backend must never kill the job
                log.error("namer %s raised: %s", namer.name, exc)
                title, phrase = FALLBACK_TITLE, FALLBACK_PHRASE
            return ModelOutput(namer.name, title, phrase, namer.order)

        with ThreadPoolExecutor(max_workers=len(self.namers)) as pool:
            outputs = list(pool.map(run, self.namers))
        return sorted(outputs, key=lambda o: o.order)

    def name_clusters(
        self,
        texts: dict[str, str],
        state_path: str | None = None,
        progress=None,
    ) -> dict[str, list[ModelOutput]]:
        """Name MANY clusters with bounded concurrency — the serving-tail
        counterpart of the engine's 100k tier, where ~21k clusters named
        one-by-one (the reference's loop, workflow.go:187-229) would take
        hours against a ~1 s/request backend.

        * ``cluster_concurrency`` clusters are in flight at once; within
          each, services fan out exactly as :meth:`generate_multi` (the
          per-cluster contract, wrapper.go:90-140, is unchanged).
        * every LLM request passes the shared :class:`RateLimiter`.
        * ``state_path``: JSONL of finished clusters, appended as each
          completes (atomic enough for crash recovery: a torn last line is
          discarded on load). Re-running the same job resumes — already
          named clusters are served from the file without an LLM call.
        * ``progress(done, total)`` is invoked on each completion; by
          default a log line is emitted every ~5%.
        """
        done: dict[str, list[ModelOutput]] = {}
        if state_path and os.path.exists(state_path):
            done = _load_naming_state(state_path, texts)
            if done:
                log.info("naming state: %d/%d clusters already named",
                         len(done), len(texts))
        todo = [cid for cid in texts if cid not in done]
        total = len(texts)
        if not todo:
            return {cid: done[cid] for cid in texts}

        every = max(1, total // 20)
        lock = threading.Lock()
        state_fh = None
        if state_path:
            # a crash can leave a torn final line WITHOUT its newline — seal
            # it so the next append doesn't merge into it (losing both)
            if os.path.exists(state_path) and os.path.getsize(state_path):
                with open(state_path, "rb") as fh:
                    fh.seek(-1, os.SEEK_END)
                    sealed = fh.read(1) == b"\n"
            else:
                sealed = True
            state_fh = open(state_path, "a", encoding="utf-8")
            if not sealed:
                state_fh.write("\n")
        counter = [len(done)]

        def run(cid: str) -> tuple[str, list[ModelOutput]]:
            outs = self.generate_multi(texts[cid])
            # all-fallback outputs mean every backend failed (throttle or
            # outage) — persisting them would cache the failure forever,
            # turning the documented re-run recovery path into a no-op
            worth_saving = any(o.title != FALLBACK_TITLE
                               or o.catchy_phrase != FALLBACK_PHRASE
                               for o in outs)
            with lock:
                counter[0] += 1
                n = counter[0]
                if state_fh is not None and worth_saving:
                    state_fh.write(json.dumps({
                        "cluster": cid,
                        "text_sha": _text_sha(texts[cid]),
                        "outputs": [[o.service_name, o.title,
                                     o.catchy_phrase, o.order]
                                    for o in outs],
                    }) + "\n")
                    state_fh.flush()
            if progress is not None:
                progress(n, total)
            elif n % every == 0 or n == total:
                log.info("naming: %d/%d clusters", n, total)
            return cid, outs

        try:
            with ThreadPoolExecutor(
                    max_workers=self.cluster_concurrency) as pool:
                for cid, outs in pool.map(run, todo):
                    done[cid] = outs
        finally:
            if state_fh is not None:
                state_fh.close()
        return {cid: done[cid] for cid in texts}

    def generate(self, aggregated_text: str, service_name: str) -> ModelOutput:
        """Single-service path (wrapper.go:72-87)."""
        for namer in self.namers:
            if namer.name == service_name:
                title, phrase = namer.generate(aggregated_text, self.retries)
                return ModelOutput(namer.name, title, phrase, namer.order)
        return ModelOutput(service_name, FALLBACK_TITLE, FALLBACK_PHRASE, 0)


def _text_sha(text: str) -> str:
    import hashlib

    return hashlib.sha256(text.encode("utf-8")).hexdigest()[:16]


def _load_naming_state(
        path: str, texts: dict[str, str]) -> dict[str, list[ModelOutput]]:
    """Parse a naming-state JSONL, dropping a torn trailing line and any
    record whose cluster id OR aggregated label text doesn't match the
    current job. The generic ``Cluster-N`` ids collide across different
    corpora sharing a work dir, so each record carries the sha of the text
    it was named FROM — identical text makes reuse correct by construction
    (the LLM request is a pure function of the text), anything else is
    stale and must be renamed."""
    out: dict[str, list[ModelOutput]] = {}
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                cid = rec["cluster"]
                sha = rec["text_sha"]
                outs = [ModelOutput(s, t, p, o)
                        for s, t, p, o in rec["outputs"]]
            except (ValueError, KeyError, TypeError):
                continue  # torn write from a crash mid-line, or pre-sha state
            if cid in texts and sha == _text_sha(texts[cid]):
                out[cid] = outs
    return out


def create_naming_service(cfg: NamingConfig | None = None) -> NamingService:
    cfg = cfg or NamingConfig()
    namers = [build_namer(name, cfg) for name in cfg.services if name != "none"]
    return NamingService(namers, retries=cfg.retries,
                         cluster_concurrency=cfg.cluster_concurrency,
                         rate_limit_rps=cfg.rate_limit_rps)
