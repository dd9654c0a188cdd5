"""OpenAI chat-completions naming backend.

Parity with internal/ai/openai/openai.go: direct HTTP to
api.openai.com/v1/chat/completions (openai.go:100), OPENAI_API_KEY from the
environment (:55), GPT-4 / GPT-3.5-turbo configs (:21-30), system+user
messages (:63-79), 60 s timeout (:111-113), explicit 429 backoff (:124-128),
retries with 2 s sleeps, fallback pair on exhaustion.

The request goes through the port's one transport function
(``utils.aws.http_request``, the standard library's HTTP client) with the
body bytes that ``requests.post(json=payload)`` sends.
"""

from __future__ import annotations

import json
import logging
import os
import time

from imageclust_tpu_torch.naming.base import (
    FALLBACK_PHRASE,
    FALLBACK_TITLE,
    NAMING_PROMPT,
    extract_title_phrase,
    truncate_and_sanitize,
)
from imageclust_tpu_torch.utils import aws

log = logging.getLogger(__name__)

__all__ = ["OpenAINamer"]

_API_URL = "https://api.openai.com/v1/chat/completions"

_MODELS = {
    "gpt-3.5-turbo": {"name": "OpenAI GPT-3.5 Turbo", "order": 2},
    "gpt-4": {"name": "Open AI GPT-4", "order": 3},  # wrapper.go:51 spelling
}


class OpenAINamer:
    def __init__(self, model: str = "gpt-3.5-turbo",
                 retry_delay_s: float = 2.0, timeout_s: float = 60.0):
        meta = _MODELS.get(model, {"name": f"OpenAI {model}", "order": 9})
        self.model = model
        self.name = meta["name"]
        self.order = meta["order"]
        self.retry_delay_s = retry_delay_s
        self.timeout_s = timeout_s

    def generate(self, aggregated_text: str, retries: int) -> tuple[str, str]:
        api_key = os.environ.get("OPENAI_API_KEY", "")
        if not api_key:
            log.warning("OPENAI_API_KEY not set — OpenAI namer falling back")
            return FALLBACK_TITLE, FALLBACK_PHRASE
        sanitized = truncate_and_sanitize(aggregated_text, 1000)
        payload = {
            "model": self.model,
            "messages": [
                {"role": "system",
                 "content": "You generate concise titles and catchy phrases "
                            "for image clusters and reply with JSON only."},
                {"role": "user",
                 "content": NAMING_PROMPT.format(features=sanitized)},
            ],
            "max_tokens": 100,
            "temperature": 0.7,
        }
        body = json.dumps(payload, allow_nan=False).encode("utf-8")
        headers = {"Authorization": f"Bearer {api_key}",
                   "Content-Type": "application/json"}
        for attempt in range(retries):
            try:
                status, raw = aws.http_request(
                    "POST", _API_URL, body, headers, self.timeout_s)
                if status == 429:  # openai.go:124-128
                    log.warning("OpenAI rate limited (attempt %d)", attempt + 1)
                elif status == 200:
                    text = json.loads(raw)["choices"][0]["message"]["content"]
                    parsed = extract_title_phrase(text)
                    if parsed:
                        return parsed
                    log.warning("OpenAI: unparseable content (attempt %d)",
                                attempt + 1)
                else:
                    log.warning("OpenAI: HTTP %d (attempt %d)",
                                status, attempt + 1)
            except (OSError, KeyError, ValueError) as exc:
                log.warning("OpenAI request failed (attempt %d): %s",
                            attempt + 1, exc)
            if attempt + 1 < retries:
                time.sleep(self.retry_delay_s)
        return FALLBACK_TITLE, FALLBACK_PHRASE
