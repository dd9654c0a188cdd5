"""AWS Bedrock naming backends: Claude Haiku, Claude Sonnet, Amazon Nova.

Parity with internal/ai/claude-haiku/claude-haiku.go, claude-sonnet.go and
amazon-nova-micro.go: same model ids, request shapes (anthropic_version
bedrock-2023-05-31, max_tokens 100, temperature 0.7), us-west-2 region,
bounded retries with fixed 2 s sleeps, and the ("No Title", "No phrase
available") fallback. Transport is hand-signed SigV4 HTTP over the standard
library (utils/aws.py; no AWS SDK here). A throttle (HTTP 429), any other
error status, an unparseable body and a connection failure each cost one
attempt.
"""

from __future__ import annotations

import logging
import time
import urllib.parse

from imageclust_tpu_torch.naming.base import (
    FALLBACK_PHRASE,
    FALLBACK_TITLE,
    NAMING_PROMPT,
    extract_title_phrase,
    truncate_and_sanitize,
)
from imageclust_tpu_torch.utils.aws import AwsCredentials, AwsError, aws_post_json

log = logging.getLogger(__name__)

__all__ = ["ClaudeBedrockNamer", "NovaBedrockNamer"]

CLAUDE_HAIKU_MODEL_ID = "anthropic.claude-3-haiku-20240307-v1:0"  # claude-haiku.go:92
CLAUDE_SONNET_MODEL_ID = "anthropic.claude-3-sonnet-20240229-v1:0"  # claude-sonnet.go:92
NOVA_MICRO_MODEL_ID = "us.amazon.nova-micro-v1:0"  # amazon-nova-micro.go:38


class _BedrockNamer:
    region = "us-west-2"  # claude-haiku.go:46
    retry_delay_s = 2.0  # claude-haiku.go:102
    name = "bedrock"
    order = 0
    model_id = ""

    def __init__(self, region: str | None = None, retry_delay_s: float | None = None,
                 creds: AwsCredentials | None = None):
        if region:
            self.region = region
        if retry_delay_s is not None:
            self.retry_delay_s = retry_delay_s
        self.creds = creds

    def _invoke(self, payload: dict) -> dict:
        model = urllib.parse.quote(self.model_id, safe="")
        url = (
            f"https://bedrock-runtime.{self.region}.amazonaws.com"
            f"/model/{model}/invoke"
        )
        return aws_post_json(
            url,
            region=self.region,
            service="bedrock",
            payload=payload,
            content_type="application/json",
            creds=self.creds,
        )

    def _request_payload(self, prompt: str) -> dict:
        raise NotImplementedError

    def _response_text(self, response: dict) -> str | None:
        raise NotImplementedError

    def generate(self, aggregated_text: str, retries: int) -> tuple[str, str]:
        sanitized = truncate_and_sanitize(aggregated_text, 1000)
        prompt = NAMING_PROMPT.format(features=sanitized)
        for attempt in range(retries):
            try:
                response = self._invoke(self._request_payload(prompt))
                text = self._response_text(response)
                if text:
                    parsed = extract_title_phrase(text)
                    if parsed:
                        return parsed
                log.warning("%s: unparseable response (attempt %d)",
                            self.name, attempt + 1)
            except (AwsError, OSError) as exc:
                log.warning("%s: invoke failed (attempt %d): %s",
                            self.name, attempt + 1, exc)
            if attempt + 1 < retries:
                time.sleep(self.retry_delay_s)
        log.warning("%s: falling back after %d attempts", self.name, retries)
        return FALLBACK_TITLE, FALLBACK_PHRASE


class ClaudeBedrockNamer(_BedrockNamer):
    """Claude via Bedrock Messages API (claude-haiku.go:61-77)."""

    def __init__(self, variant: str = "haiku", **kw):
        super().__init__(**kw)
        if variant == "haiku":
            self.model_id = CLAUDE_HAIKU_MODEL_ID
            self.name = "Claude Haiku v3.5"  # wrapper.go:57
            self.order = 4  # wrapper.go:59
        elif variant == "sonnet":
            self.model_id = CLAUDE_SONNET_MODEL_ID
            self.name = "Claude Sonnet v3.5"  # wrapper.go:64 (commented set)
            self.order = 5
        else:
            raise ValueError(f"unknown claude variant {variant!r}")

    def _request_payload(self, prompt: str) -> dict:
        return {
            "anthropic_version": "bedrock-2023-05-31",
            "messages": [{"role": "user", "content": prompt}],
            "max_tokens": 100,
            "temperature": 0.7,
        }

    def _response_text(self, response: dict) -> str | None:
        content = response.get("content") or []
        if content and isinstance(content[0], dict):
            return content[0].get("text")
        return None


class NovaBedrockNamer(_BedrockNamer):
    """Amazon Nova Micro (amazon-nova-micro.go:24-156)."""

    model_id = NOVA_MICRO_MODEL_ID
    name = "Amazon Nova Micro"  # wrapper.go:39 (commented set)
    order = 1

    def _request_payload(self, prompt: str) -> dict:
        return {"inputText": prompt}  # amazon-nova-micro.go:55-57

    def _response_text(self, response: dict) -> str | None:
        results = response.get("Results") or response.get("results") or []
        if results and isinstance(results[0], dict):
            return results[0].get("outputText")
        return None
