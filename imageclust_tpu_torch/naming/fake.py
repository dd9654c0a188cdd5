"""Deterministic offline namer (the reference has none and cannot name
clusters without cloud credentials)."""

from __future__ import annotations

from imageclust_tpu_torch.naming.base import truncate_and_sanitize

__all__ = ["FakeNamer"]


class FakeNamer:
    name = "Offline Namer"
    order = 0
    remote = False  # pure Python: threads would only contend for the GIL

    def generate(self, aggregated_text: str, retries: int) -> tuple[str, str]:
        words = [w.strip(" ,") for w in
                 truncate_and_sanitize(aggregated_text).split() if w.strip(" ,")]
        head = words[:2] if words else ["Untitled"]
        title = " ".join(head)[:25]
        phrase = ("A collection featuring " + ", ".join(words[:4]))[:100] \
            if words else "A curated image collection"
        return title or "Untitled", phrase
