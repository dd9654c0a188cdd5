"""LLM cluster-naming interfaces and shared helpers.

Parity targets in the reference:
* output contract: (title <= 25 chars, catchy_phrase <= 100 chars) as JSON
  (internal/ai/claude-haiku/claude-haiku.go:66-72),
* graceful fallback ("No Title", "No phrase available") after bounded
  retries (claude-haiku.go:149-150),
* input sanitation: truncate to 1000 runes, strip quotes/backslashes/
  newlines/tabs/#, '&' -> 'and', drop apostrophes (claude-haiku.go:153-169).
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from typing import Protocol

__all__ = [
    "ModelOutput",
    "Namer",
    "FALLBACK_TITLE",
    "FALLBACK_PHRASE",
    "truncate_and_sanitize",
    "extract_title_phrase",
    "NAMING_PROMPT",
]

FALLBACK_TITLE = "No Title"
FALLBACK_PHRASE = "No phrase available"

NAMING_PROMPT = (
    "You are an assistant that generates concise and creative titles and "
    "catchy phrases for image clusters.\n"
    "Each title must be no more than 25 characters, and each catchy phrase "
    "must be no more than 100 characters. \n"
    "Return the results in JSON format with the fields 'title' and "
    "'catchy_phrase' only.\n"
    "Do not include any extra text, markdown, or code block formatting in "
    "your response.\n"
    "Ensure that only the JSON object is returned.\n\n"
    "Features: {features}."
)


@dataclass(frozen=True)
class ModelOutput:
    """One service's naming result (mirrors ai.ModelOutput, wrapper.go:26-33
    and models.ServiceOutput, models.go:4-8)."""

    service_name: str
    title: str
    catchy_phrase: str
    order: int = 0


class Namer(Protocol):
    name: str
    order: int

    def generate(self, aggregated_text: str, retries: int) -> tuple[str, str]:
        """Return (title, catchy_phrase); must not raise — degrade to the
        fallback pair instead."""
        ...


def truncate_and_sanitize(text: str, max_len: int = 1000) -> str:
    """claude-haiku.go:153-169 semantics."""
    if len(text) > max_len:
        text = text[:max_len]
    text = text.replace('"', "")
    text = text.replace("\\", "")
    text = text.replace("\n", " ")
    text = text.replace("\t", " ")
    text = text.replace("#", "")
    text = text.replace("&", "and")
    text = text.replace("'", "")
    return text.strip()


def _first_str(value) -> str | None:
    """Tolerant field extraction: accept a string or a list of strings —
    the Nova backend's string-or-array tolerance
    (amazon-nova-micro.go:122-134)."""
    if isinstance(value, str):
        return value
    if isinstance(value, list) and value and isinstance(value[0], str):
        return value[0]
    return None


def extract_title_phrase(response_text: str) -> tuple[str, str] | None:
    """Parse the model's JSON reply into (title, catchy_phrase); returns None
    on any shape problem (the caller retries, claude-haiku.go:128-144).
    Tolerates surrounding text/markdown fences by scanning for the first
    JSON object."""
    candidates = [response_text]
    m = re.search(r"\{.*\}", response_text, re.DOTALL)
    if m:
        candidates.append(m.group(0))
    for cand in candidates:
        try:
            obj = json.loads(cand)
        except json.JSONDecodeError:
            continue
        if not isinstance(obj, dict):
            continue
        title = _first_str(obj.get("title"))
        phrase = _first_str(obj.get("catchy_phrase"))
        if title is not None and phrase is not None:
            return title, phrase
    return None
