"""CLIP byte-level BPE tokenizer, with a word splitter that needs only the
standard library.

The port of ``imageclust_tpu/models/tokenizer.py``. The byte map, the
merges-file reader (the ``#version`` header rule, the 48,894-merge cap),
the greedy merge loop, ``decode`` and ``__call__`` are the JAX package's.
What differs is the word splitter: CLIP's tokenizer splits words with the
third-party ``regex`` package (the pattern below, under ``IGNORECASE``),
which the GPU machines lack, and Python's ``re`` is no stand-in for it
(its ``\\d``/``\\w`` classes and its ``\\s`` set differ from ``regex``'s
``\\p{N}``/``\\p{L}`` and ``\\s``). :func:`split_words` reproduces ::

    <\\|startoftext\\|>|<\\|endoftext\\|>|'s|'t|'re|'ve|'m|'ll|'d
    |[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+

over :mod:`unicodedata` categories, with ``regex``'s semantics:

* letters are categories ``L*``, numbers ``N*``; white space is Unicode's
  ``White_Space`` property (categories ``Zs``, ``Zl``, ``Zp`` and the
  controls ``\\t \\n \\v \\f \\r \\x85``; not U+001C-U+001F, which ``re``'s
  ``\\s`` and ``str.isspace`` take);
* under ``IGNORECASE`` a character whose case variant is a letter but
  which is no letter itself (U+0345 COMBINING GREEK YPOGEGRAMMENI, which
  folds to iota) matches neither the letter class nor the negated class:
  no alternative takes it, so it is skipped like white space and ends the
  run it stands in;
* the literals match case-insensitively, so ``'ſ`` (U+017F, long s) is a
  contraction and ``<|ſtartoftext|>`` a special-token match (encoded as
  an ordinary word, as CLIP's tokenizer does).

Code points that Python's Unicode tables (15.0.0 in Python 3.12) leave
unassigned but a newer ``regex`` assigns as letters or numbers split
differently; no standard-library table can know them.

The merge table (CLIP ships ``bpe_simple_vocab_16e6.txt.gz``) is not in
the repository; ``IMAGECLUST_BPE_PATH`` or ``BPETokenizer(path)`` point at
it.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import unicodedata

import numpy as np

__all__ = ["BPETokenizer", "bytes_to_unicode", "default_bpe_path",
           "split_words", "collapse_whitespace"]


@functools.lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode map: the 188 visibly
    printable latin-1 bytes map to themselves; the rest shift into the
    256..355 range so every byte string becomes a clean unicode string."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def default_bpe_path() -> str:
    """IMAGECLUST_BPE_PATH, or the conventional filename beside the repo."""
    p = os.environ.get("IMAGECLUST_BPE_PATH", "")
    if p:
        return p
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        "bpe_simple_vocab_16e6.txt.gz")


def _basic_clean(text: str) -> str:
    # the reference implementation runs ftfy (mojibake repair) first; not in
    # this environment — html-unescape (twice, matching it) + strip
    return html.unescape(html.unescape(text)).strip()


# -- the word splitter -------------------------------------------------------

_WS_CONTROLS = frozenset("\t\n\v\f\r\x85")
_LETTER, _NUMBER, _SPACE, _OTHER, _NONE = "L", "N", " ", "P", ""
_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


@functools.lru_cache(maxsize=1 << 16)
def _kind(ch: str) -> str:
    """Which of the pattern's classes ``ch`` falls in under IGNORECASE."""
    cat = unicodedata.category(ch)
    if cat[0] == "L":
        return _LETTER
    if cat[0] == "N":
        return _NUMBER
    if cat in ("Zs", "Zl", "Zp") or ch in _WS_CONTROLS:
        return _SPACE
    for v in (ch.lower(), ch.upper(), ch.casefold()):
        if len(v) == 1 and unicodedata.category(v)[0] == "L":
            return _NONE  # a case variant is a letter: no class takes it
    return _OTHER


@functools.lru_cache(maxsize=1 << 16)
def _fold(ch: str) -> str:
    """Simple case-insensitive key: the lowercase of the uppercase where
    both are one character (``ſ`` -> ``s``), else the lowercase."""
    up = ch.upper()
    low = (up if len(up) == 1 else ch).lower()
    return low if len(low) == 1 else ch


def _literal_at(text: str, i: int, lit: str) -> bool:
    if i + len(lit) > len(text):
        return False
    return all(_fold(text[i + j]) == c for j, c in enumerate(lit))


def split_words(text: str) -> list[str]:
    """``regex.findall`` of CLIP's word pattern under IGNORECASE: at each
    position the first alternative that matches wins (specials, then
    contractions, then a letter run, one number, a run of other
    characters); a character no alternative takes is skipped."""
    out: list[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch == "<":
            lit = next((s for s in _SPECIALS if _literal_at(text, i, s)),
                       None)
            if lit is not None:
                out.append(text[i:i + len(lit)])
                i += len(lit)
                continue
        elif ch == "'":
            lit = next((s for s in _CONTRACTIONS if _literal_at(text, i, s)),
                       None)
            if lit is not None:
                out.append(text[i:i + len(lit)])
                i += len(lit)
                continue
        kind = _kind(ch)
        if kind in (_SPACE, _NONE):
            i += 1
            continue
        j = i + 1
        if kind != _NUMBER:  # letters and others run; a number stands alone
            while j < n and _kind(text[j]) == kind:
                j += 1
        out.append(text[i:j])
        i = j
    return out


def collapse_whitespace(text: str) -> str:
    """``regex.sub(r"\\s+", " ", text)``: each run of White_Space
    characters becomes one space."""
    out: list[str] = []
    prev_space = False
    for ch in text:
        space = _kind(ch) == _SPACE
        if not (space and prev_space):
            out.append(" " if space else ch)
        prev_space = space
    return "".join(out)


class BPETokenizer:
    """CLIP's tokenizer over a merges file (.txt or .txt.gz).

    File format: one merge per line ("tok_a tok_b"), rank = line order;
    CLIP's shipped file has a version header line and is truncated to
    48,894 rules + 512 byte symbols + 2 specials = 49,408 ids. Any merge
    table in the same format works (tests use small synthetic ones).
    """

    SOT = "<|startoftext|>"
    EOT = "<|endoftext|>"

    def __init__(self, bpe_path: str | None = None, context: int = 77):
        path = bpe_path or default_bpe_path()
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as fh:
            lines = fh.read().split("\n")
        # CLIP's file leads with a "#version: ..." header — skip ONLY that
        # line (a merge whose left symbol begins with a literal '#', e.g.
        # keycap-emoji byte sequences, is legitimate and must keep its
        # rank). Every other "a b" line is a merge, rank = order.
        if lines and lines[0].startswith("#version"):
            lines = lines[1:]
        merges = [tuple(ln.split()) for ln in lines if len(ln.split()) == 2]
        if len(merges) > 48894:
            merges = merges[:48894]

        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += [self.SOT, self.EOT]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.context = context
        self.vocab_size = len(vocab)
        self.sot_id = self.encoder[self.SOT]
        self.eot_id = self.encoder[self.EOT]
        self._cache: dict[str, str] = {}

    # -- core BPE ----------------------------------------------------------

    def _bpe(self, token: str) -> str:
        """Greedy merge loop: repeatedly join the lowest-rank adjacent pair.
        The last symbol carries the ``</w>`` end-of-word marker."""
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if best not in self.bpe_ranks:
                break
            a, b = best
            out: list[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
        result = " ".join(word)
        self._cache[token] = result
        return result

    def encode_text(self, text: str) -> list[int]:
        """Text -> BPE ids (no specials, no padding)."""
        text = collapse_whitespace(_basic_clean(text)).lower()
        ids: list[int] = []
        for tok in split_words(text):
            if tok in (self.SOT, self.EOT):
                ids.append(self.encoder[tok])
                continue
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(mapped).split(" "))
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids
                       if int(i) not in (self.sot_id, self.eot_id))
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace(
            "</w>", " ").strip()

    def __call__(self, text: str) -> np.ndarray:
        """(context,) int32: <start> ids... <end>, zero-padded; truncates
        to fit the context window with the <end> token preserved."""
        ids = [self.sot_id] + self.encode_text(text)[: self.context - 2]
        ids.append(self.eot_id)
        out = np.zeros(self.context, np.int32)
        out[: len(ids)] = ids
        return out
