"""The port's BPE tokenizer (``imageclust_tpu_torch/models/tokenizer.py``,
a word splitter over ``unicodedata``) against the JAX package's (CLIP's
pattern in the ``regex`` package) on the same synthetic merge tables.

Ids must be exactly equal. The splitter is held to ``regex.findall`` of the
JAX tokenizer's own compiled pattern on every code point Python's
``unicodedata`` assigns; the code points it leaves unassigned (Cn) but a
newer ``regex`` assigns as letters or numbers are the one recorded gap.
"""

import gzip
import unicodedata

import numpy as np
import pytest
import regex
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from imageclust_tpu.models import tokenizer as jax_tok
from imageclust_tpu_torch.models import tokenizer as tok

torch.set_num_threads(1)

# tests/test_tokenizer.py's table, and merges over non-ASCII bytes
MERGES = [
    ("h", "e"), ("l", "l"), ("he", "ll"), ("o", "</w>"), ("hell", "o</w>"),
    ("w", "o"), ("r", "l"), ("d", "</w>"),
]
_BYTES = tok.bytes_to_unicode()


def _mapped(word: str) -> str:
    return "".join(_BYTES[b] for b in word.encode("utf-8"))


def _learned_merges(seed: int, n: int = 160) -> list[tuple[str, str]]:
    """A BPE table learned on a seeded corpus of ASCII and non-ASCII words
    (most-frequent adjacent pair first, the end-of-word marker on the
    last symbol), so merges chain over several levels."""
    rng = np.random.default_rng(seed)
    alphabet = list("abcdeilnorst") + ["\u00e9", "\u00df", "\u0436",
                                       "\u4e2d", "\u017f", "\u00b2"]
    words = ["".join(rng.choice(alphabet, rng.integers(1, 8)))
             for _ in range(400)]
    corpus = []
    for w in words:
        m = _mapped(w)
        corpus.append(list(m[:-1]) + [m[-1] + "</w>"])
    merges = []
    for _ in range(n):
        counts: dict = {}
        for w in corpus:
            for pair in zip(w, w[1:]):
                counts[pair] = counts.get(pair, 0) + 1
        if not counts:
            break
        best = max(sorted(counts), key=counts.__getitem__)
        merges.append(best)
        for i, w in enumerate(corpus):
            out, j = [], 0
            while j < len(w):
                if j < len(w) - 1 and (w[j], w[j + 1]) == best:
                    out.append(w[j] + w[j + 1])
                    j += 2
                else:
                    out.append(w[j])
                    j += 1
            corpus[i] = out
    return merges


def _write(path, merges, header="#version: test\n", gz=False):
    text = header + "\n".join(f"{a} {b}" for a, b in merges) + "\n"
    if gz:
        with gzip.open(path, "wt", encoding="utf-8") as fh:
            fh.write(text)
    else:
        path.write_text(text, encoding="utf-8")
    return str(path)


@pytest.fixture(scope="module", params=["small", "learned"])
def pair(request, tmp_path_factory):
    """(JAX tokenizer, port tokenizer) over one merge table."""
    merges = MERGES if request.param == "small" else _learned_merges(0)
    path = _write(tmp_path_factory.mktemp("bpe") / "merges.txt", merges)
    return jax_tok.BPETokenizer(path, context=16), tok.BPETokenizer(
        path, context=16)


@pytest.fixture(scope="module")
def jax_pattern(tmp_path_factory):
    """CLIP's word pattern as the JAX tokenizer compiles it."""
    path = _write(tmp_path_factory.mktemp("bpe") / "merges.txt", MERGES)
    return jax_tok.BPETokenizer(path)._pat


# every code point Python's unicodedata assigns (surrogates cannot be
# encoded to UTF-8 by either tokenizer)
_ASSIGNED = [chr(c) for c in range(0x110000)
             if unicodedata.category(chr(c)) not in ("Cn", "Cs")]
_CHUNKS = 16
_EDGE = ["\u00b2", "\u00bd", "\u2160", "\u2170", "\u0345", "\u001c",
         "\u001d", "\u001e", "\u001f", "\u0085", "\u00a0", "\u2028",
         "\u2029", "\u3000", "\u200b", "\u0130", "\u017f", "\u212a",
         "DON'T", "I'LL", "WE'VE", "YOU'RE", "I'M", "SHE'D", "IT'S",
         "'\u017f", "<|endoftext|>", "<|startoftext|>", "<|ENDOFTEXT|>",
         "<|\u017ftartoftext|>", "<|endoftext", "&amp;", "&lt;b&gt;",
         "e\u0301", "1/2", "x\u0345y", "!\u0345!", "''s", "!'s"]
_TEXTS = ["hello world", "Hello, WORLD!", "hello hello", "a b c", "xyz",
          "caf\u00e9 \u2665", "  spaced\tout\nlines  ", "don't stop",
          "\u00b2\u00bd\u216b",
          "<|endoftext|>", "na\u00efve fa\u00e7ade",
          "\u017ftra\u00dfe \u0416\u0418\u0412 \u4e2d\u6587",
          "it's 2024's best", "ab\u0345cd", "x\u001cy\u001fz"]


class TestSplitter:
    @pytest.mark.parametrize("chunk", range(_CHUNKS))
    @pytest.mark.parametrize("sep", [" ", "", "a", "1", "!", "'"])
    def test_matches_regex_on_every_code_point(self, jax_pattern, chunk,
                                               sep):
        part = _ASSIGNED[chunk::_CHUNKS]
        text = sep.join(part)
        assert tok.split_words(text) == jax_pattern.findall(text)

    @pytest.mark.parametrize("chunk", range(4))
    def test_collapse_matches_regex(self, chunk):
        text = "".join(_ASSIGNED[chunk::4])
        assert tok.collapse_whitespace(text) == regex.sub(r"\s+", " ", text)

    def test_whitespace_is_unicode_white_space(self):
        """regex's \\s is White_Space: not U+001C-U+001F, which Python's
        re and str.isspace() take."""
        ws = [c for c in _ASSIGNED if tok._kind(c) == " "]
        assert ws == regex.findall(r"\s", "".join(_ASSIGNED))
        assert all(c.isspace() for c in "\x1c\x1d\x1e\x1f")
        assert not any(tok._kind(c) == " " for c in "\x1c\x1d\x1e\x1f")

    def test_ignorecase_rules(self):
        # U+0345 folds to iota: neither the letter class nor the negated
        # class takes it, so it is skipped and splits the run around it
        assert tok.split_words("ab\u0345cd") == ["ab", "cd"]
        assert tok.split_words("!\u0345!") == ["!", "!"]
        # the long s (U+017F) is a case variant of s in the literals
        assert tok.split_words("'\u017f") == ["'\u017f"]
        assert tok.split_words("<|\u017ftartoftext|>") == [
            "<|\u017ftartoftext|>"]
        # numbers stand alone, other characters run
        assert tok.split_words("\u00b2\u00bd\u217b!?") == [
            "\u00b2", "\u00bd", "\u217b", "!?"]

    def test_unassigned_gap_is_recorded(self):
        """The code points Python's tables (unicodedata) leave unassigned
        but regex's newer tables assign as letters or numbers: the splitter
        takes them as other characters. This is the one deliberate
        difference (ROADMAP.md queue 3)."""
        letter = regex.compile(r"[\p{L}\p{N}]")
        gap = [chr(c) for c in range(0x110000)
               if not 0xD800 <= c <= 0xDFFF
               and unicodedata.category(chr(c)) == "Cn"
               and letter.match(chr(c))]
        print(f"Cn code points split differently: {len(gap)} "
              f"(unicodedata {unicodedata.unidata_version}, "
              f"regex {regex.__version__})")
        assert 0 < len(gap) < 12000
        assert all(tok._kind(c) == "P" for c in gap)
        # beside punctuation: one run for the port, a run of "!" and a
        # letter or number for regex
        text = "!".join(gap)
        assert tok.split_words(text) == [text]
        assert tok.split_words(text) != regex.findall(
            r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+", text, regex.I)


class TestIds:
    @pytest.mark.parametrize("text", _TEXTS + _EDGE)
    def test_encode_text_equal(self, pair, text):
        j, p = pair
        assert p.encode_text(text) == j.encode_text(text)

    @pytest.mark.parametrize("chunk", range(_CHUNKS))
    def test_ids_equal_on_every_code_point(self, pair, chunk):
        part = _ASSIGNED[chunk::_CHUNKS]
        text = " ".join("".join(part[i:i + 3])
                        for i in range(0, len(part), 3))
        j, p = pair
        assert p.encode_text(text) == j.encode_text(text)

    @settings(max_examples=200, deadline=None)
    @given(st.lists(st.one_of(st.sampled_from(_ASSIGNED),
                              st.sampled_from(_EDGE)), max_size=24))
    def test_ids_equal_on_drawn_text(self, tmp_path_factory, pieces):
        j, p = _learned_pair(tmp_path_factory)
        text = "".join(pieces)
        assert p.encode_text(text) == j.encode_text(text)
        np.testing.assert_array_equal(p(text), j(text))

    @pytest.mark.parametrize("text", ["hello", "", " ".join(["xyz"] * 50),
                                      "hello " * 20, "<|endoftext|>"])
    def test_call_pads_and_truncates(self, pair, text):
        j, p = pair
        got = p(text)
        np.testing.assert_array_equal(got, j(text))
        assert got.shape == (16,) and got.dtype == np.int32
        assert got[0] == p.sot_id
        ids = [int(i) for i in got if i != 0]
        assert ids[-1] == p.eot_id and len(ids) <= 16

    @pytest.mark.parametrize("text", _TEXTS)
    def test_decode_equal(self, pair, text):
        j, p = pair
        ids = j.encode_text(text)
        assert p.decode(ids) == j.decode(ids)
        assert p.decode(p(text)) == j.decode(j(text))


_LEARNED: dict = {}


def _learned_pair(factory):
    if "pair" not in _LEARNED:
        path = _write(factory.mktemp("bpe") / "learned.txt",
                      _learned_merges(1))
        _LEARNED["pair"] = (jax_tok.BPETokenizer(path, context=16),
                            tok.BPETokenizer(path, context=16))
    return _LEARNED["pair"]


class TestMergesFile:
    def test_vocab_layout_equal(self, pair):
        j, p = pair
        assert p.vocab_size == j.vocab_size
        assert p.encoder == j.encoder and p.bpe_ranks == j.bpe_ranks
        assert (p.sot_id, p.eot_id) == (j.sot_id, j.eot_id)
        assert p.eot_id == p.vocab_size - 1  # argmax pooling contract

    @pytest.mark.parametrize("header", ["#version: test\n", "", "# #\n"])
    def test_version_rule(self, tmp_path, header):
        """Only a leading "#version" line is skipped; a merge whose left
        symbol is '#' keeps its rank."""
        path = _write(tmp_path / "m.txt", [("h", "e"), ("#", "#")],
                      header=header)
        j = jax_tok.BPETokenizer(path)
        p = tok.BPETokenizer(path)
        assert p.bpe_ranks == j.bpe_ranks and p.vocab_size == j.vocab_size
        assert p.encode_text("he ## #") == j.encode_text("he ## #")

    def test_gzip_and_cap(self, tmp_path):
        merges = [(f"a{i}", f"b{i}") for i in range(48_900)]
        path = _write(tmp_path / "m.txt.gz", merges, gz=True)
        j = jax_tok.BPETokenizer(path)
        p = tok.BPETokenizer(path)
        assert p.vocab_size == j.vocab_size == 512 + 48_894 + 2
        assert p.bpe_ranks == j.bpe_ranks

    def test_bytes_to_unicode_equal(self):
        assert tok.bytes_to_unicode() == jax_tok.bytes_to_unicode()

    def test_default_path_is_the_repo_root(self, monkeypatch):
        monkeypatch.delenv("IMAGECLUST_BPE_PATH", raising=False)
        assert tok.default_bpe_path() == jax_tok.default_bpe_path()
        monkeypatch.setenv("IMAGECLUST_BPE_PATH", "/x/merges.txt")
        assert tok.default_bpe_path() == "/x/merges.txt"
