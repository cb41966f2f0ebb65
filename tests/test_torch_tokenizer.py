"""The port's CLIP BPE tokenizer and RAKE (vtc_tpu_torch.data) against the JAX
package's (vtc_tpu.data), on the CPU.

* The pattern, on every code point (no exception list): the port's
  ``re`` pattern and ``ClipTokenizer().pat`` of ``vtc_tpu`` (the ``regex``
  package) give the same ``findall`` on strings that put every code point
  after a letter and before an apostrophe, after an apostrophe, and after
  "'r" and "'l" (the contractions' second letters). Each string is one
  ``findall`` per engine, so the test takes seconds.
* The committed class ranges equal those that ``unicode_ranges`` makes
  from ``regex`` now.
* ``_whitespace_clean`` on U+001C-U+001F (whitespace to the standard
  library, not to ``regex``) and the rest of ``regex``'s whitespace.
* ``encode``, ``tokenize`` and ``tokenize_max_len``: ids equal on a corpus
  of English, accented, Greek, CJK, emoji, digits of other scripts,
  contractions, HTML entities and over-long texts, on the fallback
  vocabulary and on a merges file of 48,894 merges synthesized from a
  seeded corpus, handed to both packages as ``bpe_path``.
* ``Rake``: ranked phrases equal.

Exact equality throughout: no tolerance.
"""

import gzip

import numpy as np
import pytest
import regex

from vtc_tpu.data import rake as jax_rake
from vtc_tpu.data import tokenizer as jax_tok
from vtc_tpu_torch.data import rake, tokenizer, unicode_classes

N_MERGES = 49152 - 256 - 2  # the merge lines CLIP's tokenizer reads


def unicode_ranges(pattern: str, flags: int = 0):
    """The code-point ranges, ``[(lo, hi), ...]``, of the characters that
    ``regex`` matches with ``pattern``: the generator of
    ``vtc_tpu_torch/data/unicode_classes.py``."""
    every = "".join(map(chr, range(0x110000)))
    out = []
    for m in regex.finditer(pattern, every, flags):
        cp = m.start()
        if out and out[-1][1] == cp - 1:
            out[-1][1] = cp
        else:
            out.append([cp, cp])
    return tuple(tuple(r) for r in out)


@pytest.mark.parametrize("name, pattern, flags", [
    ("LETTER", r"[\p{L}]", regex.IGNORECASE),
    ("NUMBER", r"[\p{N}]", regex.IGNORECASE),
    ("OTHER", r"[^\s\p{L}\p{N}]", regex.IGNORECASE),
    ("WHITESPACE", r"\s", 0),
])
def test_committed_ranges_are_regex_classes(name, pattern, flags):
    assert getattr(unicode_classes, name) == unicode_ranges(pattern, flags)


@pytest.fixture(scope="module")
def every_code_point():
    # surrogates cannot be encoded, so no text holds them
    return "".join(chr(c) for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF)


@pytest.mark.parametrize("joiner", ["a", "'", "'r", "'l"])
def test_pattern_matches_regex_on_every_code_point(every_code_point, joiner):
    """``joiner`` before each code point: "a" shows which join a letter run
    ("a" is a letter), "'" which join the run of other characters and which
    start a contraction, "'r"/"'l" which end 're/'ve and 'll (the second
    letters are e, e and l)."""
    text = joiner + joiner.join(every_code_point)
    ours = tokenizer.ClipTokenizer().pat.findall(text)
    ref = jax_tok.ClipTokenizer().pat.findall(text)
    assert len(ours) == len(ref)
    if ours != ref:
        i = next(i for i, (a, b) in enumerate(zip(ours, ref)) if a != b)
        pytest.fail(f"token {i}: {ours[i]!r} vs regex {ref[i]!r} "
                    f"({[hex(ord(c)) for c in ours[i] + ref[i]]})")


def test_literals_fold_as_regex(every_code_point):
    """The contractions' and special tokens' letters under the two engines'
    case folding, each on every code point: the literals are matched one
    letter at a time."""
    import re

    for letter in sorted(set("stremvldaofxn")):
        ours = re.findall(f"(?i:{letter})", every_code_point)
        ref = regex.findall(letter, every_code_point, regex.IGNORECASE)
        assert ours == ref, letter
    special = ["<|startoftext|>", "<|STARTOFTEXT|>", "<|endoftext|>", "<|EndOfText|>"]
    text = " ".join(special)
    assert tokenizer.ClipTokenizer().pat.findall(text) == \
        jax_tok.ClipTokenizer().pat.findall(text)


WHITESPACE_CASES = [
    "a\x1cb", "a\x1db\x1ec\x1fd", " \x1c lead and trail \x1f ", "tab\there",
    "nl\nand\r\ncr", "nbsp\xa0here", "ogham mark", "em space thin",
    "line para sep", "narrow nbsp", "math space", "ideo　space",
    "nel\x85char", "zero​width", "vt\x0bff\x0c", "mixed \x1c　 \t runs",
]


@pytest.mark.parametrize("text", WHITESPACE_CASES)
def test_whitespace_clean_matches_regex(text):
    assert tokenizer._whitespace_clean(text) == jax_tok._whitespace_clean(text)


CORPUS = [
    "", "a", "Hello, World!", "This is a thumbnail of my cat sleeping on the couch",
    "naïve café résumé — jalapeño piñata", "Ελληνικά: η γρήγορη καφέ αλεπού",
    "日本語のテキストと中文字符", "한국어 문장입니다", "emoji 🐱🐶🎉 and ZWJ 👨‍👩‍👧",
    "digits ١٢٣ ४५६ ๗๘๙ 123", "I'm sure it's what we've said they'll do, you'd see",
    "DON'T SHOUT, IT'S RUDE", "&amp; &lt;b&gt;bold&lt;/b&gt; &#39;quoted&#39; &amp;amp;",
    "tabs\tand\nnewlines\r\nand\x1cseparators", "ypogegrammeni ᾳ ͅ ᾳβ",
    "ſtrange long s and Kelvin K", "<|startoftext|>special<|endoftext|>",
    "word " * 40, "supercalifragilisticexpialidocious " * 10,
    "mixed123numbers456and789letters", "..., !!! ??? --- ***",
]


def _merges_file(path, n=N_MERGES, seed=0):
    """A merges file of ``n`` merge lines after a header, built from a seeded
    corpus: for each word of the corpus (byte-encoded as CLIP's BPE sees it)
    the merges that build it from the left, then pairs of the byte symbols,
    in a seeded order."""
    rng = np.random.default_rng(seed)
    byte_enc = jax_tok.bytes_to_unicode()
    letters = list("abcdefghijklmnopqrstuvwxyzéαβγ日本")
    words = {w for text in CORPUS for w in text.lower().split()}
    words |= {"".join(rng.choice(letters, int(rng.integers(2, 9)))) for _ in range(6000)}
    merges, seen = [], set()
    for word in sorted(words):
        symbols = [byte_enc[b] for b in word.encode("utf-8")]
        symbols[-1] += "</w>"
        left = symbols[0]
        for sym in symbols[1:]:
            if (left, sym) not in seen:
                seen.add((left, sym))
                merges.append((left, sym))
            left += sym
    base = list(byte_enc.values())
    while len(merges) < n:
        pair = (base[int(rng.integers(len(base)))],
                base[int(rng.integers(len(base)))] + ("</w>" if rng.random() < 0.3 else ""))
        if pair not in seen:
            seen.add(pair)
            merges.append(pair)
    merges = merges[:n]
    order = rng.permutation(len(merges))
    lines = ["#version: 0.2"] + [" ".join(merges[i]) for i in order] + ["a b", "c d"]
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(lines))
    return path


@pytest.fixture(scope="module", params=["fallback", "merges"])
def tokenizers(request, tmp_path_factory):
    """(port, JAX) tokenizers on one vocabulary, installed as both packages'
    default tokenizer for ``tokenize``/``tokenize_max_len``."""
    path = None
    if request.param == "merges":
        path = str(_merges_file(tmp_path_factory.mktemp("bpe") / "bpe.txt.gz"))
    ours, ref = tokenizer.ClipTokenizer(path), jax_tok.ClipTokenizer(path)
    assert ours.is_exact == ref.is_exact == (path is not None)
    saved = tokenizer._DEFAULT_TOKENIZER, jax_tok._DEFAULT_TOKENIZER
    tokenizer._DEFAULT_TOKENIZER, jax_tok._DEFAULT_TOKENIZER = ours, ref
    yield ours, ref
    tokenizer._DEFAULT_TOKENIZER, jax_tok._DEFAULT_TOKENIZER = saved


def test_vocabularies_match(tokenizers):
    ours, ref = tokenizers
    assert ours.encoder == ref.encoder and ours.bpe_ranks == ref.bpe_ranks
    assert (ours.sot_token, ours.eot_token) == (49406, 49407)


@pytest.mark.parametrize("text", CORPUS)
def test_encode_matches_jax(tokenizers, text):
    ours, ref = tokenizers
    ids = ours.encode(text)
    assert ids == ref.encode(text)
    assert ours.encode(text) == ids  # the memo gives the same ids
    assert ours.decode(ids) == ref.decode(ids)


def test_merges_file_merges(tokenizers):
    """On the synthesized merges, a corpus word becomes fewer tokens than
    bytes (the BPE path, not only the byte fallback, is held); on the
    fallback vocabulary, one token per byte."""
    ours, _ = tokenizers
    text = "supercalifragilisticexpialidocious"
    n = len(ours.encode(text))
    assert n < len(text.encode()) if ours.is_exact else n == len(text.encode())


def test_tokenize_matches_jax(tokenizers):
    short = [t for t in CORPUS if len(tokenizers[1].encode(t)) <= 75]
    np.testing.assert_array_equal(tokenizer.tokenize(short), jax_tok.tokenize(short))
    np.testing.assert_array_equal(tokenizer.tokenize(CORPUS, truncate=True),
                                  jax_tok.tokenize(CORPUS, truncate=True))
    with pytest.raises(RuntimeError, match="too long"):
        tokenizer.tokenize(CORPUS)
    for max_len in (77, 16):
        np.testing.assert_array_equal(tokenizer.tokenize_max_len(CORPUS, max_len),
                                      jax_tok.tokenize_max_len(CORPUS, max_len))


RAKE_TEXTS = [
    "Compatibility of systems of linear constraints over the set of natural numbers. "
    "Criteria of compatibility of a system of linear Diophantine equations are considered.",
    "the cat sat on the mat and then the dog ran over the hill while the bird sang",
    "I can't believe it's 2024 - what a year; honestly (really) the best one yet!",
    "", "and the of", "Deep-learning/ML models: fast+cheap, but 'fragile' \"often\"",
]


@pytest.mark.parametrize("text", RAKE_TEXTS)
@pytest.mark.parametrize("max_words", [100, 2])
def test_rake_matches_jax(text, max_words):
    ours, ref = rake.Rake(max_words), jax_rake.Rake(max_words)
    ours.extract_keywords_from_text(text)
    ref.extract_keywords_from_text(text)
    assert ours.get_ranked_phrases() == ref.get_ranked_phrases()
