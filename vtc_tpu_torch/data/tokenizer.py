"""CLIP's byte-level BPE tokenizer, and the token helpers of the train step.

The port's own copy of ``vtc_tpu/data/tokenizer.py``: ``bytes_to_unicode``,
``get_pairs``, ``ClipTokenizer`` with its per-text memo, ``get_tokenizer``,
``tokenize`` and ``tokenize_max_len`` (``:41-270``), the EOT-bucket
truncation helpers and ``synthetic_tokens`` (``:273-349``).

Two vocabularies, as in the JAX package: CLIP's merges file
``bpe_simple_vocab_16e6.txt.gz`` where it is found (``VTC_BPE_VOCAB`` first,
then this package's ``data/`` directory), which gives CLIP's ids; else a
deterministic fallback of the same size, 49408, with <|startoftext|> 49406
and <|endoftext|> 49407.

The pattern runs on the standard library's ``re``: CLIP's classes, written
for the ``regex`` package (``\\p{L}``, ``\\p{N}``, its ``\\s``), are spelled
out as the code points that ``regex`` matches with them, case folding
included (``unicode_classes``).
"""

from __future__ import annotations

import gzip
import html
import os
import re
from functools import lru_cache
from pathlib import Path
from typing import List, Sequence, Union

import numpy as np

from .unicode_classes import LETTER, NUMBER, OTHER, WHITESPACE, char_class

SOT_ID = 49406
EOT_ID = 49407  # the highest id: the text tower pools at argmax(tokens)
CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408
SOT_TEXT = "<|startoftext|>"
EOT_TEXT = "<|endoftext|>"
BUCKETS = (16, 32, 48, 64, 77)
VOCAB_NAME = "bpe_simple_vocab_16e6.txt.gz"

# the case-insensitive part of CLIP's pattern is its literals; each class is
# already closed under ``regex``'s case folding (``unicode_classes``)
PATTERN = (
    r"""(?i:<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d)|"""
    f"{char_class(LETTER)}+|{char_class(NUMBER)}|{char_class(OTHER)}+"
)
_WHITESPACE_RUN = re.compile(f"{char_class(WHITESPACE)}+")


@lru_cache()
def bytes_to_unicode():
    """Reversible byte -> unicode-char mapping (avoids whitespace/control
    chars so BPE operates over printable symbols)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _basic_clean(text: str) -> str:
    # CLIP applies ftfy.fix_text; it is used where it is installed, as in the
    # JAX package, and the html unescaping is applied twice, as CLIP does
    try:
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return _WHITESPACE_RUN.sub(" ", text).strip()


def _find_vocab_file():
    for p in (os.environ.get("VTC_BPE_VOCAB", ""), str(Path(__file__).parent / VOCAB_NAME)):
        if p and os.path.exists(p):
            return p
    return None


class ClipTokenizer:
    """Byte-level BPE with CLIP's merge table when available.

    ``encoder`` maps token text -> id; ``self.encoder[EOT_TEXT] == 49407``
    always holds (both exact and fallback vocabularies).
    """

    def __init__(self, bpe_path: str | None = None):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        # per-text memo (see encode); ~260k entries, tens of MB, bounded
        self._encode_cache: dict = {}
        self._encode_cache_max = 1 << 18

        bpe_path = bpe_path or _find_vocab_file()
        base = list(bytes_to_unicode().values())
        vocab = base + [v + "</w>" for v in base]

        if bpe_path is not None:
            with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
                merge_lines = f.read().split("\n")
            # CLIP uses merge lines [1 : 49152-256-2+1]
            merge_lines = merge_lines[1 : 49152 - 256 - 2 + 1]
            merges = [tuple(m.split()) for m in merge_lines]
            vocab.extend("".join(m) for m in merges)
            self.is_exact = True
        else:
            merges = []
            # deterministic filler: CLIP's vocabulary size, and the special
            # tokens keep their ids
            vocab.extend(f"<|unused{i}|>" for i in range(VOCAB_SIZE - 2 - len(vocab)))
            self.is_exact = False

        vocab.extend([SOT_TEXT, EOT_TEXT])
        assert len(vocab) == VOCAB_SIZE, len(vocab)

        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {SOT_TEXT: SOT_TEXT, EOT_TEXT: EOT_TEXT}
        self.pat = re.compile(PATTERN)

    @property
    def sot_token(self) -> int:
        return self.encoder[SOT_TEXT]

    @property
    def eot_token(self) -> int:
        return self.encoder[EOT_TEXT]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"

        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        """Token ids of ``text``, memoized per text: the loader tokenizes the
        same titles and comments every epoch."""
        cached = self._encode_cache.get(text)
        if cached is not None:
            return list(cached)
        bpe_tokens: List[int] = []
        cleaned = _whitespace_clean(_basic_clean(text)).lower()
        for token in self.pat.findall(cleaned):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        if len(self._encode_cache) < self._encode_cache_max:
            self._encode_cache[text] = tuple(bpe_tokens)
        return bpe_tokens

    def decode(self, tokens: Sequence[int]) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return (
            bytearray(self.byte_decoder[c] for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )


_DEFAULT_TOKENIZER = None


def get_tokenizer() -> ClipTokenizer:
    global _DEFAULT_TOKENIZER
    if _DEFAULT_TOKENIZER is None:
        _DEFAULT_TOKENIZER = ClipTokenizer()
    return _DEFAULT_TOKENIZER


def tokenize(
    texts: Union[str, Sequence[str]],
    context_length: int = CONTEXT_LENGTH,
    truncate: bool = False,
) -> np.ndarray:
    """``clip.tokenize``: [n, 77] int32 with SOT/EOT framing. Raises on an
    over-long text unless ``truncate``."""
    if isinstance(texts, str):
        texts = [texts]
    tok = get_tokenizer()
    sot, eot = tok.sot_token, tok.eot_token
    all_tokens = [[sot] + tok.encode(t) + [eot] for t in texts]
    result = np.zeros((len(all_tokens), context_length), dtype=np.int32)
    for i, tokens in enumerate(all_tokens):
        if len(tokens) > context_length:
            if truncate:
                tokens = tokens[: context_length - 1] + [eot]
            else:
                raise RuntimeError(
                    f"Input {texts[i]!r} is too long for context length "
                    f"{context_length}"
                )
        result[i, : len(tokens)] = tokens
    return result


def tokenize_max_len(
    texts: Union[str, Sequence[str]], max_len: int = CONTEXT_LENGTH
) -> np.ndarray:
    """Truncating tokenizer: a text of ``max_len`` tokens or more keeps its
    first ``max_len - 1`` and ends in EOT."""
    if isinstance(texts, str):
        texts = [texts]
    tok = get_tokenizer()
    sot, eot = tok.sot_token, tok.eot_token
    all_tokens = [[sot] + tok.encode(t) + [eot] for t in texts]
    result = np.zeros((len(all_tokens), max_len), dtype=np.int32)
    for i, tokens in enumerate(all_tokens):
        if len(tokens) >= max_len:
            result[i, :max_len] = np.array(tokens[: max_len - 1] + [eot])
        else:
            result[i, : len(tokens)] = np.array(tokens)
    return result


def _token_array_indices(arrays):
    """The members that look like CLIP token tensors: integer, trailing dim
    77."""
    return [
        i for i, a in enumerate(arrays)
        if hasattr(a, "dtype") and np.issubdtype(np.asarray(a).dtype, np.integer)
        and a.ndim >= 1 and a.shape[-1] == CONTEXT_LENGTH
    ]


def batch_token_need(arrays):
    """Tokens needed to cover every EOT position across all CLIP token
    tensors in ``arrays`` (1 + the largest EOT index, EOT being the highest
    id), or ``None`` when the batch carries no token arrays."""
    token_idx = _token_array_indices(arrays)
    if not token_idx:
        return None
    return 1 + max(
        int(np.asarray(arrays[i]).argmax(axis=-1).max()) for i in token_idx
    )


def truncate_batch_tokens(arrays, buckets=BUCKETS, need=None):
    """Truncate every token array of a batch to one common bucket, the
    smallest that covers every EOT position across all of them; other
    members pass through. Exact for the causally masked, EOT-pooled text
    tower. ``need`` overrides the locally computed coverage."""
    token_idx = _token_array_indices(arrays)
    if not token_idx:
        return list(arrays)
    if need is None:
        need = batch_token_need(arrays)
    bucket = next((b for b in buckets if need <= b), CONTEXT_LENGTH)
    out = list(arrays)
    for i in token_idx:
        out[i] = arrays[i][..., :bucket]
    return out


def truncate_to_eot_bucket(tokens: np.ndarray, buckets=BUCKETS):
    """Truncate a ``[..., 77]`` token batch to the smallest bucket covering
    every EOT position."""
    if tokens.ndim == 1:
        tokens = tokens[None]
    need = int(tokens.argmax(axis=-1).max()) + 1
    for b in buckets:
        if need <= b:
            return tokens[..., :b]
    return tokens


def synthetic_tokens(lead, ntoks: int = 16, n_real: int = 14, rng=None):
    """[SOT, n_real random ids, EOT, zero pad] int32 of shape lead+(ntoks,),
    the benchmark token fixture of ``bench.py``."""
    rng = rng if rng is not None else np.random.default_rng(0)
    lead = tuple(lead)
    toks = np.zeros(lead + (ntoks,), np.int32)
    toks[..., 0] = SOT_ID
    toks[..., 1 : 1 + n_real] = rng.integers(1, 49405, lead + (n_real,))
    toks[..., 1 + n_real] = EOT_ID
    return toks
