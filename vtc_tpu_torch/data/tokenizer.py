"""Token fixtures and EOT-bucket truncation, until the BPE tokenizer is
ported.

The port's own copy of ``vtc_tpu/data/tokenizer.py:273-349`` (the
truncation helpers and ``synthetic_tokens``) and of CLIP's start/end-of-text
ids.
"""

from __future__ import annotations

import numpy as np

SOT_ID = 49406
EOT_ID = 49407  # the highest id: the text tower pools at argmax(tokens)
CONTEXT_LENGTH = 77
BUCKETS = (16, 32, 48, 64, 77)


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
