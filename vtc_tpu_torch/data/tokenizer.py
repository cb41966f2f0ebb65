"""Token fixtures the port needs until the BPE tokenizer is ported.

The port's own copy of ``vtc_tpu/data/tokenizer.py:338-349`` and of CLIP's
start/end-of-text ids.
"""

from __future__ import annotations

import numpy as np

SOT_ID = 49406
EOT_ID = 49407  # the highest id: the text tower pools at argmax(tokens)


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
