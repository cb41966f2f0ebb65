"""Host-side data helpers of the port (no loader yet: ROADMAP)."""

from .preprocess import CLIP_MEAN, CLIP_STD, extract_patches
from .tokenizer import EOT_ID, SOT_ID, synthetic_tokens

__all__ = [
    "CLIP_MEAN", "CLIP_STD", "EOT_ID", "SOT_ID", "extract_patches",
    "synthetic_tokens",
]
