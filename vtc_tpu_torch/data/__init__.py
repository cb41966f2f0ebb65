"""Host-side data helpers of the port: the loader and its copy to the card,
image preprocessing and token fixtures."""

from .loader import DataLoader, default_collate, prefetch_to_device
from .preprocess import CLIP_MEAN, CLIP_STD, extract_patches, normalize_uint8_images
from .tokenizer import EOT_ID, SOT_ID, synthetic_tokens

__all__ = [
    "CLIP_MEAN", "CLIP_STD", "DataLoader", "EOT_ID", "SOT_ID", "default_collate",
    "extract_patches", "normalize_uint8_images", "prefetch_to_device",
    "synthetic_tokens",
]
