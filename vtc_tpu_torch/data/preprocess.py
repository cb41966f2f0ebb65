"""Host-side image preprocessing the port needs: the CLIP constants and the
patch extraction of the uint8 patch input.

The port's own copy of ``vtc_tpu/data/preprocess.py:21-22,75-95``
(importing that package would pull in JAX through ``vtc_tpu.data``).
"""

from __future__ import annotations

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def extract_patches(images: np.ndarray, patch: int) -> np.ndarray:
    """[..., H, W, 3] -> [..., (H//p)·(W//p), p·p·3] pixel patches in
    (ph, pw, c) order, the operand of the ViT's patch-embed matmul
    (``models/clip_model.py:hwc_col_perm`` permutes the weight to match).
    Works on uint8, the preferred input, or float."""
    *lead, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(*lead, gh, patch, gw, patch, c)
    x = np.moveaxis(x, -3, -4)  # [..., gh, gw, p, p, c]
    return np.ascontiguousarray(x.reshape(*lead, gh * gw, patch * patch * c))
