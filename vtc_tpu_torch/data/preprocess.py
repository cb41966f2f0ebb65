"""Image preprocessing the port needs: the CLIP constants, the patch
extraction of the uint8 patch input, and the train step's normalization of
uint8 frames.

The port's own copy of ``vtc_tpu/data/preprocess.py:21-22,75-95,230-250``
(importing that package would pull in JAX through ``vtc_tpu.data``).
"""

from __future__ import annotations

import numpy as np
import torch

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


def normalize_uint8_images(x, mean=CLIP_MEAN, std=CLIP_STD):
    """Non-image inputs pass through; uint8 ``[..., h, w, 3]`` frames become
    CLIP-normalized fp32 ``[..., 3, h, w]`` on their device. The uint8 patch
    input ``[..., n, p·p·3]`` passes through: the patch-embed GEMM folds
    the normalization in. The arithmetic is the JAX step's (divide by 255,
    subtract the mean, divide by the std, in fp32)."""
    if not (isinstance(x, torch.Tensor) and x.dtype == torch.uint8
            and x.ndim >= 3 and x.shape[-1] == 3):
        return x
    y = x.float() / 255.0
    y = (y - torch.from_numpy(mean).to(y.device)) / torch.from_numpy(std).to(y.device)
    return y.movedim(-1, -3)
