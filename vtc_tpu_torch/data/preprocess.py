"""Image preprocessing: CLIP's transform and the train-time augmentations on
uint8 HWC arrays, the patch extraction of the uint8 patch input, and the
train step's normalization of uint8 frames.

The port's own copy of ``vtc_tpu/data/preprocess.py:21-227,230-250``, on
arrays where the JAX package takes PIL images: the resizes are
``resample.resize`` (PIL's resampler, bit for bit), and the random draws
are the same ``np.random.Generator`` calls in the same order, so a seed
gives the JAX package's crops, flips and jitter.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .resample import resize

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)
IG65M_MEAN = np.array([0.43216, 0.394666, 0.37645], dtype=np.float32)
IG65M_STD = np.array([0.22803, 0.22145, 0.216989], dtype=np.float32)


def _resize_short_side(img: np.ndarray, size: int) -> np.ndarray:
    # torchvision's Resize computes the long side with int() truncation
    # (functional_pil.resize: oh = int(size * h / w)), as the JAX package does
    h, w = img.shape[:2]
    if w <= h:
        new_w, new_h = size, max(1, int(h * size / w))
    else:
        new_w, new_h = max(1, int(w * size / h)), size
    return resize(img, new_w, new_h, "bicubic")


def _center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    left = (w - size) // 2
    top = (h - size) // 2
    return img[top : top + size, left : left + size]


def clip_preprocess(img: np.ndarray, size: int = 224) -> np.ndarray:
    """uint8 ``[h, w, 3]`` RGB -> float32 ``[3, size, size]``: bicubic resize
    of the short side, center crop, CLIP normalization (``(x / 255 - mean)
    / std`` in float32, as the JAX package computes it)."""
    img = _center_crop(_resize_short_side(img, size), size)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    arr = (arr - CLIP_MEAN) / CLIP_STD
    return arr.transpose(2, 0, 1)


def clip_resize_uint8(img: np.ndarray, size: int = 224) -> np.ndarray:
    """uint8 ``[h, w, 3]`` -> uint8 ``[size, size, 3]``: the host half of the
    uint8 input (normalized on the card by ``normalize_uint8_images``)."""
    return np.ascontiguousarray(_center_crop(_resize_short_side(img, size), size))


# --------------------------------------------------------------------------
# Train-time augmentations (numpy RNG)
# --------------------------------------------------------------------------


def _rand_resized_crop_params(
    rng: np.random.Generator,
    h: int,
    w: int,
    scale: Tuple[float, float] = (0.5, 1.0),
    ratio: Tuple[float, float] = (3 / 4, 4 / 3),
):
    area = h * w
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        aspect = np.exp(rng.uniform(*log_ratio))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            return top, left, ch, cw
    # fallback (torchvision RandomResizedCrop): center crop clamped to the
    # ratio range
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw = w
        ch = min(h, int(round(cw / ratio[0])))
    elif in_ratio > ratio[1]:
        ch = h
        cw = min(w, int(round(ch * ratio[1])))
    else:
        cw, ch = w, h
    return (h - ch) // 2, (w - cw) // 2, ch, cw


def _apply_color_jitter(arr: np.ndarray, rng: np.random.Generator, hue: float) -> np.ndarray:
    """Brightness/contrast/saturation (0.4) and optional hue jitter on float
    ``[*, h, w, 3]`` in [0, 1]; one draw shared across frames, the enabled
    adjustments in a random order (torchvision ColorJitter), each from the
    current image."""
    b = rng.uniform(0.6, 1.4)
    c = rng.uniform(0.6, 1.4)
    s = rng.uniform(0.6, 1.4)
    luma = np.array([0.299, 0.587, 0.114], dtype=np.float32)

    def _brightness(a):
        return np.clip(a * b, 0, 1)

    def _contrast(a):
        mean = (a @ luma).mean()
        return np.clip((a - mean) * c + mean, 0, 1)

    def _saturation(a):
        g = (a @ luma)[..., None]
        return np.clip((a - g) * s + g, 0, 1)

    def _hue(a):
        dh = rng.uniform(-hue, hue)
        # hue rotation in YIQ space
        cos_h, sin_h = np.cos(2 * np.pi * dh), np.sin(2 * np.pi * dh)
        t_yiq = np.array(
            [[0.299, 0.587, 0.114], [0.596, -0.274, -0.321], [0.211, -0.523, 0.311]],
            dtype=np.float32,
        )
        t_rgb = np.linalg.inv(t_yiq)
        rot = np.array(
            [[1, 0, 0], [0, cos_h, -sin_h], [0, sin_h, cos_h]], dtype=np.float32
        )
        return np.clip(a @ (t_rgb @ rot @ t_yiq).T, 0, 1)

    ops = [_brightness, _contrast, _saturation]
    if hue > 0:
        ops.append(_hue)
    for i in rng.permutation(len(ops)):
        arr = ops[int(i)](arr)
    return arr


def augment_frames(
    frames: np.ndarray,
    rng: Optional[np.random.Generator] = None,
    out_size: int = 256,
) -> np.ndarray:
    """uint8 ``[t, h, w, c]`` -> uint8 ``[t, out, out, c]``: one random
    resized crop (bilinear to ``out_size``), flip and jitter draw applied to
    every frame."""
    rng = rng or np.random.default_rng()
    t, h, w, c = frames.shape
    top, left, ch, cw = _rand_resized_crop_params(rng, h, w)
    cropped = frames[:, top : top + ch, left : left + cw]
    resized = resize(cropped, out_size, out_size, "bilinear")
    if rng.random() < 0.5:
        resized = resized[:, :, ::-1]
    hue = 0.1 if rng.random() < 0.5 else 0.0
    arr = resized.astype(np.float32) / 255.0
    arr = _apply_color_jitter(arr, rng, hue)
    return (arr * 255.0).astype(np.uint8)


def augment_image(img: np.ndarray, rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """The train-time augmentation of one uint8 ``[h, w, 3]`` image."""
    rng = rng or np.random.default_rng()
    return augment_frames(img[None], rng)[0]


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
