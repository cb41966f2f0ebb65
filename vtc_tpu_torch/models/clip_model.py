"""CLIP dual encoder: ViT image tower and causal text tower.

Port of ``vtc_tpu/models/clip_model.py``. The module tree has the openai
CLIP state-dict names: ``visual.*`` for the image tower and, flat on the
model, ``token_embedding``, ``positional_embedding``, ``transformer``,
``ln_final``, ``text_projection`` and ``logit_scale`` for the text tower;
``ClipModel`` therefore extends ``TextTransformer`` rather than holding it.

The patch embedding is a matmul over patches (``patchify`` for NCHW input),
never a convolution: the uint8 patch input folds the CLIP normalization into
the weight, and its bias into the positional embedding (``embed_patches``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.preprocess import CLIP_MEAN, CLIP_STD
from .layers import LayerNorm32, Transformer


@dataclasses.dataclass(frozen=True)
class ClipVariant:
    input_resolution: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    embed_dim: int = 512
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    context_length: int = 77
    vocab_size: int = 49408


CLIP_VARIANTS = {
    "ViT-B/32": ClipVariant(),
    "ViT-B/16": ClipVariant(patch_size=16),
    "ViT-L/14": ClipVariant(
        patch_size=14, vision_width=1024, vision_layers=24, vision_heads=16,
        embed_dim=768,
    ),
    # miniature variant for CPU tests
    "test-tiny": ClipVariant(
        input_resolution=32, patch_size=8, vision_width=64, vision_layers=2,
        vision_heads=4, embed_dim=32, text_width=64, text_layers=2,
        text_heads=4,
    ),
}


def patch_input_dim(variant: ClipVariant) -> int:
    return 3 * variant.patch_size * variant.patch_size


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, 3, H, W] -> [B, gh·gw, 3·p·p], channel-major patch vectors that
    match the OIHW conv weight flattened as ``W.reshape(out, -1)``."""
    b, c, h, w = x.shape
    gh, gw = h // patch, w // patch
    x = x.reshape(b, c, gh, patch, gw, patch).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, gh * gw, c * patch * patch)


def hwc_col_perm(patch: int) -> np.ndarray:
    """Column permutation taking the channel-major (c, ph, pw) conv weight to
    the (ph, pw, c) order of ``data.preprocess.extract_patches``."""
    idx = np.arange(3 * patch * patch).reshape(3, patch, patch)
    return idx.transpose(1, 2, 0).reshape(-1)


def embed_patches(x, conv_weight, patch: int, dtype):
    """Patch input ``[..., N, p·p·3]`` (hwc order, uint8 or normalized float)
    -> (``[..., N, width]`` embeddings in ``dtype``, bias or None).

    For uint8 pixels the normalization ``u·a + b`` (a = 1/(255·std),
    b = -mean/std per column) is folded into the weight, and the fp32 bias
    ``b @ Wᵀ`` is returned for the caller's positional-embedding add."""
    w = conv_weight.reshape(conv_weight.shape[0], -1)
    w = w[:, torch.as_tensor(hwc_col_perm(patch), device=w.device)]
    patch_bias = None
    if not torch.is_floating_point(x):
        std = torch.as_tensor(np.tile(CLIP_STD, patch * patch), device=w.device)
        mean = torch.as_tensor(np.tile(CLIP_MEAN, patch * patch), device=w.device)
        w = w.float()
        patch_bias = (-mean / std) @ w.T
        w = w * (1.0 / (255.0 * std))[None, :]
    return torch.matmul(x.to(dtype), w.to(dtype).T), patch_bias


class VisionTransformer(nn.Module):
    """CLIP visual tower. Takes NCHW images ``[B, 3, H, W]`` (CLIP-normalized
    float) or the patch input ``[B, N, p·p·3]`` (uint8 pixels or normalized
    float)."""

    def __init__(self, variant: ClipVariant, dtype=torch.float32):
        super().__init__()
        v = variant
        self.variant = v
        self.dtype = dtype
        width, patch = v.vision_width, v.patch_size
        n_pos = (v.input_resolution // patch) ** 2 + 1
        self.conv1 = nn.Conv2d(3, width, patch, stride=patch, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(n_pos, width))
        self.ln_pre = LayerNorm32(width)
        self.transformer = Transformer(width, v.vision_layers, v.vision_heads, dtype)
        self.ln_post = LayerNorm32(width)
        self.proj = nn.Parameter(torch.empty(width, v.embed_dim))

    def forward(self, x):
        patch = self.variant.patch_size
        patch_bias = None
        if x.dim() == 3:
            x, patch_bias = embed_patches(x, self.conv1.weight, patch, self.dtype)
        else:
            w = self.conv1.weight.reshape(self.conv1.weight.shape[0], -1)
            x = torch.matmul(patchify(x.to(self.dtype), patch), w.to(self.dtype).T)
        cls = self.class_embedding.to(self.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1)
        pos = self.positional_embedding
        if patch_bias is not None:
            # the bias is the same at every patch position; row 0 is CLS
            pos = torch.cat([pos[:1], pos[1:] + patch_bias[None, :]])
        x = self.ln_pre(x + pos.to(self.dtype))
        x = self.transformer(x)
        x = self.ln_post(x[:, 0, :])
        return torch.matmul(x, self.proj.to(self.dtype))


class TextTransformer(nn.Module):
    """CLIP text tower: causal transformer, EOT pooling, projection. On the
    model axis (``tp``) ``token_embedding`` holds this rank's vocabulary
    rows: a masked lookup, then the ranks' rows summed."""

    tp = None  # the model axis of a split vocabulary

    def __init__(self, variant: ClipVariant, dtype=torch.float32):
        super().__init__()
        v = variant
        self.variant = v
        self.dtype = dtype
        self.token_embedding = nn.Embedding(v.vocab_size, v.text_width)
        self.positional_embedding = nn.Parameter(
            torch.empty(v.context_length, v.text_width)
        )
        self.transformer = Transformer(v.text_width, v.text_layers, v.text_heads, dtype)
        self.ln_final = LayerNorm32(v.text_width)
        self.text_projection = nn.Parameter(torch.empty(v.text_width, v.embed_dim))

    def encode_text(self, text):
        """[N, L] token ids -> [N, embed_dim] in the model's dtype."""
        n, length = text.shape
        x = self.embed_tokens(text.long()).to(self.dtype)
        x = x + self.positional_embedding[:length].to(self.dtype)
        x = self.transformer(x, causal=True)
        # pool at EOT (the highest id) BEFORE ln_final: LayerNorm is per
        # token, so normalizing only the pooled rows is the same math
        x = x[torch.arange(n, device=x.device), text.argmax(dim=-1)]
        return torch.matmul(self.ln_final(x), self.text_projection.to(self.dtype))

    def embed_tokens(self, ids):
        weight = self.token_embedding.weight
        if self.tp is None:
            return F.embedding(ids, weight)
        from ..parallel.tensor import reduce_from_model

        local = ids - self.tp.rank * weight.shape[0]
        mine = (local >= 0) & (local < weight.shape[0])
        rows = F.embedding(local.clamp(0, weight.shape[0] - 1), weight)
        return reduce_from_model(torch.where(mine[..., None], rows, 0.0), self.tp)

    def forward(self, text):
        return self.encode_text(text)


class ClipModel(TextTransformer):
    """Dual encoder with the learned ``logit_scale``. ``visual_module``
    swaps the visual tower (the TimeSformer models pass
    ``timesformer.TimeSformer`` with ``visual_kwargs={"nframes": ...}``), as
    ``vtc_tpu.models.clip_model.ClipModel`` does."""

    def __init__(self, variant: ClipVariant, dtype=torch.float32,
                 visual_module: Optional[type] = None,
                 visual_kwargs: Optional[dict] = None):
        super().__init__(variant, dtype)
        self.visual = (visual_module or VisionTransformer)(
            variant, dtype=dtype, **(visual_kwargs or {})
        )
        self.logit_scale = nn.Parameter(torch.tensor(float(np.log(1 / 0.07))))

    def encode_image(self, images):
        return self.visual(images)

    def forward(self, images, text):
        return self.encode_image(images), self.encode_text(text), self.logit_scale
