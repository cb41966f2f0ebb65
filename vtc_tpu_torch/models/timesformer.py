"""TimeSformer video tower: divided space-time attention over the CLIP ViT.

Port of ``vtc_tpu/models/timesformer.py`` (the reference's "alt" variant,
``model/timesformer_clip_alt.py:98-330``). Per block: temporal attention
over the ``t`` frames at each patch location (``timeattn``, through the
``ops.fused_attention`` kernel), the zero-initialized ``temporal_fc``, then
spatial attention within each frame with the CLS token replicated per frame
and mean-reduced back (``attn``, through ``ops.fused_mha``), then the MLP.

Token layout after embedding: ``[CLS, (patch_0 t_0..T), (patch_1 t_0..T),
...]``, token index ``1 + n·T + t``.

The JAX block folds 16 temporal sequences of 8 frames into one masked
attention call (``seq_fold=0``), a TPU means of filling the matrix unit's
lanes that multiplies the score work by the fold; here each sequence is
attended on its own, ``[b·n, t, m]``, which gives the same numbers.

State-dict names are the reference's: the tower sits at ``visual.*`` with
blocks at ``transformer.resblocks.{i}`` holding ``timeattn``, ``ln_time``,
``temporal_fc``, ``attn``, ``ln_1``, ``mlp``, ``ln_2``, and
``temporal_embed`` beside the ViT's parameters. Remat and stack
parallelism are not ported (ROADMAP).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..ops import add_layernorm
from .clip_model import ClipVariant, embed_patches, patchify
from .layers import HeadsAttention, LayerNorm32, MLPBlock, MultiHeadAttention, dense

TRUNC_STD = 0.02  # timeattn's trunc-normal init (timesformer.py:211-219)


class TimeSformerBlock(nn.Module):
    """One divided space-time block (``timesformer.py:37-106``)."""

    def __init__(self, width: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.timeattn = HeadsAttention(width, heads, dtype)
        self.ln_time = LayerNorm32(width)
        self.temporal_fc = nn.Linear(width, width)
        self.attn = MultiHeadAttention(width, heads, dtype)
        self.ln_1 = LayerNorm32(width)
        self.mlp = MLPBlock(width, dtype)
        self.ln_2 = LayerNorm32(width)

    def forward(self, x, nframes: int):
        b, length, m = x.shape
        t = nframes
        n = (length - 1) // t
        patches = x[:, 1:].reshape(b, n, t, m)

        # temporal attention per patch location, then temporal_fc
        xt = patches.reshape(b * n, t, m)
        res_t = dense(self.timeattn(self.ln_time(xt)), self.temporal_fc, self.dtype)
        xt = patches + res_t.reshape(b, n, t, m)

        # spatial attention per frame, the CLS replicated per frame
        init_cls = x[:, :1]
        cls_rep = init_cls[:, None].expand(b, t, 1, m).reshape(b * t, 1, m)
        xs = torch.cat([cls_rep, xt.transpose(1, 2).reshape(b * t, n, m)], dim=1)
        res_s = self.attn(self.ln_1(xs))
        cls_out = res_s[:, 0].reshape(b, t, m).mean(dim=1, keepdim=True)
        res_s = res_s[:, 1:].reshape(b, t, n, m).transpose(1, 2)

        # the block's junction: one add_layernorm launch, then the MLP
        x, h = add_layernorm(
            torch.cat([init_cls, xt.reshape(b, n * t, m)], dim=1),
            torch.cat([cls_out, res_s.reshape(b, n * t, m)], dim=1),
            self.ln_2.weight, self.ln_2.bias, self.ln_2.eps,
        )
        return x + self.mlp(h)


class TimeSformerTransformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.resblocks = nn.ModuleList(
            TimeSformerBlock(width, heads, dtype) for _ in range(layers)
        )

    def forward(self, x, nframes: int):
        for block in self.resblocks:
            x = block(x, nframes)
        return x


class TimeSformer(nn.Module):
    """Video tower: NCHW video ``[B, F, 3, H, W]`` (CLIP-normalized float) or
    pre-patchified frames ``[B, F, N, p·p·3]`` (uint8 pixels or normalized
    float) -> ``[B, embed_dim]``. F must equal ``nframes``."""

    def __init__(self, variant: ClipVariant, nframes: int = 8, dtype=torch.float32):
        super().__init__()
        v = variant
        self.variant = v
        self.nframes = nframes
        self.dtype = dtype
        width, patch = v.vision_width, v.patch_size
        n_pos = (v.input_resolution // patch) ** 2 + 1
        self.conv1 = nn.Conv2d(3, width, patch, stride=patch, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(n_pos, width))
        self.temporal_embed = nn.Parameter(torch.zeros(nframes, width))
        self.ln_pre = LayerNorm32(width)
        self.transformer = TimeSformerTransformer(
            width, v.vision_layers, v.vision_heads, dtype
        )
        self.ln_post = LayerNorm32(width)
        self.proj = nn.Parameter(torch.empty(width, v.embed_dim))

    def forward(self, x):
        width, patch = self.variant.vision_width, self.variant.patch_size
        bsz, frames = x.shape[:2]
        if frames != self.nframes:
            raise ValueError(f"the tower takes {self.nframes} frames, got {frames}")
        frames_in = x.reshape((bsz * frames,) + tuple(x.shape[2:]))
        patch_bias = None
        if x.dim() == 4:  # [B, F, N, p·p·3]
            xf, patch_bias = embed_patches(frames_in, self.conv1.weight, patch,
                                           self.dtype)
        else:  # [B, F, 3, H, W]
            w = self.conv1.weight.reshape(width, -1)
            xf = torch.matmul(patchify(frames_in.to(self.dtype), patch),
                              w.to(self.dtype).T)
        n = xf.shape[1]

        # per-frame positional embedding on the patch tokens; the uint8
        # input's folded-normalization bias rides the same add
        pos = self.positional_embedding[1:]
        if patch_bias is not None:
            pos = pos + patch_bias[None, :]
        xf = xf + pos.to(self.dtype)
        cls = (self.class_embedding + self.positional_embedding[0]).to(self.dtype)
        xf = xf.reshape(bsz, frames, n, width)
        xf = xf + self.temporal_embed[None, :, None, :].to(self.dtype)
        xf = xf.transpose(1, 2).reshape(bsz, n * frames, width)
        x = torch.cat([cls.expand(bsz, 1, width), xf], dim=1)

        x = self.transformer(self.ln_pre(x), frames)
        x = self.ln_post(x[:, 0])
        return torch.matmul(x, self.proj.to(self.dtype))


def _trunc_normal(shape, generator, std: float = TRUNC_STD) -> torch.Tensor:
    """``torch.nn.init.trunc_normal_(std=std)`` with its default absolute
    bounds ±2 (±100σ at std 0.02), as ``timesformer.py:_trunc_normal``."""
    return nn.init.trunc_normal_(torch.empty(shape), std=std, a=-2.0, b=2.0,
                                 generator=generator)


@torch.no_grad()
def timesformer_params_from_clip_visual(
    clip_visual: Dict[str, torch.Tensor], variant: ClipVariant,
    nframes: int = 8, seed: int = 0,
) -> Dict[str, torch.Tensor]:
    """CLIP -> TimeSformer weight surgery on state dicts
    (``timesformer.py:222-283``): ``clip_visual`` is a ``VisionTransformer``
    state dict (names relative to the tower); every entry is copied, and the
    only new ones are the time/temporal parameters: ``timeattn``
    (trunc-normal weights, zero biases), ``ln_time`` (identity),
    ``temporal_fc`` (zeros: the block starts as a no-op) and
    ``temporal_embed`` (zeros). Returns a ``TimeSformer`` state dict."""
    g = torch.Generator().manual_seed(seed)
    width = variant.vision_width
    out = {k: v.clone() for k, v in clip_visual.items()}
    out["temporal_embed"] = torch.zeros(nframes, width)
    for i in range(variant.vision_layers):
        pre = f"transformer.resblocks.{i}."
        out[pre + "timeattn.in_proj_weight"] = _trunc_normal((3 * width, width), g)
        out[pre + "timeattn.in_proj_bias"] = torch.zeros(3 * width)
        out[pre + "timeattn.out_proj.weight"] = _trunc_normal((width, width), g)
        out[pre + "timeattn.out_proj.bias"] = torch.zeros(width)
        out[pre + "ln_time.weight"] = torch.ones(width)
        out[pre + "ln_time.bias"] = torch.zeros(width)
        out[pre + "temporal_fc.weight"] = torch.zeros(width, width)
        out[pre + "temporal_fc.bias"] = torch.zeros(width)
    # the reference asserts that every missing key is a time/temporal one
    # (timesformer_clip_alt.py:325-328)
    new = set(out) - set(clip_visual)
    if not all("time" in k or "temporal" in k for k in new):
        raise AssertionError(f"surgery made non-temporal keys: {sorted(new)}")
    return out
