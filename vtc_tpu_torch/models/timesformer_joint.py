"""TimeSformer with the joint token layout: the port of
``vtc_tpu/models/timesformer_joint.py`` (the reference's first
factorization, ``model/timesformer_clip.py:55-467``, which no exported
model uses; neither package's factory reaches it).

Token layout: ``[CLS, f1p1..f1pN, f2p1..f2pN, ...]`` (frame-major). Each
block, pre-LN residual style:

1. time attention (``timeattn``): each patch token attends over its patch
   position's T frames plus the CLS token; the CLS token attends over all
   1 + T·N tokens. The surgery starts it as an exact no-op (zero
   ``in_proj``, an all-ones ``out_proj`` over zero values);
2. space attention (``attn``): each patch token attends over its frame's N
   patches plus the CLS token; the CLS token over all tokens;
3. the MLP.

The positional embedding is tiled over the frames, the temporal embedding
repeated over each frame's patches.

The attentions run on the port's kernels, where ``vtc_tpu`` runs XLA
attention (``_attn``, ``:31-35``):

* the CLS row, 1 query over 1 + T·N keys (393 at ViT-B/32 with 8 frames),
  is ``ops.fused_mha`` with fewer queries than keys: the cross route
  (``ops.fused_mha_cross``, ``csrc/cross_attention.cuh``), 2 launches a
  block;
* the groups run on the short tile at Lq = Lk: each group's sequence is the
  CLS token then its T (time) or N (space) tokens, so the CLS key is in
  row 0, as ``vtc_tpu`` prepends it; the CLS query in row 0 comes along and
  its output row is dropped. Each row's softmax is its own, so the other
  rows are exactly ``_attn``'s. One ``fused_mha`` launch a group set.

``fused_mha`` scales q in its dtype before the product, as ``vtc_tpu`` does
(``:89``). The block's junctions are ``add_layernorm`` launches (``x +
timeattn`` with ``ln_1``, ``x + attn`` with ``ln_2``), as the port's other
blocks; ``ln_time`` is a ``layernorm``. ``VTC_REMAT=1`` runs each block
under ``layers.run_block``, as ``nn.remat(JointBlock)`` (``:211``). On the
model axis (``parallel.tensor``) both attentions split by heads, as every
``*attn`` does.

State-dict names are the port's: ``conv1.weight`` (OIHW),
``class_embedding``, ``positional_embedding``, ``temporal_embed``,
``ln_pre``, ``transformer.resblocks.{i}.{timeattn, ln_time, attn, ln_1,
mlp, ln_2}``, ``ln_post``, ``proj``; ``models.from_jax.
joint_state_dict_from_jax`` carries ``vtc_tpu``'s tree across.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..ops import add_layernorm, fused_mha
from .clip_model import ClipVariant, patchify
from .layers import (
    LayerNorm32,
    MLPBlock,
    MultiHeadAttention,
    into_split,
    row_parallel_dense,
    run_block,
)

MODES = ("space", "time")


class FactorizedAttention(MultiHeadAttention):
    """``_FactorizedAttention``: ``MultiHeadAttention``'s parameters, the
    patch tokens attending within their frame (``mode="space"``) or across
    the frames at their position (``"time"``), each beside the CLS token,
    and the CLS token over every token."""

    def __init__(self, embed_dim: int, num_heads: int, nframes: int, mode: str,
                 dtype=torch.float32):
        super().__init__(embed_dim, num_heads, dtype)
        if mode not in MODES:
            raise ValueError(f"mode {mode!r}: expected one of {MODES}")
        self.nframes = nframes
        self.mode = mode

    def forward(self, x):
        b, length, _ = x.shape
        t = self.nframes
        n = (length - 1) // t
        qkv = self.qkv_rows(into_split(x, self.tp))
        e3 = qkv.shape[-1]
        heads = self.local_heads

        q, k, v = qkv.chunk(3, dim=-1)
        cls_out = fused_mha(q[:, :1], k, v, heads)  # CLS over all 1 + T·N keys

        groups = qkv[:, 1:].reshape(b, t, n, e3)
        if self.mode == "time":
            groups = groups.transpose(1, 2)  # [b, n, t, 3e]: each position's frames
        g, m = groups.shape[1:3]
        cls = qkv[:, None, :1].expand(b, g, 1, e3)
        seq = torch.cat([cls, groups], dim=2).reshape(b * g, 1 + m, e3)
        qg, kg, vg = seq.chunk(3, dim=-1)
        out = fused_mha(qg, kg, vg, heads)[:, 1:].reshape(b, g, m, -1)
        if self.mode == "time":
            out = out.transpose(1, 2)
        out = torch.cat([cls_out, out.reshape(b, t * n, -1)], dim=1)
        return row_parallel_dense(out, self.out_proj, self.dtype, self.tp)


class JointBlock(nn.Module):
    """Time attention, space attention, MLP (``timesformer_joint.py:
    151-172``)."""

    def __init__(self, width: int, heads: int, nframes: int, dtype=torch.float32):
        super().__init__()
        self.timeattn = FactorizedAttention(width, heads, nframes, "time", dtype)
        self.ln_time = LayerNorm32(width)
        self.attn = FactorizedAttention(width, heads, nframes, "space", dtype)
        self.ln_1 = LayerNorm32(width)
        self.mlp = MLPBlock(width, dtype)
        self.ln_2 = LayerNorm32(width)

    def forward(self, x):
        x, h = add_layernorm(x, self.timeattn(self.ln_time(x)), self.ln_1.weight,
                             self.ln_1.bias, self.ln_1.eps)
        x, h = add_layernorm(x, self.attn(h), self.ln_2.weight, self.ln_2.bias,
                             self.ln_2.eps)
        return x + self.mlp(h)


class JointTransformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, nframes: int,
                 dtype=torch.float32):
        super().__init__()
        self.resblocks = nn.ModuleList(
            JointBlock(width, heads, nframes, dtype) for _ in range(layers))

    def forward(self, x):
        for block in self.resblocks:
            x = run_block(block, x)
        return x


class TimeSformerJoint(nn.Module):
    """``[B, F, 3, H, W]`` CLIP-normalized video -> ``[B, embed_dim]``, the
    joint token layout. F must equal ``nframes``."""

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
        self.transformer = JointTransformer(width, v.vision_layers, v.vision_heads,
                                            nframes, dtype)
        self.ln_post = LayerNorm32(width)
        self.proj = nn.Parameter(torch.empty(width, v.embed_dim))

    def forward(self, x):
        width, patch = self.variant.vision_width, self.variant.patch_size
        bsz, frames = x.shape[:2]
        if frames != self.nframes:
            raise ValueError(f"the tower takes {self.nframes} frames, got {frames}")
        w = self.conv1.weight.reshape(width, -1)
        xf = torch.matmul(patchify(x.reshape((bsz * frames,) + tuple(x.shape[2:]))
                                   .to(self.dtype), patch), w.to(self.dtype).T)
        n = xf.shape[1]
        xf = xf.reshape(bsz, frames * n, width)  # frame-major

        pos = self.positional_embedding
        total = torch.cat([pos[:1], pos[1:].repeat(frames, 1)
                           + self.temporal_embed.repeat_interleave(n, dim=0)])
        cls = self.class_embedding.to(self.dtype).expand(bsz, 1, width)
        x = torch.cat([cls, xf], dim=1) + total.to(self.dtype)

        x = self.transformer(self.ln_pre(x))
        x = self.ln_post(x[:, 0])
        return torch.matmul(x, self.proj.to(self.dtype))


@torch.no_grad()
def joint_timesformer_params_from_clip_visual(
    clip_visual: Dict[str, torch.Tensor], variant: ClipVariant, nframes: int = 8,
) -> Dict[str, torch.Tensor]:
    """CLIP -> joint TimeSformer surgery (``timesformer_joint.py:229-266``,
    the reference's ``timesformer_clip.py:436-466``) on state dicts:
    ``clip_visual`` is a ``VisionTransformer`` state dict (names relative
    to the tower). Each block's attention, MLP and LayerNorms copy across;
    the time attention starts as an exact no-op (zero ``in_proj``, an
    all-ones ``out_proj`` weight, zero biases), ``ln_time`` as the
    identity and ``temporal_embed`` at zero. Returns a ``TimeSformerJoint``
    state dict."""
    width = variant.vision_width
    out = {k: clip_visual[k].clone() for k in (
        "conv1.weight", "class_embedding", "positional_embedding", "ln_pre.weight",
        "ln_pre.bias", "ln_post.weight", "ln_post.bias", "proj")}
    out["temporal_embed"] = torch.zeros(nframes, width)
    for i in range(variant.vision_layers):
        pre = f"transformer.resblocks.{i}."
        for k, v in clip_visual.items():
            if k.startswith(pre):
                out[k] = v.clone()
        out[pre + "timeattn.in_proj_weight"] = torch.zeros(3 * width, width)
        out[pre + "timeattn.in_proj_bias"] = torch.zeros(3 * width)
        out[pre + "timeattn.out_proj.weight"] = torch.ones(width, width)
        out[pre + "timeattn.out_proj.bias"] = torch.zeros(width)
        out[pre + "ln_time.weight"] = torch.ones(width)
        out[pre + "ln_time.bias"] = torch.zeros(width)
    return out
