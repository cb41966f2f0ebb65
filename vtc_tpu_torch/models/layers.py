"""Transformer layers shared by the CLIP towers and the Context Adapter.

Port of ``vtc_tpu/models/layers.py``. Names follow the reference (openai
CLIP) state dict: ``ln_1``, ``attn.in_proj_weight`` ``[3E, E]``,
``attn.out_proj``, ``mlp.c_fc``, ``mlp.c_proj``, ``resblocks.{i}``.

Mixed precision follows flax: a ``dtype`` module computes its dense layers in
``dtype`` (input and weight cast, as ``nn.Dense(dtype=...)``), while the qkv
projection keeps its input's dtype (``layers.py:_dot``), so in the CAM, whose
input is the fp32 tower features, qkv and the residual stream stay fp32.
LayerNorm statistics are always fp32.

TPU-era means are left out: ``seq_fold``, the fused LN->Dense path, the
tensor-parallel qkv form, MoE, remat and stack parallelism (ROADMAP).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import add_layernorm, fused_mha, layernorm
from ..ops.attention import causal_mask  # noqa: F401  (re-exported, as in vtc_tpu)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def dense(x, linear: nn.Linear, dtype):
    """``nn.Dense(dtype=dtype)``: input, weight and bias in ``dtype``."""
    bias = None if linear.bias is None else linear.bias.to(dtype)
    return F.linear(x.to(dtype), linear.weight.to(dtype), bias)


class LayerNorm32(nn.Module):
    """LayerNorm in fp32 whatever the activation dtype, cast back; runs the
    ``ops.layernorm`` kernel on the card."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layernorm(x, self.weight, self.bias, self.eps)


class MultiHeadAttention(nn.Module):
    """``nn.MultiheadAttention``-named attention: one merged qkv GEMM over
    the ``[3E, E]`` ``in_proj_weight``, whose q/k/v column slices go to the
    ``ops.fused_mha`` kernel as strided views, then ``out_proj``."""

    def __init__(self, embed_dim: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"{embed_dim=} is not a multiple of {num_heads=}")
        self.num_heads = num_heads
        self.dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, x, causal: bool = False):
        w = self.in_proj_weight.to(self.dtype).to(x.dtype)
        b = self.in_proj_bias.to(self.dtype).to(x.dtype)
        q, k, v = F.linear(x, w, b).chunk(3, dim=-1)
        out = fused_mha(q, k, v, self.num_heads, causal)
        return dense(out, self.out_proj, self.dtype)


class MLPBlock(nn.Module):
    """CLIP MLP: c_fc (E -> 4E) -> QuickGELU -> c_proj (4E -> E)."""

    def __init__(self, width: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x):
        return dense(quick_gelu(dense(x, self.c_fc, self.dtype)), self.c_proj,
                     self.dtype)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block. The attention junction is one ``add_layernorm`` launch
    (the ``layers.py:432-437`` wiring); in fp32 it equals ``x + attn`` then
    ``ln_2``."""

    def __init__(self, width: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.ln_1 = LayerNorm32(width)
        self.attn = MultiHeadAttention(width, heads, dtype)
        self.ln_2 = LayerNorm32(width)
        self.mlp = MLPBlock(width, dtype)

    def forward(self, x, causal: bool = False):
        a = self.attn(self.ln_1(x), causal)
        x, h = add_layernorm(x, a, self.ln_2.weight, self.ln_2.bias, self.ln_2.eps)
        return x + self.mlp(h)


class Transformer(nn.Module):
    """Stack of residual attention blocks (also the CAM's adapter)."""

    def __init__(self, width: int, layers: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, dtype) for _ in range(layers)
        )

    def forward(self, x, causal: bool = False):
        for block in self.resblocks:
            x = block(x, causal)
        return x


def l2_normalize(x, dim: int = -1):
    """x / ||x||, the reference ``normalize`` (no eps)."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True)


def l2_normalize_eps(x, eps: float = 1e-9, dim: int = -1):
    """``normalize_eps``: l2_normalize(x + eps)."""
    return l2_normalize(x + eps, dim=dim)
