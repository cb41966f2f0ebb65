"""Transformer layers shared by the CLIP towers and the Context Adapter.

Port of ``vtc_tpu/models/layers.py``. Names follow the reference (openai
CLIP) state dict: ``ln_1``, ``attn.in_proj_weight`` ``[3E, E]``,
``attn.out_proj``, ``mlp.c_fc``, ``mlp.c_proj``, ``resblocks.{i}``; the
TimeSformer's ``timeattn`` has the same names.

Mixed precision follows flax: a ``dtype`` module computes its dense layers in
``dtype`` (input and weight cast, as ``nn.Dense(dtype=...)``), while the qkv
projection keeps its input's dtype (``layers.py:_dot``), so in the CAM, whose
input is the fp32 tower features, qkv and the residual stream stay fp32.
LayerNorm statistics are always fp32.

``moe_experts > 0`` swaps a block's MLP for the one-device mixture of
experts ``parallel.expert.MoEMLP`` (parameters under ``mlp_moe``).
``TorchBatchNorm`` is torch's own BatchNorm, which the JAX class of that
name imitates, computing in fp32 whatever the activation dtype.

TPU-era means are left out: ``seq_fold``, the fused LN->Dense path, the
tensor-parallel qkv form, remat and stack parallelism (ROADMAP). Where
the JAX package folds short sequences into one masked attention call
(``seq_fold=0``, the TimeSformer's temporal attention), the port attends
each sequence on its own: the masked cross-sequence entries are exactly 0
after the softmax, so the two agree.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import add_layernorm, fused_attention, fused_mha, layernorm
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

    def qkv(self, x):
        w = self.in_proj_weight.to(self.dtype).to(x.dtype)
        b = self.in_proj_bias.to(self.dtype).to(x.dtype)
        return F.linear(x, w, b).chunk(3, dim=-1)

    def forward(self, x, causal: bool = False):
        q, k, v = self.qkv(x)
        out = fused_mha(q, k, v, self.num_heads, causal)
        return dense(out, self.out_proj, self.dtype)


class HeadsAttention(MultiHeadAttention):
    """``MultiHeadAttention``'s parameters and math through the
    ``ops.fused_attention`` kernel: the q/k/v column slices of the merged
    qkv GEMM, viewed as ``[B, H, L, Dh]`` (heads split into the batch, no
    copy), with an optional additive ``[L, L]`` mask. The kernel writes its
    output in ``[B, L, H, Dh]`` order, so ``out_proj`` reads it without a
    copy. At Dh = 64 the scale 1/8 is a power of two, so scaling the fp32
    scores (``fused_attention``) equals scaling q in its dtype, as
    ``MultiHeadAttention`` does, bit for bit. The TimeSformer's
    ``timeattn``."""

    def forward(self, x, mask=None):
        b, l, e = x.shape
        q, k, v = (t.unflatten(-1, (self.num_heads, -1)).transpose(1, 2)
                   for t in self.qkv(x))
        out = fused_attention(q, k, v, mask).transpose(1, 2).reshape(b, l, e)
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
    ``ln_2``. With ``moe_experts`` the MLP is ``mlp_moe``, a
    ``parallel.expert.MoEMLP`` routing ``moe_top_k`` experts per token."""

    def __init__(self, width: int, heads: int, dtype=torch.float32,
                 moe_experts: int = 0, moe_top_k: int = 1):
        super().__init__()
        self.ln_1 = LayerNorm32(width)
        self.attn = MultiHeadAttention(width, heads, dtype)
        self.ln_2 = LayerNorm32(width)
        if moe_experts:
            from ..parallel.expert import MoEMLP

            self.mlp_moe = MoEMLP(width, moe_experts, moe_top_k, dtype=dtype)
        else:
            self.mlp = MLPBlock(width, dtype)

    def forward(self, x, causal: bool = False):
        a = self.attn(self.ln_1(x), causal)
        x, h = add_layernorm(x, a, self.ln_2.weight, self.ln_2.bias, self.ln_2.eps)
        mlp = self.mlp_moe if hasattr(self, "mlp_moe") else self.mlp
        return x + mlp(h)


class Transformer(nn.Module):
    """Stack of residual attention blocks (also the CAM's adapter)."""

    def __init__(self, width: int, layers: int, heads: int, dtype=torch.float32,
                 moe_experts: int = 0, moe_top_k: int = 1):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, dtype, moe_experts, moe_top_k)
            for _ in range(layers)
        )

    def forward(self, x, causal: bool = False):
        for block in self.resblocks:
            x = block(x, causal)
        return x


class DrawnDropout(nn.Module):
    """flax's ``nn.Dropout`` in training (``where(keep, x / (1 - p), 0)``),
    the identity in eval; ``keep`` (bool, ``x``'s shape) is handed in or
    drawn from ``generator``."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x, keep=None, generator=None):
        if not self.training or self.p == 0:
            return x
        if keep is None:
            keep = draw_dropout_keep(x.shape, self.p, generator, x.device)
        return torch.where(keep.to(x.device), x / (1 - self.p), 0.0)


def draw_dropout_keep(shape, p: float, generator=None, device=None) -> torch.Tensor:
    """A bool keep mask, True with probability ``1 - p``: the JAX draw
    ``bernoulli(1 - p)``."""
    device = generator.device if generator is not None else device
    return torch.rand(tuple(shape), generator=generator, device=device) < 1 - p


class TorchBatchNorm(nn.modules.batchnorm._BatchNorm):
    """``nn.BatchNorm1d``/``nn.BatchNorm3d`` over dimension 1 of any input
    of 2 or more dimensions: in training the batch's biased variance
    normalizes and the unbiased one updates ``running_var`` at torch's
    momentum 0.1 (flax's 0.9), as ``vtc_tpu``'s ``TorchBatchNorm`` does; in
    eval the running stats normalize. Statistics and the affine map are
    fp32, the output is cast to ``dtype``."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 dtype=torch.float32):
        super().__init__(num_features, eps, momentum)
        self.compute_dtype = dtype

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f"expected an input of 2 or more dims, got {x.dim()}")

    def forward(self, x):
        return super().forward(x.float()).to(self.compute_dtype)


def bn_state_from_jax(scale, bias, mean=None, var=None) -> dict:
    """A flax ``TorchBatchNorm``'s ``scale``/``bias`` (params) and
    ``mean``/``var`` (batch_stats) as ``TorchBatchNorm`` state; without
    batch stats, the init's zeros and ones."""
    scale = np.asarray(scale, np.float32)
    d = scale.shape[0]
    return {
        "weight": scale,
        "bias": np.asarray(bias, np.float32),
        "running_mean": np.zeros(d, np.float32) if mean is None else np.asarray(mean, np.float32),
        "running_var": np.ones(d, np.float32) if var is None else np.asarray(var, np.float32),
        "num_batches_tracked": np.asarray(0, np.int64),
    }


def l2_normalize(x, dim: int = -1):
    """x / ||x||, the reference ``normalize`` (no eps)."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True)


def l2_normalize_eps(x, eps: float = 1e-9, dim: int = -1):
    """``normalize_eps``: l2_normalize(x + eps)."""
    return l2_normalize(x + eps, dim=dim)
