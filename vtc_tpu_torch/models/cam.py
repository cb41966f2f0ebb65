"""Context Adapter Module (CAM), eval path.

Port of ``vtc_tpu/models/cam.py``. A small transformer attends over the stack
``[main, comment_1..N]`` of L2-normalized embeddings and its output
residually adapts the main embedding:
``adapted = l2n(l2n(main) + act(residual))``.

The parameters carry the reference names (``final_transformer``,
``final_linear``, ``mask_embedding``, ``mean_center_bn``). The CAM retrieval
models inherit this module, so in their state dict these names sit at the top
level, as in the reference checkpoints.

The training-only stochastic paths (random adapter skip, random comment
masking) and the running-stat updates of ``sub_mean``/``bn`` wait for the
training slice (ROADMAP); here ``sub_mean``/``bn`` read the running stats.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..data.tokenizer import EOT_ID
from .layers import Transformer, l2_normalize, l2_normalize_eps

NEEDS_STATE = ("sub_mean", "bn")
BN_EPS = 1e-5


def squash(s):
    """Capsule-style squashing (reference ``model/model.py:34-39``)."""
    s = s + 1e-9
    mag_sq = torch.sum(s**2, dim=-1, keepdim=True)
    return (mag_sq / (1.0 + mag_sq)) * (s / torch.sqrt(mag_sq))


RESIDUAL_ACTIVATIONS = {
    "normalize": l2_normalize_eps,
    "squash": squash,
    "squash10": lambda x: 10 * squash(x),
    "squash1p2": lambda x: 1.2 * squash(x),
    "squash1p5": lambda x: 1.5 * squash(x),
    "squash1p8": lambda x: 1.8 * squash(x),
    "tanh": torch.tanh,
    "none": lambda x: x,
    None: lambda x: x,
}


class ContextAdapter(nn.Module):
    """Adapter transformer + residual head + mask embedding."""

    def __init__(self, feature_dim: int = 512, n_layers: int = 2,
                 n_heads: int = 8, init_from_avg: bool = True,
                 residual_activation: Optional[str] = None,
                 dtype=torch.float32):
        super().__init__()
        if residual_activation not in RESIDUAL_ACTIVATIONS and (
            residual_activation not in NEEDS_STATE
        ):
            raise ValueError(f"unknown residual activation {residual_activation!r}")
        self.init_from_avg = init_from_avg
        self.residual_activation = residual_activation
        self.final_transformer = Transformer(
            feature_dim, int(n_layers), int(n_heads), dtype
        )
        self.final_linear = nn.Linear(feature_dim, feature_dim, bias=False)
        self.mask_embedding = nn.Parameter(torch.empty(1, feature_dim))
        if residual_activation in NEEDS_STATE:
            # torch BatchNorm1d(affine=False, momentum=0.2): only its running
            # buffers are read here
            self.mean_center_bn = nn.BatchNorm1d(
                feature_dim, eps=BN_EPS, momentum=0.2, affine=False
            )

    def _residual_activation(self, s):
        act = self.residual_activation
        if act == "sub_mean":
            return s - self.mean_center_bn.running_mean.to(s.dtype)
        if act == "bn":
            mean = self.mean_center_bn.running_mean.to(s.dtype)
            var = self.mean_center_bn.running_var.to(s.dtype)
            return (s - mean) * torch.rsqrt(var + BN_EPS)
        return RESIDUAL_ACTIVATIONS[act](s)

    def adapt(self, feature_main, features_aux):
        """``feature_main`` [b, d], ``features_aux`` [n_aux, b, d] -> the
        adapted, L2-normalized [b, d]."""
        # batch-major stack [b, 1+n_aux, d], built contiguous for the kernels
        concat = torch.cat([feature_main[:, None], features_aux.transpose(0, 1)], 1)
        out = self.final_transformer(l2_normalize(concat))
        if self.init_from_avg:
            res = l2_normalize(torch.mean(l2_normalize(out), dim=1))
        else:
            w = self.final_linear.weight.to(out.dtype)
            res = torch.matmul(out[:, 0], w.T)
        res = self._residual_activation(res)
        return l2_normalize(l2_normalize(feature_main) + res)

    def substitute_empty(self, feats_comm, comment_tokens):
        """Embeddings of empty comments (EOT at token position 1) become the
        mask embedding. feats_comm [b, n, d]; comment_tokens [b, n, ntoks]."""
        empty = comment_tokens[..., 1] == EOT_ID
        return torch.where(
            empty[..., None], self.mask_embedding[0].to(feats_comm.dtype),
            feats_comm,
        )


@torch.no_grad()
def zero_init_cam_params(cam: ContextAdapter) -> None:
    """The reference's zero-init (``model/model.py:440-452``), in place: with
    ``init_from_avg`` each block's ``attn.out_proj`` weight and ``mlp.c_proj``
    are zeroed, so the adapter starts as an exact average; ``final_linear``
    starts at zero."""
    if cam.init_from_avg:
        for block in cam.final_transformer.resblocks:
            block.attn.out_proj.weight.zero_()
            block.mlp.c_proj.weight.zero_()
            block.mlp.c_proj.bias.zero_()
    cam.final_linear.weight.zero_()
