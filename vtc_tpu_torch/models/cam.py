"""Context Adapter Module (CAM).

Port of ``vtc_tpu/models/cam.py``. A small transformer attends over the stack
``[main, comment_1..N]`` of L2-normalized embeddings and its output
residually adapts the main embedding:
``adapted = l2n(l2n(main) + act(residual))``.

The parameters carry the reference names (``final_transformer``,
``final_linear``, ``mask_embedding``, ``mean_center_bn``). The CAM retrieval
models inherit this module, so in their state dict these names sit at the top
level, as in the reference checkpoints.

In training (``module.train()``, ``cam.py:110-214`` of the JAX package):

* ``sub_mean``/``bn`` use the batch's statistics and update the running
  stats of ``mean_center_bn`` in fp32, at momentum 0.2 with the unbiased
  batch variance (torch ``BatchNorm1d``); a batch of 1 is refused. With the
  adapter frozen (``finaltf_frozen``) they read the running stats;
* random adapter skip zeroes the residual of each sample with ``u > 0.5``;
* random comment masking swaps each (comment, sample) for the mask embedding
  with probability 1/2 (``random_mask_comments``, called by the retrieval
  models when configured).

``moe_experts > 0`` gives the adapter's blocks mixture-of-experts MLPs
(``parallel.expert.MoEMLP``).

The random draws come from the ``torch.Generator`` the caller passes (on the
model's device), or are handed in as tensors: ``torch.Generator`` cannot
reproduce ``jax.random``, so a test feeds the port the JAX draw.
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
                 random_skip_adapter: bool = True, dtype=torch.float32,
                 moe_experts: int = 0, moe_top_k: int = 1):
        super().__init__()
        if residual_activation not in RESIDUAL_ACTIVATIONS and (
            residual_activation not in NEEDS_STATE
        ):
            raise ValueError(f"unknown residual activation {residual_activation!r}")
        self.init_from_avg = init_from_avg
        self.residual_activation = residual_activation
        self.random_skip_adapter = random_skip_adapter
        self.final_transformer = Transformer(
            feature_dim, int(n_layers), int(n_heads), dtype, int(moe_experts),
            int(moe_top_k),
        )
        self.final_linear = nn.Linear(feature_dim, feature_dim, bias=False)
        self.mask_embedding = nn.Parameter(torch.empty(1, feature_dim))
        if residual_activation in NEEDS_STATE:
            # torch BatchNorm1d(affine=False, momentum=0.2): only its running
            # buffers are used, read in eval and updated in training
            self.mean_center_bn = nn.BatchNorm1d(
                feature_dim, eps=BN_EPS, momentum=0.2, affine=False
            )

    def _update_bn_stats(self, s):
        """running = 0.8·running + 0.2·batch, in fp32, with the unbiased
        batch variance (``cam.py:110-127``)."""
        n = s.shape[0]
        if n < 2:
            raise ValueError(
                f"{self.residual_activation!r} residual activation needs "
                f"batch >= 2 in training (got {n}); drop 1-element batches "
                f"(drop_last) or freeze the adapter"
            )
        bn = self.mean_center_bn
        with torch.no_grad():
            s32 = s.detach().float()
            batch_var = s32.var(dim=0, unbiased=False) * (n / (n - 1))
            bn.running_mean.copy_(0.8 * bn.running_mean + 0.2 * s32.mean(dim=0))
            bn.running_var.copy_(0.8 * bn.running_var + 0.2 * batch_var)
            bn.num_batches_tracked += 1

    def _residual_activation(self, s, finaltf_frozen: bool = False):
        act = self.residual_activation
        batch_stats = self.training and not finaltf_frozen
        if act == "sub_mean":
            if batch_stats:
                self._update_bn_stats(s)
                return s - s.mean(dim=0)
            return s - self.mean_center_bn.running_mean.to(s.dtype)
        if act == "bn":
            if batch_stats:
                mean, var = s.mean(dim=0), s.var(dim=0, unbiased=False)
                self._update_bn_stats(s)
            else:
                mean = self.mean_center_bn.running_mean.to(s.dtype)
                var = self.mean_center_bn.running_var.to(s.dtype)
            return (s - mean) * torch.rsqrt(var + BN_EPS)
        return RESIDUAL_ACTIVATIONS[act](s)

    def adapt(self, feature_main, features_aux, finaltf_frozen: bool = False,
              skip: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None):
        """``feature_main`` [b, d], ``features_aux`` [n_aux, b, d] -> the
        adapted, L2-normalized [b, d]. In training with
        ``random_skip_adapter``, ``skip`` ([b, 1] bool, True zeroes the
        residual) is drawn from ``generator`` unless given."""
        # batch-major stack [b, 1+n_aux, d], built contiguous for the kernels
        concat = torch.cat([feature_main[:, None], features_aux.transpose(0, 1)], 1)
        out = self.final_transformer(l2_normalize(concat))
        if self.init_from_avg:
            res = l2_normalize(torch.mean(l2_normalize(out), dim=1))
        else:
            w = self.final_linear.weight.to(out.dtype)
            res = torch.matmul(out[:, 0], w.T)
        res = self._residual_activation(res, finaltf_frozen)
        if self.training and self.random_skip_adapter:
            if skip is None:
                skip = draw_adapter_skip(res.shape[0], generator, res.device)
            res = torch.where(skip.to(res.device), 0.0, res)
        return l2_normalize(l2_normalize(feature_main) + res)

    def random_mask_comments(self, feats_comm, keep: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None):
        """Train-time random comment masking (``cam.py:200-210``):
        ``feats_comm`` [n_aux, b, d]; ``keep`` [n_aux, b, 1] of 0/1 (1 keeps
        the comment, 0 swaps in the mask embedding), drawn from
        ``generator`` unless given."""
        n_aux, b, _ = feats_comm.shape
        if keep is None:
            keep = draw_comment_keep(n_aux, b, generator, feats_comm.device)
        keep = keep.to(device=feats_comm.device, dtype=feats_comm.dtype)
        mask = self.mask_embedding[0].to(feats_comm.dtype)
        return feats_comm * keep + mask * (1 - keep)

    def substitute_empty(self, feats_comm, comment_tokens):
        """Embeddings of empty comments (EOT at token position 1) become the
        mask embedding. feats_comm [b, n, d]; comment_tokens [b, n, ntoks]."""
        empty = comment_tokens[..., 1] == EOT_ID
        return torch.where(
            empty[..., None], self.mask_embedding[0].to(feats_comm.dtype),
            feats_comm,
        )


def _draw_device(generator, device):
    return generator.device if generator is not None else device


def draw_adapter_skip(batch: int, generator=None, device=None) -> torch.Tensor:
    """[batch, 1] bool, True with probability 1/2: the JAX draw
    ``uniform(b, 1) > 0.5``."""
    device = _draw_device(generator, device)
    return torch.rand((batch, 1), generator=generator, device=device) > 0.5


def draw_comment_keep(n_aux: int, batch: int, generator=None, device=None):
    """[n_aux, batch, 1] of 0/1: the JAX draw ``randint(0, 2)``."""
    device = _draw_device(generator, device)
    return torch.randint(0, 2, (n_aux, batch, 1), generator=generator, device=device)


@torch.no_grad()
def zero_init_cam_params(cam: ContextAdapter) -> None:
    """The reference's zero-init (``model/model.py:440-452``), in place: with
    ``init_from_avg`` each block's ``attn.out_proj`` weight and ``mlp.c_proj``
    (a MoE block: every expert's ``w_proj`` and ``bias_proj``) are zeroed, so
    the adapter starts as an exact average; ``final_linear`` starts at
    zero."""
    if cam.init_from_avg:
        for block in cam.final_transformer.resblocks:
            block.attn.out_proj.weight.zero_()
            if hasattr(block, "mlp_moe"):
                block.mlp_moe.w_proj.zero_()
                block.mlp_moe.bias_proj.zero_()
            else:
                block.mlp.c_proj.weight.zero_()
                block.mlp.c_proj.bias.zero_()
    cam.final_linear.weight.zero_()
