"""Loss functions, the port of ``vtc_tpu/ops/losses.py`` (reference
``model/loss.py:1-22``).

``clip_loss`` is the symmetric InfoNCE over the in-batch similarity matrix:
cross-entropy against the diagonal in both directions, in fp32 whatever the
model's dtype. Each loss takes the model's output and the batch's ``meta``
dict, as the trainer calls them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _softmax_xent(logits, labels):
    return F.cross_entropy(logits.float(), labels)


def clip_loss(output, meta=None):
    """Symmetric InfoNCE. ``output`` is the model's (feats_a, feats_b, sim)."""
    sim = output[2]
    labels = torch.arange(sim.shape[0], device=sim.device)
    return 0.5 * (_softmax_xent(sim, labels) + _softmax_xent(sim.T, labels))


def _last(output):
    return output[-1] if isinstance(output, (tuple, list)) else output


def cross_entropy(output, meta):
    logits = _last(output)
    return _softmax_xent(
        logits, torch.as_tensor(meta["target"], device=logits.device).long()
    )


def binary_cross_entropy(output, meta):
    """BCE with logits in its stable form, ``max(z, 0) − z·t + log1p(e^−|z|)``."""
    logits = _last(output).float()
    target = torch.as_tensor(meta["target"], device=logits.device)
    target = target.reshape(logits.shape).float()
    loss = (torch.clamp(logits, min=0) - logits * target
            + torch.log1p(torch.exp(-logits.abs())))
    return loss.mean()


def mse_loss(output, meta, reduction="mean"):
    pred = output[0] if isinstance(output, (tuple, list)) else output
    err = (pred - torch.as_tensor(meta["target"], device=pred.device)) ** 2
    return err.mean() if reduction == "mean" else err.sum()


LOSSES = {
    "clip_loss": clip_loss,
    "cross_entropy": cross_entropy,
    "binary_cross_entropy": binary_cross_entropy,
    "mse_loss": mse_loss,
}
