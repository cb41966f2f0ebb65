"""One training step and one evaluation step, the counterparts of
``make_step_fns``'s ``train_step``, ``accum_train_step`` and ``eval_step``
(``vtc_tpu/training/trainer.py:110-352``).

``train_step`` runs the model in training mode, the loss, the backward
through the kernels' ``autograd.Function``s, the optimizer and the
scheduler, and clears the gradients. Mixed precision is the JAX package's:
activations in the model's ``dtype``, the weights fp32 masters that each
layer casts at use, so the train path never calls ``convert_weights``. The
CAM's BatchNorm running stats update inside the forward. uint8 frames are
normalized on their device first (``normalize_uint8_images``), as JAX's
``_apply`` does; the uint8 patch input passes through.

With ``accum_steps = k > 1`` the step is the exact GradCache accumulation
of ``accum_train_step`` (``trainer.py:254-339``): the loss is that of the
whole batch, from its similarity ``exp(logit_scale)·v@tᵀ`` over the
features of all ``k`` microbatches, while activation memory is one
microbatch's. Two passes: the microbatches are encoded without a graph; the
loss's gradient is taken with respect to the concatenated features and
``logit_scale``; then each microbatch is encoded again with its graph and
its slice of the feature gradient is propagated. ``logit_scale`` takes its
gradient from the loss alone. Microbatch ``i`` holds rows ``i, i+k, …``
(JAX's strided split); the features go back to batch order before the loss.

A model with mixture-of-experts layers (``parallel.expert.MoEMLP``, the
MoE adapter) adds ``moe_aux_loss_weight`` times its layers' summed
load-balance losses to the loss (``trainer.py:204-226``); the accumulating
step adds the mean over the microbatches of each microbatch's sum
(``:289-316``), each counted once: the loss's value from the first pass, its
gradient through the second, which routes the microbatch exactly as the
first did. A model with BatchNorm running stats (the ``sub_mean``/``bn``
residual activations, the audio MLP) is refused by the accumulating step.

Not ported: multihost token truncation (raises).
"""

from __future__ import annotations

import inspect
from typing import Callable, Optional, Sequence

import torch

from ..data.preprocess import normalize_uint8_images
from ..data.tokenizer import truncate_batch_tokens
from ..parallel.expert import moe_layers

# the Switch default, as the JAX trainer's ``moe_aux_loss_weight``
MOE_AUX_LOSS_WEIGHT = 0.01


def global_truncate_tokens(data: Sequence, multihost: bool = False) -> list:
    """EOT-bucket truncation of the batch's token arrays, one bucket for
    all (``trainer.py:58-80``). Single host only: a multihost run buckets on
    the allgathered coverage, which waits for the port of
    ``torch.distributed``."""
    if multihost:
        raise NotImplementedError(
            "multihost token truncation needs the allgather of the coverage "
            "(ROADMAP: Queue 1, distribution on torch.distributed)"
        )
    return truncate_batch_tokens(data)


def _forward(model, args, **kwargs):
    """``(model(*args, **kwargs), aux)``: ``aux`` is the sum of the MoE
    layers' load-balance losses of this call, None for a dense model."""
    layers = moe_layers(model)
    for layer in layers:
        layer.aux_loss = None
    out = model(*args, **kwargs)
    aux = [layer.aux_loss for layer in layers if layer.aux_loss is not None]
    for layer in layers:
        layer.aux_loss = None
    return out, (sum(aux) if aux else None)


def _update(optimizer, scheduler) -> None:
    optimizer.step()
    scheduler.step()
    optimizer.zero_grad(set_to_none=True)


def train_step(model: torch.nn.Module, criterion: Callable, optimizer,
               scheduler, data: Sequence[torch.Tensor], meta=None,
               generator: Optional[torch.Generator] = None,
               draws=None, accum_steps: int = 1,
               moe_aux_loss_weight: float = MOE_AUX_LOSS_WEIGHT):
    """One step on ``data`` (the model's positional inputs, on its device).
    The CAM models draw their random masks from ``generator`` (on the
    model's device), or take them as ``draws``: a dict for the batch, or
    with ``accum_steps > 1`` one dict per microbatch. A MoE model's
    load-balance losses join the loss at ``moe_aux_loss_weight``. Returns
    ``(loss, out)``: the loss before the update, detached, and the model's
    output (with ``accum_steps > 1``, the features and similarity of the
    whole batch)."""
    data = [normalize_uint8_images(d) for d in data]
    if accum_steps > 1:
        return _accumulating_step(model, criterion, optimizer, scheduler, data,
                                  meta, generator, draws, int(accum_steps),
                                  moe_aux_loss_weight)
    model.train()
    out, aux = _forward(model, data, generator=generator, draws=draws)
    loss = criterion(out, meta)
    if aux is not None:
        loss = loss + moe_aux_loss_weight * aux
    loss.backward()
    _update(optimizer, scheduler)
    return loss.detach(), out


def _logit_scale(model: torch.nn.Module) -> torch.Tensor:
    """The contrastive temperature, which the CLIP-family models keep on
    the CLIP tower (``trainer.py:95-107``)."""
    scale = getattr(getattr(model, "model", None), "logit_scale", None)
    if scale is None:
        raise ValueError(
            "accum_steps > 1 needs a contrastive model with a logit_scale "
            "param (the CLIP retrieval families); this model has none"
        )
    return scale


def _accumulating_step(model, criterion, optimizer, scheduler, data, meta,
                       generator, draws, k: int, aux_weight: float):
    if any(d.shape[0] % k for d in data):
        raise ValueError(
            f"accum_steps={k} must divide the batch ({[d.shape[0] for d in data]})"
        )
    if any(name.endswith("running_mean") for name, _ in model.named_buffers()):
        # per-microbatch statistics and k momentum updates per step are not
        # the large batch's semantics: refuse rather than deviate
        raise ValueError(
            "accum_steps > 1 is not supported for models with BatchNorm "
            "running stats: per-microbatch statistics change the training "
            "semantics"
        )
    scale = _logit_scale(model)
    model.train()
    mbs = [[d[i::k] for d in data] for i in range(k)]
    if draws is None:
        # drawn once, so that both passes see the same masks
        draw = getattr(model, "training_draws", None)
        draws = [draw(*mb, generator=generator) if draw else {} for mb in mbs]
    if len(draws) != k:
        raise ValueError(f"accum_steps={k} needs one dict of draws per microbatch, "
                         f"got {len(draws)}")

    def unsplit(parts):  # microbatch i, row j -> batch row j·k + i
        return torch.stack(parts, 1).flatten(0, 1)

    with torch.no_grad():
        outs = [_forward(model, mb, draws=d) for mb, d in zip(mbs, draws)]
    feats_vis = unsplit([o[0][0] for o in outs]).requires_grad_()
    feats_text = unsplit([o[0][1] for o in outs]).requires_grad_()
    sim = torch.exp(scale) * (feats_vis @ feats_text.T)
    loss = criterion((feats_vis, feats_text, sim), meta)
    loss.backward()
    auxes = [aux for _, aux in outs if aux is not None]
    if auxes:  # the mean over the microbatches, its gradient in the second pass
        loss = loss + aux_weight * torch.stack(auxes).mean()
    for i, (mb, d) in enumerate(zip(mbs, draws)):
        out, aux = _forward(model, mb, draws=d)
        pairs = [(f, full.grad[i::k]) for f, full in
                 zip(out[:2], (feats_vis, feats_text)) if f.requires_grad]
        if aux is not None and aux.requires_grad:
            pairs.append((aux, torch.full_like(aux, aux_weight / k)))
        if pairs:
            torch.autograd.backward(*zip(*pairs))
    _update(optimizer, scheduler)
    return loss.detach(), (feats_vis.detach(), feats_text.detach(), sim.detach())


def eval_step(model: torch.nn.Module, criterion: Callable, data, meta=None,
              branch_override: Optional[str] = None):
    """The model in eval mode without a graph, and the loss: ``(loss,
    out)``. ``branch_override`` reaches the models that take it."""
    model.eval()
    kwargs = {}
    if branch_override is not None and (
            "branch_override" in inspect.signature(model.forward).parameters):
        kwargs["branch_override"] = branch_override
    with torch.no_grad():
        out = model(*[normalize_uint8_images(d) for d in data], **kwargs)
        return criterion(out, meta), out
