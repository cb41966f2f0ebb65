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

**Data parallelism.** Under a process group (``torchrun``, one process per
card) ``model`` is ``parallel.mesh.data_parallel``'s
``DistributedDataParallel``, or a model that ``parallel.mesh.fully_shard_model``
sharded (ZeRO-3: FSDP2 takes DDP's place and its gradients are the same
mean), and ``data`` this rank's rows of the global batch
(``parallel.mesh.shard_batch``). The step is the single-device step
at the global batch, as GSPMD runs ``vtc_tpu``'s:

* the features are gathered over the ranks (``all_gather_rows``) and every
  rank computes the loss of all ``W·b`` pairs from them, with the
  similarity of the model's ``_sim``; the gather's backward sums over the
  ranks, DDP averages, and the product is the single-device gradient;
* the random draws are drawn for the global batch from the one generator
  state every rank holds (or handed in for the global batch) and each rank
  takes its rows, so a sample's draw does not depend on ``W``;
* the BatchNorms take the global batch's statistics (``models.cam``,
  ``models.layers.TorchBatchNorm``);
* with ``accum_steps`` k each rank splits its rows with the same strided
  rule, the features of every rank are gathered for the loss, and this
  rank's rows of the feature gradient, times ``W``, drive its second pass;
  the microbatches before the last do not synchronize (DDP's ``no_sync``,
  FSDP2's ``set_requires_gradient_sync(False)``: ``no_gradient_sync``);
* a MoE model routes over the global token set, as GSPMD traces
  ``vtc_tpu``'s layer on the global batch (capacity ``ceil(cf·k·T/nE)``
  with T global, ``vtc_tpu/parallel/expert.py:133``): the steps run their
  forwards inside ``parallel.expert.global_routing``, where each MoE layer
  gathers the router probabilities over the data group and sums the
  dispatched tokens over it (with ``accum_steps`` k, microbatch i's global
  tokens, in ``make_step_fns``' order), and on the expert axis runs its
  rank's experts (``parallel.expert``);
* on a pipe mesh (``parallel.pipeline``, ``train.py --pp``) the model is
  not wrapped: each stage's block gradients accumulate inside the
  schedule's backward, and ``parallel.pipeline.sync_gradients`` sums them
  over the stages and averages every gradient over the data ranks before
  the update.

``global_truncate_tokens(multihost=True)`` buckets on the largest coverage
over the ranks, so every rank runs the same text lengths.
"""

from __future__ import annotations

import contextlib
import inspect
from typing import Callable, Optional, Sequence

import torch

from ..data.preprocess import normalize_uint8_images
from ..data.tokenizer import batch_token_need, truncate_batch_tokens
from ..device import DISTRIBUTION
from ..parallel.expert import global_routing, moe_layers
from ..parallel.mesh import (
    PIPE_AXIS,
    active,
    all_gather_rows,
    axis_world,
    data_world,
    no_gradient_sync,
    shard_rows,
    unwrap,
)
from ..utils.util import all_max

# the Switch default, as the JAX trainer's ``moe_aux_loss_weight``
MOE_AUX_LOSS_WEIGHT = 0.01
# each draw's batch axis, to take a rank's rows of the global batch's draws
DRAW_BATCH_AXES = {"adapter_skip": 0, "comment_mask": 1, "dropout": 1}


def global_truncate_tokens(data: Sequence, multihost: bool = False) -> list:
    """EOT-bucket truncation of the batch's token arrays, one bucket for
    all (``trainer.py:58-80``). ``multihost``: the bucket of the largest
    coverage over the process group's ranks (one all-reduce of an int), so
    every rank runs the same lengths."""
    if not multihost:
        return truncate_batch_tokens(data)
    need = batch_token_need(data)
    if need is None:
        return list(data)
    return truncate_batch_tokens(data, need=all_max(need))


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


def _update(model, optimizer, scheduler) -> None:
    if active() and axis_world(PIPE_AXIS) > 1:
        from ..parallel.pipeline import sync_gradients

        sync_gradients(unwrap(model))
    optimizer.step()
    scheduler.step()
    optimizer.zero_grad(set_to_none=True)


def _check_data_parallel(module) -> None:
    if not hasattr(module, "_sim"):
        raise NotImplementedError(
            f"{type(module).__name__} under a process group: the data-parallel step "
            f"takes the contrastive models, whose output is (feats_a, feats_b, sim) "
            f"with a _sim of the gathered features ({DISTRIBUTION})")


def _rank_draws(module, data, generator, draws):
    """This rank's rows of the draws of the global batch: ``draws`` as handed
    in for it, else drawn from ``generator`` with the global batch's shapes
    (``data`` are this rank's rows)."""
    if draws is None:
        draw = getattr(module, "training_draws", None)
        if draw is None:
            return None
        shapes = [d[:1].expand((d.shape[0] * data_world(),) + d.shape[1:]) for d in data]
        draws = draw(*shapes, generator=generator)
    return {name: v[(slice(None),) * DRAW_BATCH_AXES[name]
                    + (shard_rows(v.shape[DRAW_BATCH_AXES[name]]),)]
            for name, v in draws.items()}


def _global_meta(meta, b: int):
    """The meta's per-row tensors (``b`` rows) gathered over the data ranks."""
    if data_world() == 1 or not isinstance(meta, dict):
        return meta
    return {k: all_gather_rows(v) if torch.is_tensor(v) and v.dim() and v.shape[0] == b
            else v for k, v in meta.items()}


def _global(module, out, meta):
    """The output and meta of the global batch: each data rank's features
    gathered, the similarity of all pairs from them (the model's
    ``_sim``), the meta's per-row tensors gathered. One data rank: as
    given."""
    if data_world() == 1:
        return out, meta
    feats = [all_gather_rows(f) for f in out[:2]]
    return (*feats, module._sim(*feats)), _global_meta(meta, out[0].shape[0])


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
    whole batch).

    Under a process group ``model`` is the DDP wrapper, ``data`` this rank's
    rows, ``draws`` (if given) those of the global batch (with
    ``accum_steps`` k: of its k strided microbatches), and ``out`` that of
    the global batch."""
    data = [normalize_uint8_images(d) for d in data]
    if active():
        _check_data_parallel(unwrap(model))
    with global_routing(active()):
        if accum_steps > 1:
            return _accumulating_step(model, criterion, optimizer, scheduler, data,
                                      meta, generator, draws, int(accum_steps),
                                      moe_aux_loss_weight)
        return _plain_step(model, criterion, optimizer, scheduler, data, meta,
                           generator, draws, moe_aux_loss_weight)


def _plain_step(model, criterion, optimizer, scheduler, data, meta, generator, draws,
                moe_aux_loss_weight):
    module = unwrap(model)
    module.train()
    if active():
        draws = _rank_draws(module, data, generator, draws)
    out, aux = _forward(model, data, generator=generator, draws=draws)
    if active():
        out, meta = _global(module, out, meta)
    loss = criterion(out, meta)
    if aux is not None:
        loss = loss + moe_aux_loss_weight * aux
    loss.backward()
    _update(model, optimizer, scheduler)
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
    module = unwrap(model)
    if any(d.shape[0] % k for d in data):
        raise ValueError(
            f"accum_steps={k} must divide the batch ({[d.shape[0] for d in data]})"
        )
    if any(name.endswith("running_mean") for name, _ in module.named_buffers()):
        # per-microbatch statistics and k momentum updates per step are not
        # the large batch's semantics: refuse rather than deviate
        raise ValueError(
            "accum_steps > 1 is not supported for models with BatchNorm "
            "running stats: per-microbatch statistics change the training "
            "semantics"
        )
    module.train()
    mbs = [[d[i::k] for d in data] for i in range(k)]
    if active():
        # microbatch i of this rank is its part of the global microbatch i
        draws = [_rank_draws(module, mb, generator, None if draws is None else draws[i])
                 for i, mb in enumerate(mbs)]
    elif draws is None:
        # drawn once, so that both passes see the same masks
        draw = getattr(module, "training_draws", None)
        draws = [draw(*mb, generator=generator) if draw else {} for mb in mbs]
    if len(draws) != k:
        raise ValueError(f"accum_steps={k} needs one dict of draws per microbatch, "
                         f"got {len(draws)}")

    def unsplit(parts):  # microbatch i, row j -> batch row j·k + i
        return torch.stack(parts, 1).flatten(0, 1)

    with torch.no_grad():
        outs = [_forward(model, mb, draws=d) for mb, d in zip(mbs, draws)]
        feats = [unsplit([o[0][j] for o in outs]) for j in (0, 1)]
        if active():
            meta = _global_meta(meta, feats[0].shape[0])
            feats = [all_gather_rows(f) for f in feats]
    # read after a forward: a sharded model's root then holds it whole
    scale = _logit_scale(module)
    feats_vis, feats_text = (f.requires_grad_() for f in feats)
    sim = torch.exp(scale) * (feats_vis @ feats_text.T)
    loss = criterion((feats_vis, feats_text, sim), meta)
    scale_grad = None
    if active():
        # no gradient may reach a parameter outside DDP's synchronized pass:
        # logit_scale's joins the last microbatch's backward; this rank's rows
        # of the feature gradient carry W, which DDP's mean takes back
        wanted = [feats_vis, feats_text] + ([scale] if scale.requires_grad else [])
        grads = torch.autograd.grad(loss, wanted)
        rows = shard_rows(feats_vis.shape[0])
        feat_grads = [g[rows] * data_world() for g in grads[:2]]
        scale_grad = grads[2] if scale.requires_grad else None
    else:
        loss.backward()
        feat_grads = [feats_vis.grad, feats_text.grad]
    auxes = [aux for _, aux in outs if aux is not None]
    if auxes:  # the mean over the microbatches, its gradient in the second pass
        loss = loss + aux_weight * torch.stack(auxes).mean()
    for i, (mb, d) in enumerate(zip(mbs, draws)):
        last = i == k - 1
        with contextlib.nullcontext() if last else no_gradient_sync(model):
            out, aux = _forward(model, mb, draws=d)
            pairs = [(f, full[i::k]) for f, full in zip(out[:2], feat_grads)
                     if f.requires_grad]
            if aux is not None and aux.requires_grad:
                pairs.append((aux, torch.full_like(aux, aux_weight / k)))
            if last and scale_grad is not None:
                pairs.append((scale, scale_grad))
            if pairs:
                torch.autograd.backward(*zip(*pairs))
    _update(model, optimizer, scheduler)
    return loss.detach(), (feats_vis.detach(), feats_text.detach(), sim.detach())


def eval_step(model: torch.nn.Module, criterion: Callable, data, meta=None,
              branch_override: Optional[str] = None):
    """The model in eval mode without a graph, and the loss: ``(loss,
    out)``. ``branch_override`` reaches the models that take it. Under a
    process group of more than one rank ``data`` is this rank's rows, and
    the loss and ``out`` are the global batch's (the features gathered)."""
    model = unwrap(model)
    model.eval()
    kwargs = {}
    if branch_override is not None and (
            "branch_override" in inspect.signature(model.forward).parameters):
        kwargs["branch_override"] = branch_override
    with torch.no_grad(), global_routing(active()):
        out = model(*[normalize_uint8_images(d) for d in data], **kwargs)
        if active():
            out, meta = _global(model, out, meta)
        return criterion(out, meta), out
