"""One training step, the counterpart of ``make_step_fns``'s ``train_step``
(``vtc_tpu/training/trainer.py:110-252``).

``train_step`` runs the model in training mode, the loss, the backward
through the kernels' ``autograd.Function``s, the optimizer and the
scheduler, and clears the gradients. Mixed precision is the JAX package's:
activations in the model's ``dtype``, the weights fp32 masters that each
layer casts at use, so the train path never calls ``convert_weights``. The
CAM's BatchNorm running stats update inside the forward.

Not yet ported: ``accum_steps > 1`` (the exact GradCache accumulation) and
multihost token truncation; both raise.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..data.tokenizer import truncate_batch_tokens


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


def train_step(model: torch.nn.Module, criterion: Callable, optimizer,
               scheduler, data: Sequence[torch.Tensor], meta=None,
               generator: Optional[torch.Generator] = None,
               draws: Optional[dict] = None, accum_steps: int = 1):
    """One step on ``data`` (the model's positional inputs, on its device).
    The CAM models draw their random masks from ``generator`` (on the
    model's device), or take them as ``draws``. Returns ``(loss, out)``:
    the loss before the update, detached, and the model's output."""
    if accum_steps > 1:
        raise NotImplementedError(
            "accum_steps > 1 (exact GradCache accumulation) is not ported yet "
            "(ROADMAP: Queue 1)"
        )
    model.train()
    out = model(*data, generator=generator, draws=draws)
    loss = criterion(out, meta)
    loss.backward()
    optimizer.step()
    scheduler.step()
    optimizer.zero_grad(set_to_none=True)
    return loss.detach(), out
