"""GPipe over a block stack on the ``pipe`` axis, the port of
``vtc_tpu/parallel/pipeline.py`` on ``torch.distributed``, one process per
card.

``create_pipeline_mesh(n_data, n_pipe)`` lays the group out as a
``("data", "pipe")`` ``DeviceMesh``, rank ``d·n_pipe + s`` at ``(d, s)``.
``pipeline_blocks`` runs ``L`` blocks on ``S`` stage ranks:

* stage ``s`` runs blocks ``s·L/S … (s+1)·L/S - 1``;
* the rank's batch splits into ``n_micro`` contiguous microbatches, which
  stream through the stages: stage ``s`` takes microbatch ``m`` from stage
  ``s - 1`` (stage 0 from its input), runs its blocks and sends the result to
  stage ``s + 1``. A blocking receive orders the work, so stage ``s`` runs
  microbatch ``m`` at tick ``s + m`` of ``vtc_tpu``'s ``n_micro + S - 1``
  ticks, and idles where the JAX schedule computes its bubble on throwaway
  data;
* the last stage's outputs reach every rank of the pipe group (a broadcast,
  ``vtc_tpu``'s ``psum`` of ``:149-152``).

The backward runs the shifts in reverse: the last stage takes the gradient
of its microbatches, every stage runs its blocks' backward on its saved
graph of each microbatch, last first, and sends the input's gradient to
stage ``s - 1``; stage 0's gradient of the input reaches every stage, whose
replicated computation before the stack then takes the same gradient. The
blocks' parameter gradients accumulate on their own stage only (inside the
schedule's backward), so DDP, which must see every gradient in its own
graph, does not wrap a model on a pipe mesh; ``sync_gradients`` sums each
pipelined block's gradient over the pipe group, which makes it whole on
every stage, and averages every gradient over the data group as DDP does.
``torch.autograd.grad`` through a pipelined stack would get no block
gradient: the train step takes them with ``backward``.

``vtc_tpu`` keeps every parameter replicated on a pipe mesh
(``tree_shardings``), and so does the port: each rank holds the whole model
and ``.pth`` checkpoints need no gathering. The point-to-point messages go
through the host where the backend is gloo and the tensor is on a card:
gloo's send and receive abort on CUDA tensors (its collectives take them),
NCCL takes them on the card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import (
    PIPE_AXIS,
    _make_mesh,
    axis_group,
    axis_rank,
    axis_world,
    data_group,
    data_world,
)
from .tensor import ModelAxis


def create_pipeline_mesh(n_data=None, n_pipe: int = 1, *, device):
    """The process group as a ``("data", "pipe")`` ``DeviceMesh`` of
    ``n_data × n_pipe`` ranks, rank ``d·n_pipe + s`` at ``(d, s)``, kept as
    the current mesh (``parallel.mesh``); None for one process."""
    return _make_mesh(n_data, n_pipe, PIPE_AXIS, device)


def pipe_axis(mesh=None) -> ModelAxis:
    """This rank's place on the pipe axis of ``mesh`` (default: the current
    mesh; without a pipe axis, this rank alone)."""
    if mesh is None:
        return ModelAxis(axis_group(PIPE_AXIS), axis_rank(PIPE_AXIS), axis_world(PIPE_AXIS))
    group = mesh.get_group(PIPE_AXIS)
    return ModelAxis(group, dist.get_rank(group), dist.get_world_size(group))


def _via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _peer(axis: ModelAxis, stage: int) -> int:
    return dist.get_global_rank(axis.group, stage)


def _send(t: torch.Tensor, axis: ModelAxis, stage: int) -> None:
    t = t.detach().contiguous()
    dist.send(t.cpu() if _via_host(t, axis.group) else t, _peer(axis, stage), group=axis.group)


def _recv(like: torch.Tensor, axis: ModelAxis, stage: int) -> torch.Tensor:
    host = _via_host(like, axis.group)
    buf = torch.empty(like.shape, dtype=like.dtype, device="cpu" if host else like.device)
    dist.recv(buf, _peer(axis, stage), group=axis.group)
    return buf.to(like.device) if host else buf


def _broadcast(t: torch.Tensor, axis: ModelAxis, stage: int) -> torch.Tensor:
    buf = t.detach().contiguous()
    dist.broadcast(buf, _peer(axis, stage), group=axis.group)
    return buf


def _run(stage_fn, x: torch.Tensor, n_micro: int, axis: ModelAxis, graph: bool):
    """The forward schedule on this stage: the stack's output (on every
    stage) and, with ``graph``, each microbatch's ``(input, output)`` with
    its graph."""
    s, last = axis.rank, axis.size - 1
    micro = x.detach().chunk(n_micro)
    saved, outs = [], []
    for m in range(n_micro):
        h = micro[m] if s == 0 else _recv(micro[m], axis, s - 1)
        if graph:
            h = h.requires_grad_()
        with torch.enable_grad() if graph else torch.no_grad():
            y = stage_fn(h)
        if s < last:
            _send(y, axis, s + 1)
        else:
            outs.append(y.detach())
        if graph:
            saved.append((h, y))
    out = torch.cat(outs) if s == last else torch.empty_like(x)
    return _broadcast(out, axis, last), saved


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, x, *params):
        stage_fn, n_micro, axis = plan
        out, ctx.saved = _run(stage_fn, x, n_micro, axis, graph=True)
        ctx.axis, ctx.n_micro = axis, n_micro
        return out

    @staticmethod
    def backward(ctx, grad):
        axis, saved = ctx.axis, ctx.saved
        s, last = axis.rank, axis.size - 1
        grads = grad.contiguous().chunk(ctx.n_micro)
        to_x = [None] * ctx.n_micro
        for m in reversed(range(ctx.n_micro)):
            h, y = saved[m]
            g = grads[m] if s == last else _recv(y, axis, s + 1)
            torch.autograd.backward(y, g)
            if s > 0:
                _send(h.grad, axis, s - 1)
            else:
                to_x[m] = h.grad
        ctx.saved = None
        gx = torch.cat(to_x) if s == 0 else torch.empty_like(grad)
        gx = _broadcast(gx, axis, 0) if ctx.needs_input_grad[1] else None
        return (None, gx) + (None,) * (len(ctx.needs_input_grad) - 2)


def pipeline_blocks(blocks, x: torch.Tensor, *args, n_micro: int, axis: ModelAxis):
    """``blocks`` (the ``L`` blocks of a stack, each called ``block(h,
    *args)`` through ``layers.run_block``) on ``x`` [B, ...] as a GPipe
    microbatch pipeline over ``axis``'s ``S`` stages (the module
    docstring). ``L`` must divide over the stages and ``B`` into
    ``n_micro``. Every stage returns the stack's output."""
    from ..models.layers import run_block

    n_layers, n_stages = len(blocks), axis.size
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not divide over {n_stages} pipeline stages")
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} does not divide into {n_micro} microbatches")
    per = n_layers // n_stages
    mine = list(blocks)[axis.rank * per:(axis.rank + 1) * per]

    def stage_fn(h):
        for block in mine:
            h = run_block(block, h, *args)
        return h

    params = [p for block in blocks for p in block.parameters() if p.requires_grad]
    if torch.is_grad_enabled() and (x.requires_grad or params):
        return _Pipeline.apply((stage_fn, n_micro, axis), x, *params)
    return _run(stage_fn, x, n_micro, axis, graph=False)[0]


def _all_reduce(tensors, group) -> None:
    """Sum ``tensors`` over ``group`` in place, as one flat buffer."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def sync_gradients(model: torch.nn.Module) -> None:
    """The gradients of a model on a pipe mesh made the one device's (the
    module docstring): each pipelined stack's block gradients summed over
    the pipe group (a stage that ran none of a block holds zeros for it),
    then every gradient averaged over the data group. A parameter without a
    gradient keeps none."""
    axis = pipe_axis()
    if axis.size > 1:
        blocks = [p for m in model.modules() if getattr(m, "pipelined", False)
                  for p in m.resblocks.parameters() if p.requires_grad]
        for p in blocks:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        _all_reduce([p.grad for p in blocks], axis.group)
    if data_world() > 1:
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        _all_reduce(grads, data_group())
        for g in grads:
            g.div_(data_world())
