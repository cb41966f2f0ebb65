"""A mixture-of-experts MLP, on one device, over the data axis and over the
expert axis.

Port of ``vtc_tpu/parallel/expert.py``. The math is the JAX package's,
GShard/Switch dispatch:

* the router in fp32: ``probs = softmax(x @ router)``;
* top-k experts per token, ties broken by the lower index as
  ``jax.lax.top_k`` breaks them (a stable descending sort), with the gates
  renormalized over the k selected;
* capacity ``ceil(cf · k · T / nE)`` over the ``T`` tokens routed; slot
  ``s`` of every token queues after all slot ``< s`` assignments, in token
  order, and a token whose queue position reaches the capacity is dropped
  (its output is zero);
* each expert's FFN ``E -> 4E -> QuickGELU -> E`` as batched products on the
  dispatched ``[nE, C, E]``;
* the load-balance loss ``nE · Σ_e f_e · P_e`` (``f``: the share of tokens
  whose first choice is ``e``; ``P``: the mean router probability), kept in
  ``aux_loss`` after each call for the train step to add.

The JAX package dispatches and combines with one-hot products; here they are
an index scatter and gather, which select the same entries: in fp32 a one-hot
product adds exact zeros to the one term it selects.

**Global routing.** ``vtc_tpu`` traces the layer on the global batch under
GSPMD, so T is the global token count, a slot's queue position a cumsum over
the global token order and the aux loss a mean over all tokens. Inside
``global_routing()`` (the train and eval steps under a process group: every
data rank runs the same forwards on its rows of one global batch) the layer
does the same over the data group:

* each rank's fp32 router probabilities are gathered in data-rank order
  (``all_gather_rows``), which is the global token order: data rank ``r``
  holds rows ``r·B/W …`` and a token's index is sample-major;
* every rank routes the global probabilities alike: the same capacity,
  queue positions, keeps and aux loss;
* each rank writes its own tokens into the ``[nE, C, E]`` dispatch buffer,
  which is summed over the data group: exact, since each slot has one
  nonzero contributor, so the buffer is the one device's bit for bit;
* each rank runs the experts and combines its own tokens.

The collectives are autograd functions with the data axis's convention
(``parallel.mesh``): the gather of the probabilities sums their gradient
over the data ranks (the aux loss is every rank's); the buffer's sum has
the identity backward, since a rank's combine reaches only its own tokens'
slots, whose gradient is therefore this rank's alone. Each rank's gradients
are then ``W`` times its rows' share and DDP's (or FSDP2's) mean makes them
the one device's.

**The expert axis** (``create_ep_mesh``, ``train.py --ep X``), the layout
GSPMD gives ``vtc_tpu``'s ``P("expert")`` constraints: tokens split over
data, the dispatched buffer over expert. ``shard_experts`` keeps on expert
rank ``x`` the experts ``x·nE/X … (x+1)·nE/X - 1`` of exactly the leaves
``moe_pspec`` names (``w_fc``, ``bias_fc``, ``w_proj``, ``bias_proj``), so an
optimizer built after holds their Adam moments at the same share; the router
and every other leaf stay whole. The forward routes globally as above, fills
this rank's experts' slots from its tokens and sums them over the data
group, runs the local FFNs, gathers the ``[nE, C, E]`` outputs over the
expert group (backward: this rank's slice of the gradient) and combines its
own tokens. Only the rank that holds a token's expert computes that slot's
input gradient, so the tokens enter the dispatch through ``_CopyToModel``
over the expert group (identity forward, summed backward). The buffer of
an expert place stays whole on every data place, as GSPMD leaves a
``P("expert")`` tensor replicated over data, so each expert rank needs every
data rank's slots of its experts: a sum over the data group, then an
all-gather over the expert group. An all-to-all would move fewer bytes only
in a layout that splits the slots over data too. Gloo takes all four on
CUDA tensors (all-reduce, all-gather, broadcast and all-to-all, on an H100;
its send and receive abort on them). Outside ``global_routing()`` a split
layer needs its experts whole: ``gathered_experts`` (entered by
``parallel.mesh.gathered_parameters``) gathers them for forwards without a
graph, where each call routes its own tokens, as a process of ``vtc_tpu``'s
strided evaluation routes its own batch.

**ZeRO-3 beside the expert axis** (``--fsdp 1 --ep X``): ``vtc_tpu``'s
``tree_shardings(..., fsdp=True)`` shards every leaf over data but lets
``moe_pspec`` override the expert stacks' spec with ``P("expert")``. So
``parallel.mesh.fully_shard_model`` hands FSDP2 every parameter but the
split stacks (``split_stacks``), which stay whole over the data group, and
the step averages their gradients over it (``sync_expert_gradients``), as
DDP does without ZeRO-3. The optimizer steps the local shards and the
stacks alike; checkpoints gather both (``parallel.tensor``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..models.layers import quick_gelu
from .mesh import (
    EXPERT_AXIS,
    _make_mesh,
    all_gather_rows,
    axis_group,
    axis_rank,
    axis_world,
    data_group,
    data_world,
    shard_rows,
)
from .tensor import ModelAxis, _CopyToModel, _ReduceFromModel, own_part

# the expert-stacked leaves, named alike wherever a MoE layer sits (the dense
# MLP's are c_fc/c_proj): vtc_tpu's moe_pspec
EXPERT_LEAVES = ("w_fc", "bias_fc", "w_proj", "bias_proj")
_GLOBAL = False  # inside global_routing()


def create_ep_mesh(n_data=None, n_expert: int = 1, *, device):
    """The process group as a ``("data", "expert")`` ``DeviceMesh`` of
    ``n_data × n_expert`` ranks, rank ``d·n_expert + x`` at ``(d, x)``, kept
    as the current mesh (``parallel.mesh``); None for one process."""
    return _make_mesh(n_data, n_expert, EXPERT_AXIS, device)


def moe_pspec(name: str) -> Optional[str]:
    """The axis an expert-stacked parameter (or its moment) splits its
    leading ``nE`` dim over, ``"expert"``, or None for any other."""
    return EXPERT_AXIS if name.rsplit(".", 1)[-1] in EXPERT_LEAVES else None


def moe_shardings(model: nn.Module) -> Dict[str, Optional[str]]:
    """``moe_pspec`` of each of ``model``'s parameters."""
    return {name: moe_pspec(name) for name, _ in model.named_parameters()}


def expert_axis(model: nn.Module) -> Optional[ModelAxis]:
    """The axis ``shard_experts`` split ``model`` over, or None."""
    return getattr(model, "ep_axis", None)


@contextlib.contextmanager
def global_routing(on: bool = True):
    """Within the block the MoE layers route over the data group's tokens
    (every data rank must run the same forwards on its rows of one global
    batch, as the train and eval steps do)."""
    global _GLOBAL
    before, _GLOBAL = _GLOBAL, bool(on)
    try:
        yield
    finally:
        _GLOBAL = before


def route(probs: torch.Tensor, top_k: int, capacity: int):
    """Routing of ``probs`` [T, nE] -> ``(idx, gates, pos, keep)``, each
    [T, k]: the experts in descending probability (ties to the lower
    index), the renormalized gates, each assignment's queue position in its
    expert and whether it is within ``capacity``."""
    n_exp = probs.shape[-1]
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :top_k], idx[:, :top_k]
    gates = gates / gates.sum(dim=-1, keepdim=True)
    counts = torch.zeros(n_exp, dtype=torch.long, device=probs.device)
    pos = []
    for s in range(top_k):
        one_hot = nn.functional.one_hot(idx[:, s], n_exp)  # [T, nE]
        queue = torch.cumsum(one_hot, dim=0) - 1 + counts
        counts = counts + one_hot.sum(dim=0)
        pos.append(torch.gather(queue, 1, idx[:, s:s + 1])[:, 0])
    pos = torch.stack(pos, dim=1)
    return idx, gates, pos, pos < capacity


class _GatherExperts(torch.autograd.Function):
    """Each expert rank's ``[nE/X, C, E]`` concatenated in rank order; the
    backward keeps this rank's slice (every rank combines from the same
    gathered outputs)."""

    @staticmethod
    def forward(ctx, x, axis):
        parts = [torch.empty_like(x) for _ in range(axis.size)]
        dist.all_gather(parts, x.contiguous(), group=axis.group)
        ctx.rows = slice(axis.rank * x.shape[0], (axis.rank + 1) * x.shape[0])
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rows], None


class MoEMLP(nn.Module):
    """Drop-in mixture-of-experts replacement for ``layers.MLPBlock``:
    ``n_experts`` FFNs of ``MLPBlock``'s shape, ``top_k`` per token.
    Parameters: ``router`` [E, nE], ``w_fc`` [nE, E, 4E], ``bias_fc``
    [nE, 4E], ``w_proj`` [nE, 4E, E], ``bias_proj`` [nE, E] (the JAX
    package's layout; on the expert axis, this rank's ``nE/X`` of each
    stack). After each call ``aux_loss`` holds the load-balance loss and
    ``routing`` the ``(idx, pos, keep)`` of every token routed (the global
    ones under ``global_routing``)."""

    ep: Optional[ModelAxis] = None  # the expert axis of a split layer

    def __init__(self, width: int, n_experts: int, top_k: int = 1,
                 capacity_factor: float = 1.25, dtype=torch.float32):
        super().__init__()
        n_experts, top_k = int(n_experts), int(top_k)
        if not 1 <= top_k <= n_experts:
            raise ValueError(f"router_top_k={top_k} with {n_experts} experts")
        self.n_experts, self.top_k = n_experts, top_k
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        e = width
        self.router = nn.Parameter(torch.empty(e, n_experts))
        self.w_fc = nn.Parameter(torch.empty(n_experts, e, 4 * e))
        self.bias_fc = nn.Parameter(torch.zeros(n_experts, 4 * e))
        self.w_proj = nn.Parameter(torch.empty(n_experts, 4 * e, e))
        self.bias_proj = nn.Parameter(torch.zeros(n_experts, e))
        self.aux_loss: Optional[torch.Tensor] = None
        self.routing = None
        self.whole: Optional[tuple] = None  # the stacks gathered whole

    def capacity(self, tokens: int) -> int:
        return int(math.ceil(self.capacity_factor * self.top_k * tokens / self.n_experts))

    def _split(self) -> bool:
        return self.ep is not None and self.ep.size > 1 and self.whole is None

    def forward(self, x):
        lead, e = x.shape[:-1], x.shape[-1]
        xt = x.reshape(-1, e)
        n_exp, k, dt = self.n_experts, self.top_k, self.dtype
        split = self._split()
        if split and not _GLOBAL:
            raise RuntimeError(
                "a MoE layer split over the expert axis runs in the train and eval steps "
                "(global_routing) or inside parallel.mesh.gathered_parameters")
        over_data = _GLOBAL and data_world() > 1
        probs = torch.softmax(xt.float() @ self.router.float(), dim=-1)
        every = all_gather_rows(probs) if over_data else probs  # the global tokens
        rows = shard_rows(every.shape[0]) if over_data else slice(None)
        cap = self.capacity(every.shape[0])
        idx, gates, pos, keep = route(every, k, cap)
        top1 = nn.functional.one_hot(idx[:, 0], n_exp).float()
        self.aux_loss = n_exp * torch.sum(top1.mean(dim=0) * every.mean(dim=0))
        self.routing = (idx.detach(), pos.detach(), keep.detach())
        idx, gates, pos, keep = idx[rows], gates[rows], pos[rows], keep[rows]

        # dispatch: token t's slot s lands at [expert, position] of this
        # rank's experts' [n, C, E]
        stacks = self.whole or (self.w_fc, self.bias_fc, self.w_proj, self.bias_proj)
        w_fc, bias_fc, w_proj, bias_proj = stacks
        n_local = w_fc.shape[0]
        first = self.ep.rank * n_local if split else 0
        mine = keep & (idx >= first) & (idx < first + n_local) if split else keep
        src = _CopyToModel.apply(xt, self.ep.group) if split else xt
        tok = torch.arange(xt.shape[0], device=x.device)[:, None].expand(-1, k)
        xe = xt.new_zeros((n_local, cap, e), dtype=dt)
        xe[idx[mine] - first, pos[mine]] = src[tok[mine]].to(dt)
        if over_data:  # every data rank's tokens
            xe = _ReduceFromModel.apply(xe, data_group())
        h = torch.bmm(xe, w_fc.to(dt)) + bias_fc.to(dt)[:, None]
        out = torch.bmm(quick_gelu(h), w_proj.to(dt)) + bias_proj.to(dt)[:, None]
        if split:  # every expert's outputs
            out = _GatherExperts.apply(out, self.ep)

        # combine: the gate-weighted sum of each token's kept expert outputs,
        # gates in the activation dtype and the sum in fp32, as the JAX
        # one-hot product accumulates
        w = (gates.to(dt).float() * keep)[..., None]  # [T, k, 1]
        sel = out[idx, pos.clamp(max=cap - 1)].float()  # [T, k, E]
        y = (w * sel).sum(dim=1).to(dt)
        return y.reshape(*lead, e)


def moe_layers(model: nn.Module) -> List[MoEMLP]:
    """The model's ``MoEMLP`` layers (empty for a dense model)."""
    return [m for m in model.modules() if isinstance(m, MoEMLP)]


def shard_experts(model: nn.Module, axis: Optional[ModelAxis] = None) -> nn.Module:
    """Split ``model``'s expert stacks over the expert axis, in place: on
    expert rank ``x`` of ``X`` each ``moe_pspec`` leaf keeps its experts
    ``x·nE/X …`` (the ``Parameter`` objects stay, so an optimizer built
    after sees the parts). ``axis`` defaults to ``parallel.mesh``'s current
    expert axis; of size 1 the model is left whole. Raises before anything
    is split where ``X`` does not divide a layer's ``nE``, as
    ``tree_shardings`` does, or where the model has no MoE layer."""
    if axis is None:
        axis = ModelAxis(axis_group(EXPERT_AXIS), axis_rank(EXPERT_AXIS),
                         axis_world(EXPERT_AXIS))
    if axis.size == 1:
        return model
    if expert_axis(model) is not None:
        raise ValueError("the model is split over the expert axis already")
    layers = [(n, m) for n, m in model.named_modules() if isinstance(m, MoEMLP)]
    if not layers:
        raise ValueError("--ep shards mixture-of-experts stacks over an expert mesh axis, "
                         "but this model has no MoE layer")
    for name, layer in layers:
        if layer.n_experts % axis.size:
            raise ValueError(
                f"mesh axis 'expert' (size {axis.size}) does not divide dim 0 of param "
                f"{name}.w_fc (shape {tuple(layer.w_fc.shape)}); pick an ep degree that "
                f"divides the expert count")
    with torch.no_grad():
        for _, layer in layers:
            for leaf in EXPERT_LEAVES:
                p = getattr(layer, leaf)
                p.data = own_part(p.data, axis.rank, axis.size)
            layer.ep = axis
    model.ep_axis = axis
    return model


def split_stacks(model: nn.Module) -> set:
    """The expert-stack parameters of ``model``'s layers split over an
    expert axis of more than one rank (empty for any other model)."""
    return {getattr(m, leaf) for m in moe_layers(model) if m.ep is not None and m.ep.size > 1
            for leaf in EXPERT_LEAVES}


def sync_expert_gradients(model: nn.Module) -> None:
    """Under ZeRO-3 beside the expert axis: the split expert stacks'
    gradients (which ``parallel.mesh.fully_shard_model`` leaves out of
    FSDP2) averaged over the data group, the mean DDP gives them otherwise;
    a stack without a gradient takes zeros. Each data rank of an expert
    place holds the same experts, so the mean is their one-device
    gradient."""
    from .pipeline import _all_reduce

    names = {id(p): n for n, p in model.named_parameters()}
    stacks = sorted(split_stacks(model), key=lambda p: names[id(p)])  # one order a rank
    if data_world() == 1 or not stacks:
        return
    for p in stacks:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    _all_reduce([p.grad for p in stacks], data_group())
    for p in stacks:
        p.grad.div_(data_world())


@contextlib.contextmanager
def gathered_experts(model: nn.Module):
    """Within the block every split MoE layer of ``model`` holds its stacks
    whole (gathered over the expert group: every expert rank enters
    together) and routes each call's own tokens; forwards without a graph
    only. A model not split over the expert axis: nothing to do."""
    layers = [m for m in moe_layers(model) if m.ep is not None and m.ep.size > 1]
    with torch.no_grad():
        for layer in layers:
            whole = []
            for leaf in EXPERT_LEAVES:
                t = getattr(layer, leaf).detach()
                parts = [torch.empty_like(t) for _ in range(layer.ep.size)]
                dist.all_gather(parts, t.contiguous(), group=layer.ep.group)
                whole.append(torch.cat(parts))
            layer.whole = tuple(whole)
    try:
        yield
    finally:
        for layer in layers:
            layer.whole = None
