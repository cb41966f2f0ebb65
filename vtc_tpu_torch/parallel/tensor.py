"""Tensor parallelism over the ``model`` axis: ``vtc_tpu``'s GSPMD rules
(``vtc_tpu/parallel/mesh.py:92-105``) written Megatron-style, on local
tensors, one process per card.

``shard_model(model)`` splits, on model rank ``m`` of ``M``, exactly the
parameters that ``vtc_tpu.parallel.mesh.tree_pspecs`` puts on ``"model"``
(``SPLIT_RULES``, matched by name, so the CLIP towers' blocks, the CAM's and
the TimeSformer's ``timeattn`` alike):

* each attention's ``[3E, E]`` ``in_proj_weight`` and ``[3E]`` bias keep the
  rows of rank ``m``'s heads from each of q, k and v (JAX stores ``[3, E,
  E]`` and shards dim 1; the merged rows are not split contiguously, which
  would mix q, k and v). The attention then runs on ``H/M`` heads of the
  local q/k/v column views, through the same kernels;
* ``out_proj`` takes its input columns, its bias added once, after the
  all-reduce;
* the MLP's ``c_fc`` is split by output row, with its bias, and ``c_proj``
  by input column, its bias after the all-reduce;
* ``token_embedding`` is split by vocabulary row: a masked lookup, then an
  all-reduce.

Two autograd functions carry every collective: ``copy_to_model`` (identity
forward, all-reduce backward) where a replicated activation enters a split
layer, and ``reduce_from_model`` (all-reduce forward, identity backward)
where the partial sums leave it. Every other parameter is replicated and
takes the same gradient on each model rank. A degree that does not divide
each attention's head count and each split dimension raises before any
parameter is touched, as ``tree_shardings`` and ``qkv_project`` do.

Checkpoints keep the single-card layout: ``full_state_dict`` and
``full_optimizer_state`` gather the split tensors (and their Adam moments)
over the model group, ``split_state_dict`` and ``split_optimizer_state``
take rank ``m``'s part of a full one. Under ZeRO-3
(``parallel.mesh.fully_shard_model``) the same four also gather the data
axis's shards (``DTensor``s) first, and shard a full tensor as its
parameter is; on the expert axis (``parallel.expert.shard_experts``) they
gather and cut the expert stacks and their moments over dim 0.

A mixture-of-experts layer is not split on the model axis: ``tree_pspecs``'
rules name ``c_fc``/``c_proj``, not the expert stacks, so its leaves stay
whole on every model rank and the experts compute redundantly there, as
GSPMD's replicated layout does.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

import torch
import torch.distributed as dist

# (name pattern, the dimension split) of the port's parameter names; "qkv"
# splits each of q, k and v of dim 0
SPLIT_RULES = (
    (re.compile(r"(.*\.)?\w*attn\.in_proj_(weight|bias)$"), "qkv"),
    (re.compile(r"(.*\.)?\w*attn\.out_proj\.weight$"), 1),
    (re.compile(r"(.*\.)?mlp\.c_fc\.(weight|bias)$"), 0),
    (re.compile(r"(.*\.)?mlp\.c_proj\.weight$"), 1),
    (re.compile(r"(.*\.)?token_embedding\.weight$"), 0),
)


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """This rank's place on the model axis: its process group (None: the
    whole group), rank and size."""
    group: Optional[object]
    rank: int
    size: int


def split_rule(name: str):
    """The dimension ``name`` splits on (0, 1 or "qkv"), or None where the
    parameter is replicated."""
    for pattern, rule in SPLIT_RULES:
        if pattern.match(name):
            return rule
    return None


def split_names(model: torch.nn.Module) -> list:
    """The names of the parameters that the model axis splits."""
    return [n for n, _ in model.named_parameters() if split_rule(n) is not None]


# ---- the collectives ------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """``x`` (replicated over the model axis) entering a split layer: the
    identity, whose backward sums the ranks' gradients."""
    return _CopyToModel.apply(x, axis.group)


def reduce_from_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The ranks' partial sums ``x`` summed (an all-reduce); the backward
    is the identity."""
    return _ReduceFromModel.apply(x, axis.group)


# ---- splitting and gathering --------------------------------------------------------

def _check(name: str, shape, rule, size: int) -> None:
    dim = 0 if rule == "qkv" else rule
    n = shape[dim] // 3 if rule == "qkv" else shape[dim]
    if (rule == "qkv" and shape[dim] % 3) or n % size:
        raise ValueError(
            f"the model axis (size {size}) does not divide dim {dim} of param {name!r} "
            f"(shape {tuple(shape)}); pick a tp degree that divides every tower's head "
            f"count (ViT-B/32: tp in {{2, 4}})")


def own_part(t: torch.Tensor, rank: int, size: int, dim: int = 0) -> torch.Tensor:
    """Rank ``rank`` of ``size``'s chunk of ``t`` along ``dim``, in storage
    of its own (a chunk of dim 0 is a view that would keep the whole
    tensor's storage alive)."""
    return t.chunk(size, dim=dim)[rank].clone(memory_format=torch.contiguous_format)


def split_tensor(t: torch.Tensor, rule, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank`` of ``size``'s part of the full tensor ``t``."""
    if rule == "qkv":
        parts = t.unflatten(0, (3, size, -1))[:, rank]
        return parts.flatten(0, 1).contiguous()
    return own_part(t, rank, size, rule)


def join_tensors(parts, rule) -> torch.Tensor:
    """The full tensor of each rank's part, in rank order."""
    if rule == "qkv":
        stacked = torch.stack([p.unflatten(0, (3, -1)) for p in parts], 1)
        return stacked.flatten(0, 2)
    return torch.cat(parts, dim=rule)


def split_state_dict(state_dict: Dict[str, torch.Tensor], rank: int, size: int) -> dict:
    """Rank ``rank`` of ``size``'s part of a full (single-card) state dict:
    the split parameters' slices, every other entry as it is."""
    out = {}
    for name, t in state_dict.items():
        rule = split_rule(name)
        if rule is None or size == 1:
            out[name] = t
            continue
        _check(name, t.shape, rule, size)
        out[name] = split_tensor(t, rule, rank, size)
    return out


def _gather(t: torch.Tensor, rule, axis: ModelAxis) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t.contiguous(), group=axis.group)
    return join_tensors(parts, rule)


def model_axis(model: torch.nn.Module) -> Optional[ModelAxis]:
    """The axis ``shard_model`` split ``model`` over, or None."""
    return getattr(model, "tp_axis", None)


def _whole_over_data(t):
    """A tensor that ZeRO-3 shards over the data axis (a ``DTensor``)
    gathered whole (a collective of its data group), else ``t``. FSDP2's
    layout, dim 0 in ``torch.chunk``'s parts (the last ranks hold fewer
    rows, or none), is gathered with ``dist.all_gather`` of the parts
    padded to the first's rows: gloo takes that on CUDA tensors, where
    ``DTensor.full_tensor``'s functional collective crashes."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t
    group = t.device_mesh.get_group()
    local = t.to_local()
    rows = -(-t.shape[0] // dist.get_world_size(group))
    padded = local.new_zeros((rows,) + tuple(t.shape[1:]))
    padded[:local.shape[0]] = local
    parts = [torch.empty_like(padded) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, padded, group=group)
    whole = torch.cat(parts)
    # a view would carry the padding's storage into a saved checkpoint
    return whole if whole.shape[0] == t.shape[0] else whole[:t.shape[0]].clone()


def _shard_like(t: torch.Tensor, like):
    """This data rank's shard of the whole ``t``, laid out as the ``DTensor``
    ``like`` (no collective: every rank holds ``t``); ``t`` where ``like`` is
    not sharded."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if not isinstance(like, DTensor):
        return t
    return distribute_tensor(t.to(like.device), like.device_mesh, like.placements,
                             src_data_rank=None)


def _expert_split(model):
    """``(axis, moe_pspec)`` of a model split over the expert axis, else
    ``(None, None)``."""
    from .expert import expert_axis, moe_pspec

    axis = expert_axis(model)
    return (axis, moe_pspec) if axis is not None and axis.size > 1 else (None, None)


def full_tensors(model: torch.nn.Module, named: Dict[str, Optional[torch.Tensor]]) -> dict:
    """``named`` (parameter names to this rank's tensors of their shapes,
    such as their gradients; None passes through) in their single-card
    form: sharded over the data axis (ZeRO-3) gathered, split over the
    model axis joined, the expert stacks joined over the expert axis (every
    rank must call it, with the same names and Nones)."""
    named = {n: None if t is None else _whole_over_data(t) for n, t in named.items()}
    experts, moe = _expert_split(model)
    if experts is not None:
        return {n: _gather(t, 0, experts) if t is not None and moe(n) else t
                for n, t in named.items()}
    axis = model_axis(model)
    if axis is None or axis.size == 1:
        return named
    return {n: _gather(t, split_rule(n), axis) if t is not None and split_rule(n) is not None
            else t for n, t in named.items()}


def full_state_dict(model: torch.nn.Module) -> dict:
    """``model``'s state dict in the single-card layout: ZeRO-3's shards
    and a split model's parts gathered (every rank must call it)."""
    return full_tensors(model, model.state_dict())


def _param_names(model, optimizer) -> list:
    """The name of each parameter in the optimizer's state-dict order."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


def _moments(optimizer_state: dict, model, optimizer, fn) -> dict:
    """The state with ``fn(value, name)`` for each tensor moment (not the
    step counts, which have no dimension)."""
    names = _param_names(model, optimizer)
    state = {}
    for index, entry in optimizer_state["state"].items():
        if int(index) >= len(names):  # the groups changed: load_state_dict's error
            raise ValueError(f"optimizer state of parameter {index}: the optimizer's "
                             f"groups hold {len(names)} parameters")
        name = names[int(index)]
        state[index] = {k: fn(v, name) if torch.is_tensor(v) and v.dim() else v
                        for k, v in entry.items()}
    return {"state": state, "param_groups": optimizer_state["param_groups"]}


def full_optimizer_state(model: torch.nn.Module, optimizer) -> dict:
    """``optimizer.state_dict()`` with ZeRO-3's shards of the moments and
    the split parameters' moments gathered, the state of a single card's
    run (every rank must call it)."""
    axis = model_axis(model)
    experts, moe = _expert_split(model)

    def full(v, name):
        v, rule = _whole_over_data(v), split_rule(name)
        if experts is not None and moe(name):
            return _gather(v, 0, experts)
        if axis is None or axis.size == 1 or rule is None:
            return v
        return _gather(v, rule, axis)

    return _moments(optimizer.state_dict(), model, optimizer, full)


def split_optimizer_state(model: torch.nn.Module, optimizer, full_state: dict) -> dict:
    """This rank's part of a single-card optimizer state: the split
    parameters' moments cut over the model axis, each moment sharded as
    its parameter is over the data axis."""
    from torch.distributed.tensor import DTensor

    axis = model_axis(model)
    experts, moe = _expert_split(model)
    params = dict(model.named_parameters())
    if (axis is None or axis.size == 1) and experts is None and not any(
            isinstance(p, DTensor) for p in params.values()):
        return full_state  # a single card's: as it is

    def part(v, name):
        if experts is not None and moe(name):
            return own_part(v, experts.rank, experts.size)
        rule = split_rule(name)
        if axis is not None and axis.size > 1 and rule is not None:
            v = split_tensor(v, rule, axis.rank, axis.size)
        return _shard_like(v, params[name])

    return _moments(full_state, model, optimizer, part)


def load_full_state_dict(model: torch.nn.Module, state_dict: dict, strict: bool = True):
    """Load a single-card state dict into ``model``: split over the model
    axis and sharded over the data axis where it is."""
    axis = model_axis(model)
    if axis is not None and axis.size > 1:
        state_dict = split_state_dict(state_dict, axis.rank, axis.size)
    experts, moe = _expert_split(model)
    if experts is not None:
        state_dict = {n: own_part(t, experts.rank, experts.size) if moe(n) else t
                      for n, t in state_dict.items()}
    own = model.state_dict()
    state_dict = {n: _shard_like(t, own[n]) if n in own else t
                  for n, t in state_dict.items()}
    return model.load_state_dict(state_dict, strict=strict)


# ---- the model ------------------------------------------------------------------------

def shard_model(model: torch.nn.Module, axis: Optional[ModelAxis] = None) -> torch.nn.Module:
    """Split ``model`` (built whole, the same weights on every rank) over
    the model axis, in place: each split parameter keeps this rank's part
    (the ``Parameter`` objects stay, so an optimizer built after sees the
    parts), and the attentions, MLPs and text embeddings run their split
    forward. ``axis`` defaults to ``parallel.mesh``'s current model axis;
    of size 1 the model is left whole. Raises before anything is split
    where the degree does not divide a head count or a split dimension.
    Mixture-of-experts layers stay whole (the module docstring)."""
    from ..models.layers import MLPBlock, MultiHeadAttention
    from ..models.clip_model import TextTransformer
    from .mesh import model_group, model_rank, model_world

    if axis is None:
        axis = ModelAxis(model_group(), model_rank(), model_world())
    if axis.size == 1:
        return model
    if model_axis(model) is not None:
        raise ValueError("the model is split already")
    for name, module in model.named_modules():
        if isinstance(module, MultiHeadAttention) and module.num_heads % axis.size:
            raise ValueError(
                f"tensor-parallel degree {axis.size} does not divide the head count "
                f"{module.num_heads} of {name}: the split would cross head boundaries "
                f"(pick a tp that divides every tower's head count; ViT-B/32: 12 visual "
                f"+ 8 text heads -> tp in {{2, 4}})")
    params = [(n, p, split_rule(n)) for n, p in model.named_parameters()]
    for name, p, rule in params:
        if rule is not None:
            _check(name, p.shape, rule, axis.size)
    with torch.no_grad():
        for name, p, rule in params:
            if rule is not None:
                p.data = split_tensor(p.data, rule, axis.rank, axis.size)
    for module in model.modules():
        if isinstance(module, (MultiHeadAttention, MLPBlock, TextTransformer)):
            module.tp = axis
    model.tp_axis = axis
    return model
