"""The ``("data", "model")`` mesh of ``vtc_tpu/parallel/mesh.py`` on
``torch.distributed``, one process per card.

``create_mesh(n_data, n_model)`` lays the process group out as
``vtc_tpu``'s mesh: rank ``d·n_model + m`` holds place ``(d, m)``, so a
model group is ``n_model`` consecutive ranks and a data group the ranks of
one model place. It returns a ``DeviceMesh`` with those dims and keeps it as
the current mesh; ``data_group``/``data_rank``/``data_world`` and their
``model_`` twins read it. Without a mesh the data axis is the whole group
and the model axis one rank, which is how data parallelism ran before the
model axis existed.

GSPMD runs ``vtc_tpu``'s step at the global batch with the batch axis
sharded over ``data``; the port runs one process per card (``torchrun``),
each data place on its rows of the global batch, every model place of it
on the same rows:

* ``shard_batch`` gives data rank ``r`` of ``W`` the rows ``r·B/W …
  (r+1)·B/W`` of a global batch of ``B``;
* ``data_parallel`` wraps the model in ``DistributedDataParallel`` over the
  data group, which averages the gradients over the data ranks; ``unwrap``
  gives the module back;
* ``all_gather_rows`` concatenates each data rank's rows in rank order with
  a backward that sums the gradient over the data ranks and keeps this
  rank's rows. Every rank computes the loss of the whole batch from the
  gathered features, so the gathered rows' gradient is ``W`` times the
  loss's on each rank and DDP's mean makes it the single-device gradient;
* the BatchNorms in training gather the data ranks' rows the same way, take
  the statistics of the global batch with one device's ops and keep their
  own rows (``models.cam``, ``models.layers.TorchBatchNorm``).

The second axis is one of three, as in ``vtc_tpu`` (at most one non-data
axis a run, ``check_axes``):

* ``model`` (``create_mesh``): ``parallel.tensor``'s Megatron-style tensor
  parallelism;
* ``expert`` (``parallel.expert.create_ep_mesh``): the MoE expert stacks
  split over it, each rank running its experts on the dispatched tokens of
  the whole data group;
* ``pipe`` (``parallel.pipeline.create_pipeline_mesh``): GPipe over the
  block stacks (``parallel.stack``), every parameter whole on every rank.

Each creator keeps its ``DeviceMesh`` as the current mesh, rank ``d·n + i``
at ``(d, i)``; ``axis_group``/``axis_rank``/``axis_world`` read any axis
(an axis the mesh lacks is this rank alone). ZeRO-3 (``fsdp``,
``vtc_tpu``'s ``tree_shardings(..., fsdp=True)``) is FSDP2's
``fully_shard`` over the data axis (``fully_shard_model``), alone or on top
of the model axis's split. The sequence and multi-slice axes are refused by
``check_axes``, naming their ROADMAP item.

**ZeRO-3.** ``fully_shard_model`` shards each residual block (the visual
and text towers', the CAM's, the TimeSformers') as a unit, then the root,
over the data dimension of ``create_mesh``'s ``DeviceMesh``: each data rank
holds dim-0 rows ``⌈n/W⌉`` of every parameter (the last ranks fewer, padded
inside FSDP2) and, since the optimizer steps the sharded ``DTensor``s, of
every Adam moment. A unit's parameters are gathered before its forward and
backward and freed after; the gradients are reduce-scattered as their mean
over the data ranks, as DDP's mean, so ``all_gather_rows``' ``W`` factor
still gives the single-device gradient. The layout is not ``vtc_tpu``'s:
``fsdp_pspec`` shards the largest divisible dimension and keeps leaves under
``FSDP_MIN_SIZE`` elements replicated, which saves one collective's latency
per small leaf on a TPU; FSDP2 gathers a whole unit in one all-gather, so
that rule has no counterpart here. The layout differs; the math does not.
The mesh's device type is the ranks' device (``create_mesh(device=...)``),
not the backend's: FSDP2 places the shards on it, so gloo on the card keeps
them on the card.

Every forward of a sharded model gathers over the data group, so the data
ranks must run the same forwards. Training and validation do (each rank
takes its rows of every global batch). The strided evaluation of the
trainer's probe (``evaluation.retrieval_eval``) does not: a rank may hold
one video more than another. It runs inside ``gathered_parameters``, which
gathers every unit once, keeps it whole through the forwards (no
collective inside them) and shards it again after; it gathers the expert
axis's stacks the same way. The ``eval.py`` twin evaluates the whole model
on every data rank, as ``vtc_tpu``'s does.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from ..device import DISTRIBUTION
from ..utils.util import rank, world

DATA_AXIS = "data"
MODEL_AXIS = "model"
EXPERT_AXIS = "expert"
PIPE_AXIS = "pipe"
_MESH = None  # the newest mesh creator's


def check_axes(n_model: int = 1, *, pp: int = 1, sp: int = 1, ep: int = 1,
               slices: int = 1, moe: bool = True, fsdp: bool = False) -> None:
    """The axes of a run, checked as ``vtc_tpu``'s ``train.py:121-146``
    checks them: at most one non-data axis (``n_model``, ``pp``, ``sp``,
    ``ep``), ``slices`` not beside pp/sp/ep and ``ep`` only for a model with
    mixture-of-experts layers (``moe``) raise ``ValueError``; the axes the
    port does not shard (``sp``, ``slices``) and ZeRO-3 beside the expert or
    pipe axis raise ``NotImplementedError`` naming their ROADMAP item."""
    n_model, pp, sp, ep, slices = (int(v or 1) for v in (n_model, pp, sp, ep, slices))
    if min(n_model, pp, sp, ep, slices) < 1:
        raise ValueError(f"--n_model {n_model} --pp {pp} --sp {sp} --ep {ep} --slices "
                         f"{slices}: each axis needs 1 rank or more")
    if sum(n > 1 for n in (n_model, pp, sp, ep)) > 1:
        raise ValueError(f"pick at most one non-data mesh axis per run: n_model={n_model}, "
                         f"pp={pp}, sp={sp}, ep={ep}")
    if slices > 1 and max(pp, sp, ep) > 1:
        raise ValueError(f"--slices composes with dp/tp/fsdp (replica = data parallelism "
                         f"across slices), not with pp/sp/ep (got pp={pp}, sp={sp}, ep={ep})")
    if ep > 1 and not moe:
        raise ValueError("--ep shards mixture-of-experts stacks over an expert mesh axis, "
                         "but this arch has no MoE (set arch;args;moe_experts, e.g. "
                         "configs/pretrained_clip_comments_attn_moe.jsonc)")
    for key, value in (("sp", sp), ("slices", slices)):
        if value > 1:
            raise NotImplementedError(
                f"--{key} {value}: the sequence and multi-slice axes are not ported; the "
                f"port shards the data, model, expert and pipe axes and ZeRO-3 "
                f"({DISTRIBUTION})")
    if fsdp and max(pp, ep) > 1:
        raise NotImplementedError(
            f"--fsdp beside --pp {pp} / --ep {ep}: ZeRO-3 composes with the data and "
            f"model axes in the port ({DISTRIBUTION})")


def _make_mesh(n_data, n_second: int, axis: str, device):
    """The process group as a ``("data", axis)`` ``DeviceMesh`` of
    ``n_data × n_second`` ranks, rank ``d·n_second + i`` at ``(d, i)``,
    kept as the current mesh; None for one process without a group."""
    global _MESH
    n_second = int(n_second or 1)
    flag = {MODEL_AXIS: "--n_model", EXPERT_AXIS: "--ep", PIPE_AXIS: "--pp"}[axis]
    if not dist.is_initialized():
        if n_second > 1 or int(n_data or 1) > 1:
            raise RuntimeError(
                f"a {n_data or 1}x{n_second} mesh runs one process per card: launch "
                f"`torchrun --nproc_per_node {(n_data or 1) * n_second}` and pass "
                f"--n_devices {n_data or 1} {flag} {n_second}")
        _MESH = None
        return None
    w = world()
    n_data = w // n_second if n_data is None else int(n_data)
    if n_data * n_second != w:
        raise ValueError(f"a {n_data}x{n_second} mesh over a group of {w} processes: "
                         f"launch {n_data * n_second} (n_devices x {flag[2:]})")
    from torch.distributed.device_mesh import DeviceMesh

    _MESH = DeviceMesh(torch.device(device).type, torch.arange(w).reshape(n_data, n_second),
                       mesh_dim_names=(DATA_AXIS, axis))
    return _MESH


def create_mesh(n_data=None, n_model: int = 1, *, device):
    """The process group as a ``("data", "model")`` ``DeviceMesh`` of
    ``n_data × n_model`` ranks (``n_data`` by default: the group's size over
    ``n_model``), rank ``d·n_model + m`` at ``(d, m)``, kept as the current
    mesh. Its device type is ``device``'s, where the ranks compute, whatever
    the backend. One process without a group: None (no axis to shard)."""
    return _make_mesh(n_data, n_model, MODEL_AXIS, device)


def current_mesh():
    """The newest mesh creator's, while its process group lives."""
    return _MESH if dist.is_initialized() else None


def has_axis(axis: str) -> bool:
    mesh = current_mesh()
    return mesh is not None and axis in mesh.mesh_dim_names


def axis_group(axis: str):
    """The process group of this rank's ``axis`` (None where the mesh lacks
    it: the axis is this rank alone)."""
    return current_mesh().get_group(axis) if has_axis(axis) else None


def axis_rank(axis: str) -> int:
    return rank(axis_group(axis)) if has_axis(axis) else 0


def axis_world(axis: str) -> int:
    return world(axis_group(axis)) if has_axis(axis) else 1


def data_group():
    """The process group of this rank's data axis (None: the whole group)."""
    mesh = current_mesh()
    return None if mesh is None else mesh.get_group(DATA_AXIS)


def data_rank() -> int:
    return rank(data_group())


def data_world() -> int:
    return world(data_group())


def model_group():
    """The process group of this rank's model axis; None without one, where
    the model axis is this rank alone."""
    return axis_group(MODEL_AXIS)


def model_rank() -> int:
    return axis_rank(MODEL_AXIS)


def model_world() -> int:
    return axis_world(MODEL_AXIS)


def check_data_devices(n_devices, device: torch.device, logger, what: str,
                       module: str, n_model: int = 1, flag: str = "--n_model") -> None:
    """``--n_devices N`` (and the second axis's ``flag M``: ``--n_model``,
    ``--ep`` or ``--pp``) of an entry point: under a process group the data
    axis is the group over M, whose size N must name (1 leaves it to the
    group); without one, a machine with N·M cards or more raises with the
    ``torchrun`` line that runs them, and one with fewer warns and runs
    unsharded on one device, as the JAX package does."""
    n, m = int(n_devices or 1), int(n_model or 1)
    if world() > 1:
        if world() % m:
            raise ValueError(f"{flag} {m} does not divide the group of {world()} "
                             f"processes")
        if n not in (1, world() // m):
            raise ValueError(f"--n_devices {n} {flag} {m} in a group of {world()} "
                             f"processes: launch `torchrun --nproc_per_node {n * m}`")
        return
    if n * m <= 1:
        return
    have = torch.cuda.device_count() if device.type == "cuda" else 1
    if have >= n * m:
        raise RuntimeError(
            f"--n_devices {n} {flag} {m} on a machine with {have} devices: the mesh "
            f"runs one process per card; launch `torchrun --nproc_per_node {n * m} -m "
            f"{module} ... --n_devices {n} {flag} {m}`")
    logger.warning(
        "Requested a 1x%dx%d (slices x data x second-axis) mesh but only %d "
        "device(s) are available; %s UNSHARDED on one device.", n, m, have, what)


def active() -> bool:
    """True under a process group: the step gathers, DDP averages."""
    return dist.is_initialized()


def shard_rows(n: int) -> slice:
    """This data rank's rows of a global batch of ``n``."""
    r, w = data_rank(), data_world()
    if n % w:
        raise ValueError(f"a global batch of {n} does not split over {w} data ranks")
    return slice(r * n // w, (r + 1) * n // w)


def shard_batch(x):
    """This data rank's rows ``r·B/W … (r+1)·B/W`` of ``x`` (an array or
    tensor with the batch first)."""
    return x[shard_rows(x.shape[0])]


def process_share(process_index=None, process_count=None) -> tuple:
    """``(index, count)`` of this process's share of an evaluation: the data
    axis's rank and size unless given, and given ones must be the data
    axis's (a count of more than one without a group would rank a part of
    the split as the whole). The model places of a data rank take the same
    share."""
    pidx = data_rank() if process_index is None else int(process_index)
    pcount = data_world() if process_count is None else int(process_count)
    if pcount != data_world() or not 0 <= pidx < pcount:
        raise RuntimeError(
            f"process {pidx} of {pcount}: this process is data rank {data_rank()} of "
            f"{data_world()}; a multi-process evaluation runs under torchrun")
    return pidx, pcount


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        group = data_group()
        parts = [torch.empty_like(x) for _ in range(world(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.rows = shard_rows(x.shape[0] * world(group))
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=data_group())
        return grad[ctx.rows]


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Each data rank's ``x`` (equal shapes) concatenated in rank order; the
    backward sums the gradient over the data ranks and keeps this rank's
    rows. One data rank: ``x``."""
    return _AllGather.apply(x) if data_world() > 1 else x


def data_parallel(model: torch.nn.Module, device: torch.device):
    """``model`` in ``DistributedDataParallel`` over the data group under a
    process group (also of one rank: the same path), else ``model``; a
    model that ``fully_shard_model`` sharded as it is. The
    parameters that take no gradient in a step (``final_linear`` beside
    ``init_from_avg``, a frozen tower) are found each step; the buffers are
    not broadcast, since the BatchNorms take the global batch's statistics
    on every rank. The split parameters of a tensor-parallel model average
    with their own model place's, an expert rank's stacks with its expert
    place's. On a pipe mesh the model stays as it is: the step sums the
    stages' gradients and averages the data ranks' itself
    (``parallel.pipeline.sync_gradients``), since a stage's blocks take
    their gradients inside the schedule's own backward."""
    if not active() or is_fully_sharded(model) or axis_world(PIPE_AXIS) > 1:
        return model  # the pipe axis syncs its own (``pipeline.sync_gradients``)
    from torch.nn.parallel import DistributedDataParallel

    ids = [device.index if device.index is not None else torch.cuda.current_device()] \
        if device.type == "cuda" else None
    return DistributedDataParallel(model, device_ids=ids, broadcast_buffers=False,
                                   find_unused_parameters=True,
                                   process_group=data_group())


def unwrap(model: torch.nn.Module) -> torch.nn.Module:
    """The module inside ``DistributedDataParallel``, or ``model``."""
    from torch.nn.parallel import DistributedDataParallel

    return model.module if isinstance(model, DistributedDataParallel) else model


def _block_types() -> tuple:
    from ..models.layers import ResidualAttentionBlock
    from ..models.timesformer import TimeSformerBlock
    from ..models.timesformer_joint import JointBlock

    return ResidualAttentionBlock, TimeSformerBlock, JointBlock


def fully_shard_model(model: torch.nn.Module, device) -> torch.nn.Module:
    """ZeRO-3 of ``model`` over the data axis of the current mesh (without
    one, the group's: ``create_mesh``), in place (the module docstring):
    FSDP2's ``fully_shard`` on each residual block, then on the root, after
    any split over the model axis. Under a process group only; build the
    optimizer after it, over the sharded parameters.
    ``data_parallel`` then leaves the model as it is: FSDP2 takes DDP's
    place on the data group."""
    if not active():
        return model
    from torch.distributed.fsdp import fully_shard

    device = torch.device(device)
    mesh = current_mesh()
    if mesh is None:  # the whole group on the data axis
        mesh = create_mesh(device=device)
    if mesh.device_type != device.type:
        raise ValueError(f"the mesh places its shards on {mesh.device_type}, the ranks "
                         f"compute on {device}: create_mesh(..., device={device.type!r})")
    data_mesh = mesh[DATA_AXIS]
    blocks = _block_types()
    for module in list(model.modules()):
        if isinstance(module, blocks):
            fully_shard(module, mesh=data_mesh)
    # a scalar (logit_scale) has no dim to shard: it stays whole on every
    # rank, and its gradient needs no mean, since every rank computes the
    # loss of the global batch from the gathered features
    scalars = {p for p in model.parameters() if p.dim() == 0}
    fully_shard(model, mesh=data_mesh, ignored_params=scalars or None)
    return model


def is_fully_sharded(model: torch.nn.Module) -> bool:
    """True for a model that ``fully_shard_model`` sharded."""
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def _units(model: torch.nn.Module) -> list:
    from torch.distributed.fsdp import FSDPModule

    return [m for m in model.modules() if isinstance(m, FSDPModule)]


@contextlib.contextmanager
def no_gradient_sync(model: torch.nn.Module):
    """A backward whose gradients stay on this rank, to be added to the
    next one's (the microbatches before the last): DDP's ``no_sync``,
    FSDP2's ``set_requires_gradient_sync(False)``, else nothing to hold."""
    if is_fully_sharded(model):
        model.set_requires_gradient_sync(False)
        try:
            yield
        finally:
            model.set_requires_gradient_sync(True)
    elif hasattr(model, "no_sync"):
        with model.no_sync():
            yield
    else:
        yield


@contextlib.contextmanager
def gathered_parameters(model: torch.nn.Module):
    """Within the block a sharded model holds every unit whole, and a model
    split over the expert axis every expert stack, so its forwards run no
    collective and the data ranks may run different numbers of them (a MoE
    layer routes each call's own tokens there); after it, sharded again.
    Every rank enters and leaves together (the gathers are collectives).
    Forwards without a graph only. A model that is not sharded: nothing to
    do."""
    from .expert import gathered_experts

    units = _units(model)
    with gathered_experts(model):
        if not units:
            yield
            return
        for unit in units:
            unit.set_reshard_after_forward(False, recurse=False)
            unit.unshard()
        try:
            yield
        finally:
            for unit in units:
                unit.reshard()
                unit.set_reshard_after_forward(unit is not model, recurse=False)
