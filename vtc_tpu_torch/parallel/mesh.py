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

The model axis is ``parallel.tensor``'s (Megatron-style tensor
parallelism). ZeRO-3 (``fsdp``, ``vtc_tpu``'s ``tree_shardings(...,
fsdp=True)``) is FSDP2's ``fully_shard`` over the data axis
(``fully_shard_model``), on top of the model axis's split. The pipeline,
sequence, expert and multi-slice axes are refused by ``check_axes``, naming
their ROADMAP item.

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
collective inside them) and shards it again after. The ``eval.py`` twin
evaluates the whole model on every data rank, as ``vtc_tpu``'s does.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from ..device import DISTRIBUTION
from ..utils.util import rank, world

DATA_AXIS = "data"
MODEL_AXIS = "model"
_MESH = None  # the newest create_mesh's


def check_axes(n_model: int = 1, **others) -> None:
    """The axes the port does not shard raise: the pipeline, sequence,
    expert and multi-slice axes (``others``: ``pp``, ``sp``, ``ep``,
    ``slices``). ``n_model`` must be a whole degree."""
    if int(n_model or 1) < 1:
        raise ValueError(f"--n_model {n_model}: the model axis needs 1 rank or more")
    for key, value in others.items():
        if int(value or 1) > 1:
            raise NotImplementedError(
                f"--{key} {value}: pipeline, sequence, expert and multi-slice axes are "
                f"not ported; the port shards the data and model axes and ZeRO-3 "
                f"({DISTRIBUTION})")


def create_mesh(n_data=None, n_model: int = 1, *, device):
    """The process group as a ``("data", "model")`` ``DeviceMesh`` of
    ``n_data × n_model`` ranks (``n_data`` by default: the group's size over
    ``n_model``), rank ``d·n_model + m`` at ``(d, m)``, kept as the current
    mesh. Its device type is ``device``'s, where the ranks compute, whatever
    the backend. One process without a group: None (no axis to shard)."""
    global _MESH
    n_model = int(n_model or 1)
    if not dist.is_initialized():
        if n_model > 1 or int(n_data or 1) > 1:
            raise RuntimeError(
                f"a {n_data or 1}x{n_model} mesh runs one process per card: launch "
                f"`torchrun --nproc_per_node {(n_data or 1) * n_model}` and pass "
                f"--n_devices {n_data or 1} --n_model {n_model}")
        _MESH = None
        return None
    w = world()
    n_data = w // n_model if n_data is None else int(n_data)
    if n_data * n_model != w:
        raise ValueError(f"a {n_data}x{n_model} mesh over a group of {w} processes: "
                         f"launch {n_data * n_model} (n_devices x n_model)")
    from torch.distributed.device_mesh import DeviceMesh

    _MESH = DeviceMesh(torch.device(device).type, torch.arange(w).reshape(n_data, n_model),
                       mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return _MESH


def current_mesh():
    """The newest ``create_mesh``'s, while its process group lives."""
    return _MESH if dist.is_initialized() else None


def data_group():
    """The process group of this rank's data axis (None: the whole group)."""
    mesh = current_mesh()
    return None if mesh is None else mesh.get_group(DATA_AXIS)


def data_rank() -> int:
    return rank(data_group())


def data_world() -> int:
    return world(data_group())


def model_group():
    """The process group of this rank's model axis; None without a mesh,
    where the model axis is this rank alone."""
    mesh = current_mesh()
    return None if mesh is None else mesh.get_group(MODEL_AXIS)


def model_rank() -> int:
    return 0 if current_mesh() is None else rank(model_group())


def model_world() -> int:
    return 1 if current_mesh() is None else world(model_group())


def check_data_devices(n_devices, device: torch.device, logger, what: str,
                       module: str, n_model: int = 1) -> None:
    """``--n_devices N`` (and ``--n_model M``) of an entry point: under a
    process group the data axis is the group over M, whose size N must name
    (1 leaves it to the group); without one, a machine with N·M cards or
    more raises with the ``torchrun`` line that runs them, and one with
    fewer warns and runs unsharded on one device, as the JAX package
    does."""
    n, m = int(n_devices or 1), int(n_model or 1)
    if world() > 1:
        if world() % m:
            raise ValueError(f"--n_model {m} does not divide the group of {world()} "
                             f"processes")
        if n not in (1, world() // m):
            raise ValueError(f"--n_devices {n} --n_model {m} in a group of {world()} "
                             f"processes: launch `torchrun --nproc_per_node {n * m}`")
        return
    if n * m <= 1:
        return
    have = torch.cuda.device_count() if device.type == "cuda" else 1
    if have >= n * m:
        raise RuntimeError(
            f"--n_devices {n} --n_model {m} on a machine with {have} devices: the mesh "
            f"runs one process per card; launch `torchrun --nproc_per_node {n * m} -m "
            f"{module} ... --n_devices {n} --n_model {m}`")
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
    with their own model place's."""
    if not active() or is_fully_sharded(model):
        return model
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
    """Within the block a sharded model holds every unit whole, so its
    forwards run no collective and the data ranks may run different
    numbers of them; after it, sharded again. Every data rank enters and
    leaves together (the gathers are collectives). Forwards without a
    graph only. A model that is not sharded: nothing to do."""
    units = _units(model)
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
