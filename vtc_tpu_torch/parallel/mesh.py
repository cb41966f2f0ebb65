"""Data parallelism on ``torch.distributed``: the ``data`` axis of
``vtc_tpu/parallel/mesh.py``, one process per card.

GSPMD runs ``vtc_tpu``'s step at the global batch with the batch axis
sharded over ``data``; the port runs one process per card (``torchrun``),
each on its rows of the global batch:

* ``shard_batch`` gives rank ``r`` of ``W`` the rows ``r·B/W … (r+1)·B/W``
  of a global batch of ``B``;
* ``data_parallel`` wraps the model in ``DistributedDataParallel``, which
  averages the gradients over the ranks; ``unwrap`` gives the module back,
  whose state dict is a single card's;
* ``all_gather_rows`` concatenates each rank's rows in rank order with a
  backward that sums the gradient over the ranks and keeps this rank's
  rows. Every rank computes the loss of the whole batch from the gathered
  features, so the gathered rows' gradient is ``W`` times the loss's on
  each rank and DDP's mean makes it the single-device gradient;
* the BatchNorms in training gather the ranks' rows the same way, take the
  statistics of the global batch with one device's ops and keep their own
  rows (``models.cam``, ``models.layers.TorchBatchNorm``).

Tensor parallelism (``n_model``) and ZeRO-3 (``fsdp``) are refused by
``check_axes``, naming ROADMAP Queue 1 item 9.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..device import DISTRIBUTION
from ..utils.util import rank, world


def check_axes(n_model: int = 1, fsdp: bool = False) -> None:
    """The axes beyond ``data`` raise: DTensor TP and FSDP2 are not ported."""
    if int(n_model or 1) > 1:
        raise NotImplementedError(
            f"--n_model {n_model}: tensor parallelism is not ported; the port shards "
            f"the data axis only ({DISTRIBUTION})")
    if fsdp:
        raise NotImplementedError(
            f"--fsdp: sharded parameters and moments are not ported; the port shards "
            f"the data axis only ({DISTRIBUTION})")


def check_data_devices(n_devices, device: torch.device, logger, what: str,
                       module: str) -> None:
    """``--n_devices N`` of an entry point: under a process group the data
    axis is the group, whose size it must name (1 leaves it to the group);
    without one, a machine with N cards or more raises with the
    ``torchrun`` line that runs them, and one with fewer warns and runs
    unsharded on one device, as the JAX package does."""
    n = int(n_devices or 1)
    if world() > 1:
        if n not in (1, world()):
            raise ValueError(f"--n_devices {n} in a group of {world()} processes: launch "
                             f"`torchrun --nproc_per_node {n}` with --n_devices {n}")
        return
    if n <= 1:
        return
    have = torch.cuda.device_count() if device.type == "cuda" else 1
    if have >= n:
        raise RuntimeError(
            f"--n_devices {n} on a machine with {have} devices: data parallelism runs one "
            f"process per card; launch `torchrun --nproc_per_node {n} -m {module} ... "
            f"--n_devices {n}`")
    logger.warning(
        "Requested a 1x%dx%d (slices x data x second-axis) mesh but only %d "
        "device(s) are available; %s UNSHARDED on one device.", n, 1, have, what)


def active() -> bool:
    """True under a process group: the step gathers, DDP averages."""
    return dist.is_initialized()


def shard_rows(n: int) -> slice:
    """This rank's rows of a global batch of ``n``."""
    r, w = rank(), world()
    if n % w:
        raise ValueError(f"a global batch of {n} does not split over {w} ranks")
    return slice(r * n // w, (r + 1) * n // w)


def shard_batch(x):
    """This rank's rows ``r·B/W … (r+1)·B/W`` of ``x`` (an array or tensor
    with the batch first)."""
    return x[shard_rows(x.shape[0])]


def process_share(process_index=None, process_count=None) -> tuple:
    """``(index, count)`` of this process's share: the process group's rank
    and size unless given, and given ones must be the group's (a count of
    more than one without a group would rank a part of the split as the
    whole)."""
    pidx = rank() if process_index is None else int(process_index)
    pcount = world() if process_count is None else int(process_count)
    if pcount != world() or not 0 <= pidx < pcount:
        raise RuntimeError(
            f"process {pidx} of {pcount}: this process is rank {rank()} of a group of "
            f"{world()}; a multi-process evaluation runs under torchrun")
    return pidx, pcount


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        parts = [torch.empty_like(x) for _ in range(world())]
        dist.all_gather(parts, x.contiguous())
        ctx.rows = shard_rows(x.shape[0] * world())
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad)
        return grad[ctx.rows]


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Each rank's ``x`` (equal shapes) concatenated in rank order; the
    backward sums the gradient over the ranks and keeps this rank's rows.
    One rank: ``x``."""
    return _AllGather.apply(x) if world() > 1 else x


def data_parallel(model: torch.nn.Module, device: torch.device):
    """``model`` in ``DistributedDataParallel`` under a process group (also
    of one rank: the same path), else ``model``. The parameters that take no
    gradient in a step (``final_linear`` beside ``init_from_avg``, a frozen
    tower) are found each step; the buffers are not broadcast, since the
    BatchNorms take the global batch's statistics on every rank."""
    if not active():
        return model
    from torch.nn.parallel import DistributedDataParallel

    ids = [device.index if device.index is not None else torch.cuda.current_device()] \
        if device.type == "cuda" else None
    return DistributedDataParallel(model, device_ids=ids, broadcast_buffers=False,
                                   find_unused_parameters=True)


def unwrap(model: torch.nn.Module) -> torch.nn.Module:
    """The module inside ``DistributedDataParallel``, or ``model``."""
    from torch.nn.parallel import DistributedDataParallel

    return model.module if isinstance(model, DistributedDataParallel) else model
