"""Small helpers of the reference's ``utils/util.py``, the port's own copy
of ``vtc_tpu/utils/util.py``'s ``inf_loop`` and ``is_image_like_batch``,
and the process-group helpers of ``:80-140`` on ``torch.distributed``:
``init_distributed`` from ``torchrun``'s environment, ``allgather_varlen``
and the rank helpers ``rank``, ``world`` and ``is_main`` (0, 1 and True
without a group)."""

from __future__ import annotations

import os
from itertools import repeat
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# the variables torchrun exports to each process it starts
TOPOLOGY = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def is_image_like_batch(obj) -> bool:
    """True if ``obj`` looks like a batch of RGB images ([b, 3, h, w] or
    [b, h, w, 3]). Mirrors ``utils/util.py:10-12``."""
    shape = getattr(obj, "shape", None)
    if shape is None or len(shape) != 4:
        return False
    return shape[1] == 3 or shape[-1] == 3


def inf_loop(data_loader):
    """Endless data loader wrapper (``utils/util.py:72-75``)."""
    for loader in repeat(data_loader):
        yield from loader


def launched() -> bool:
    """True in a process that ``torchrun`` started for a group of more than
    one (``WORLD_SIZE`` > 1 in its environment)."""
    return int(os.environ.get("WORLD_SIZE", "1") or 1) > 1


def init_distributed(backend: Optional[str] = None, init_method: Optional[str] = None):
    """Join the process group that ``torchrun`` describes: ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK`` from the environment, the rendezvous at
    ``MASTER_ADDR``:``MASTER_PORT`` unless ``init_method`` names another
    (``file://...``, as the CPU tests use). The backend is NCCL where a card
    is present (each process on ``cuda:LOCAL_RANK``), else gloo. A topology
    exported in part raises by name, as ``vtc_tpu``'s ``init_distributed``
    does; none at all raises with the ``torchrun`` line. Joining twice is a
    no-op. Returns ``(rank, world)``."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    need = TOPOLOGY[:3] if init_method else TOPOLOGY
    have = {k: os.environ.get(k) for k in need}
    missing = [k for k, v in have.items() if not v]
    if missing:
        if len(missing) == len(need):
            raise RuntimeError(
                "a distributed run needs the process topology that torchrun exports "
                f"({', '.join(need)}); launch it as `torchrun --nproc_per_node N -m "
                "vtc_tpu_torch.train ...`")
        raise RuntimeError(f"the distributed topology {need} must be set together; "
                           f"missing: {missing}")
    rank, world = int(have["RANK"]), int(have["WORLD_SIZE"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(have["LOCAL_RANK"]))
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world)
    return rank, world


def rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def world(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0") or 0)


def collective_device(group=None) -> torch.device:
    """Where a tensor must lie for the group's collectives: this process's
    card under NCCL, else the CPU (gloo)."""
    if dist.is_initialized() and dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allgather_varlen(arr, group=None) -> np.ndarray:
    """Concatenate each process's array along its leading axis, in rank
    order: the counts first, then the payload padded to the largest count
    (a collective takes equal shapes). One process: the identity.
    ``vtc_tpu/utils/util.py:allgather_varlen``'s contract on numpy arrays."""
    arr = np.asarray(arr)
    w = world(group)
    if w == 1:
        return arr
    dev = collective_device(group)
    count = torch.tensor([arr.shape[0]], dtype=torch.int64, device=dev)
    counts = [torch.zeros_like(count) for _ in range(w)]
    dist.all_gather(counts, count, group=group)
    counts = [int(c) for c in counts]
    m = max(counts)
    pad = np.zeros((m,) + arr.shape[1:], arr.dtype)
    pad[: arr.shape[0]] = arr
    local = torch.from_numpy(pad).to(dev)
    parts = [torch.empty_like(local) for _ in range(w)]
    dist.all_gather(parts, local, group=group)
    return np.concatenate([p[:c].cpu().numpy() for p, c in zip(parts, counts)])


def all_max(value: int, group=None) -> int:
    """The largest of each process's ``value``."""
    if world(group) == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=collective_device(group))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t)


def broadcast_object(obj, src: int = 0, group=None):
    """``obj`` of rank ``src`` on every process (picklable)."""
    if world(group) == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def barrier(group=None) -> None:
    if world(group) > 1:
        if dist.get_backend(group) == "nccl":
            dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier(group=group)
