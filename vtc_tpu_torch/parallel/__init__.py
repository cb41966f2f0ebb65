"""Parallel layers of the port: the mixture-of-experts MLP on one device and
data parallelism on ``torch.distributed`` (``mesh``)."""

from .expert import MoEMLP, moe_layers
from .mesh import data_parallel, shard_batch, unwrap

__all__ = ["MoEMLP", "data_parallel", "moe_layers", "shard_batch", "unwrap"]
