"""Parallel layers of the port: the mixture-of-experts MLP on one device,
the ``("data", "model")`` mesh on ``torch.distributed`` (``mesh``) and
tensor parallelism over its model axis (``tensor``)."""

from .expert import MoEMLP, moe_layers
from .mesh import create_mesh, data_parallel, shard_batch, unwrap
from .tensor import shard_model

__all__ = ["MoEMLP", "create_mesh", "data_parallel", "moe_layers", "shard_batch",
           "shard_model", "unwrap"]
