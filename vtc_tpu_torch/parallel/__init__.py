"""Parallel layers of the port: the mixture-of-experts MLP and the expert
axis (``expert``), the ``("data", second axis)`` meshes on
``torch.distributed`` (``mesh``), tensor parallelism over the model axis
(``tensor``) and GPipe over the pipe axis (``pipeline``, switched on for the
models' stacks by ``stack``)."""

from .expert import MoEMLP, create_ep_mesh, moe_layers, shard_experts
from .mesh import create_mesh, data_parallel, shard_batch, unwrap
from .pipeline import create_pipeline_mesh
from .tensor import shard_model

__all__ = ["MoEMLP", "create_ep_mesh", "create_mesh", "create_pipeline_mesh",
           "data_parallel", "moe_layers", "shard_batch", "shard_experts", "shard_model",
           "unwrap"]
