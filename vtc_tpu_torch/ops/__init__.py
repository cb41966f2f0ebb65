"""The port's kernels, each beside its plain PyTorch version.

``layernorm`` and ``add_layernorm`` are Triton kernels; ``fused_mha`` is CUDA
C++ (``csrc/fused_mha.cu``). Each wrapper runs its plain version on a CPU
tensor and its kernel on a CUDA tensor, and counts its kernel launches in
``<wrapper>.launches``.
"""

from .addln import add_layernorm, add_layernorm_plain
from .attention import fused_mha, fused_mha_plain
from .layernorm import layernorm, layernorm_plain

KERNELS = (layernorm, add_layernorm, fused_mha)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


__all__ = [
    "KERNELS",
    "add_layernorm",
    "add_layernorm_plain",
    "fused_mha",
    "fused_mha_plain",
    "launch_counts",
    "layernorm",
    "layernorm_plain",
    "reset_launch_counts",
]
