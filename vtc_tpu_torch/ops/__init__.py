"""The port's kernels, each beside its plain PyTorch version.

``layernorm`` and ``add_layernorm`` are Triton kernels; ``fused_mha``,
``fused_attention`` and the LN sweep's ``ln_mxu`` and ``ln_mxu_bf16`` are
CUDA C++ (``csrc/*.cu``). Each wrapper runs its plain
version on a CPU tensor and its kernel on a CUDA tensor, and counts its
kernel launches in ``<wrapper>.launches`` (forward launches only).
``fused_mha``'s long route (L > 128) counts its own, in
``fused_mha_long.launches``. The four
model kernels take a gradient: each has its backward in PyTorch ops
(``*_backward``), the math of the JAX kernel's own ``custom_vjp`` backward.
"""

from .addln import add_layernorm, add_layernorm_backward, add_layernorm_plain
from .attention import (
    attention_backward,
    causal_mask,
    fused_attention,
    fused_attention_plain,
    fused_mha,
    fused_mha_long,
    fused_mha_plain,
    mha_backward,
)
from .layernorm import layernorm, layernorm_backward, layernorm_plain
from .ln_designs import ln_mxu, ln_mxu_bf16, ln_mxu_bf16_plain, ln_mxu_plain

KERNELS = (layernorm, add_layernorm, fused_mha, fused_attention, ln_mxu, ln_mxu_bf16,
           fused_mha_long)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


__all__ = [
    "KERNELS",
    "add_layernorm",
    "add_layernorm_backward",
    "add_layernorm_plain",
    "attention_backward",
    "causal_mask",
    "fused_attention",
    "fused_attention_plain",
    "fused_mha",
    "fused_mha_long",
    "fused_mha_plain",
    "launch_counts",
    "layernorm",
    "layernorm_backward",
    "layernorm_plain",
    "ln_mxu",
    "ln_mxu_bf16",
    "ln_mxu_bf16_plain",
    "ln_mxu_plain",
    "mha_backward",
    "reset_launch_counts",
]
