"""Model factory: build a retrieval model with the reference's init on the
card (or, when asked, the CPU).

Port of ``vtc_tpu/models/factory.py`` for ``PretrainedCLIP`` and
``PretrainedCLIP_finaltf``. Weights come from a seeded ``torch.Generator``
on the CPU, so one seed gives the same weights on every device; the
distributions follow the JAX package's initializers, the numbers do not (a
test that compares the two carries the JAX weights across with
``from_jax.state_dict_from_jax``). Loading real CLIP weights waits for the
checkpoint files (ROADMAP).
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from ..device import resolve_device
from . import retrieval
from .cam import zero_init_cam_params

ARCHS = {
    "PretrainedCLIP": retrieval.PretrainedCLIP,
    "PretrainedCLIP_finaltf": retrieval.PretrainedCLIP_finaltf,
}

DTYPES = {
    "float32": torch.float32, "fp32": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
}


def _init_std(name: str, p: torch.Tensor, widths: dict) -> Optional[float]:
    """Std of the normal init of one parameter; None for the constant ones
    (LayerNorm ones, biases zeros, logit_scale, final_linear zeros)."""
    leaf = name.rsplit(".", 1)[-1]
    if name.endswith("bias") or ".ln_" in f".{name}" or leaf == "logit_scale":
        return None
    if name.endswith(("in_proj_weight", "out_proj.weight")):
        return 0.02  # torch trunc_normal_(std=.02): bounds at ±100σ
    if name.endswith(("c_fc.weight", "c_proj.weight")):
        return p.shape[1] ** -0.5  # flax lecun_normal
    if name.startswith("model.visual."):  # conv1, class/pos embedding, proj
        return widths["vision"] ** -0.5
    if name == "model.token_embedding.weight":
        return 0.02
    if name == "model.positional_embedding":
        return 0.01
    if name == "model.text_projection":
        return widths["text"] ** -0.5
    if name == "mask_embedding":
        return 1.0
    if name == "final_linear.weight":
        return None
    raise KeyError(f"no init rule for parameter {name}")


@torch.no_grad()
def init_weights(model: torch.nn.Module, seed: int) -> None:
    """Seeded init of every parameter, in ``named_parameters`` order."""
    g = torch.Generator().manual_seed(seed)
    v = model.variant
    widths = {"vision": v.vision_width, "text": v.text_width}
    for name, p in model.named_parameters():
        std = _init_std(name, p, widths)
        if std is not None:
            p.normal_(0.0, std, generator=g)
        elif name.endswith("logit_scale"):
            p.fill_(math.log(1 / 0.07))
        elif name.endswith("bias") or name == "final_linear.weight":
            p.zero_()
        else:  # LayerNorm scale
            p.fill_(1.0)


def create_model(arch: str, model_type: str = "ViT-B/32", seed: int = 0,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 device: Optional[Union[str, torch.device]] = None, **kwargs):
    """Build ``arch`` in eval mode on ``device`` (default: the card; raises
    without one). ``dtype`` is the activation dtype; weights stay fp32 until
    ``convert_weights``. The CAM starts from the reference's zero-init."""
    if arch not in ARCHS:
        raise KeyError(f"Unknown arch {arch!r}; available: {sorted(ARCHS)}")
    device = resolve_device(device)
    if isinstance(dtype, str):
        dtype = DTYPES[dtype]
    model = ARCHS[arch](model_type=model_type, dtype=dtype, **kwargs)
    init_weights(model, seed)
    if isinstance(model, retrieval._CamRetrievalBase):
        zero_init_cam_params(model)
    return model.to(device).eval()


@torch.no_grad()
def convert_weights(model: torch.nn.Module, dtype=torch.bfloat16):
    """Cast the matmul/projection weights to ``dtype`` in place (the analogue
    of ``vtc_tpu.models.factory.convert_weights``): LayerNorm parameters,
    biases, embeddings and ``logit_scale`` stay fp32."""
    for name, p in model.named_parameters():
        keep_fp32 = (
            ".ln_" in f".{name}"
            or name.endswith("bias")
            or "logit_scale" in name
            or "embedding" in name
        )
        if not keep_fp32 and p.dtype == torch.float32:
            p.data = p.data.to(dtype)
    return model
