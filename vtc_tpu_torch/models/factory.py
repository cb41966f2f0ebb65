"""Model factory: build a retrieval model with the reference's init on the
card (or, when asked, the CPU).

Port of ``vtc_tpu/models/factory.py`` for ``PretrainedCLIP``,
``PretrainedCLIP_finaltf`` and the TimeSformer video models
``PretrainedCLIP_TimeSformer(_finaltf)``. Weights come from a seeded ``torch.Generator``
on the CPU, so one seed gives the same weights on every device; the
distributions follow the JAX package's initializers, the numbers do not (a
test that compares the two carries the JAX weights across with
``from_jax.state_dict_from_jax``). CLIP weights, where ``clip_weights`` or
``$VTC_CLIP_WEIGHTS`` names them, replace the seeded CLIP towers
(``clip_import``); the TimeSformer models take the CLIP visual tower through
``timesformer.timesformer_params_from_clip_visual``, as the JAX factory
does, and the CAM keeps its zero-init.
"""

from __future__ import annotations

import logging
import math
from typing import Callable, Optional, Union

import torch

from ..device import resolve_device
from . import retrieval
from .cam import zero_init_cam_params
from .clip_import import find_clip_weights, import_clip_weights

logger = logging.getLogger(__name__)

ARCHS = {
    "PretrainedCLIP": retrieval.PretrainedCLIP,
    "PretrainedCLIP_finaltf": retrieval.PretrainedCLIP_finaltf,
    "PretrainedCLIP_TimeSformer": retrieval.PretrainedCLIP_TimeSformer,
    "PretrainedCLIP_TimeSformer_finaltf": retrieval.PretrainedCLIP_TimeSformer_finaltf,
}

DTYPES = {
    "float32": torch.float32, "fp32": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
}

# the CAM's parameters: what ``freeze: "finaltf"`` freezes
ADAPTER_PREFIXES = ("final_transformer.", "final_linear.", "mask_embedding",
                    "mean_center_bn.")


def frozen_predicate(freeze) -> Callable[[str], bool]:
    """Which parameters ``freeze`` freezes (reference
    ``model/model.py:268-305``). The reference's 'text' freezes only the
    text *transformer* (not the embeddings, ``ln_final`` or
    ``text_projection``); an unknown spec raises rather than train a
    "frozen" branch at full lr."""
    if freeze in (False, None, "none"):
        return lambda name: False
    spec = str(freeze)
    known = ("all", "visual", "text", "finaltf")
    if not any(k in spec for k in known):
        raise ValueError(
            f"Unknown branch_to_freeze {freeze!r}; expected "
            f"False/'none' or a string containing one of {known}"
        )

    def frozen(name: str) -> bool:
        return (("all" in spec and name.startswith("model."))
                or ("visual" in spec and name.startswith("model.visual."))
                or ("text" in spec and name.startswith("model.transformer."))
                or ("finaltf" in spec and name.startswith(ADAPTER_PREFIXES)))

    return frozen


def _is_zero_init(name: str) -> bool:
    """Biases, ``final_linear`` (``cam.py``), and the TimeSformer's
    ``temporal_fc`` and ``temporal_embed`` (``timesformer.py:69-72,151-154``:
    the divided block starts as a no-op)."""
    return (name.endswith("bias") or name == "final_linear.weight"
            or ".temporal_fc." in name or name.endswith(".temporal_embed"))


def _init_std(name: str, p: torch.Tensor, widths: dict) -> Optional[float]:
    """Std of the normal init of one parameter; None for the constant ones
    (LayerNorm ones, the zero-init ones, logit_scale)."""
    leaf = name.rsplit(".", 1)[-1]
    if _is_zero_init(name) or ".ln_" in f".{name}" or leaf == "logit_scale":
        return None
    if name.endswith(("in_proj_weight", "out_proj.weight")):
        # attn and timeattn: torch trunc_normal_(std=.02), bounds at ±100σ
        return 0.02
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
        elif _is_zero_init(name):
            p.zero_()
        else:  # LayerNorm scale (ln_time too)
            p.fill_(1.0)


def create_model(arch: str, model_type: str = "ViT-B/32", seed: int = 0,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 device: Optional[Union[str, torch.device]] = None,
                 clip_weights: Optional[str] = None, **kwargs):
    """Build ``arch`` in eval mode on ``device`` (default: the card; raises
    without one). ``dtype`` is the activation dtype; weights stay fp32 until
    ``convert_weights``. The CLIP towers come from ``clip_weights`` (a file
    or a HuggingFace directory), else ``$VTC_CLIP_WEIGHTS``, else ``seed``
    (``find_clip_weights``). The CAM starts from the reference's zero-init.
    The parameters of the branches that ``freeze`` names get
    ``requires_grad=False`` (``frozen_predicate``), so the optimizer leaves
    them out."""
    if arch not in ARCHS:
        raise KeyError(f"Unknown arch {arch!r}; available: {sorted(ARCHS)}")
    device = resolve_device(device)
    if isinstance(dtype, str):
        dtype = DTYPES[dtype]
    # torch-only arguments of the reference's configs, as the JAX factory takes them
    kwargs.pop("audio_model_ckpt", None)
    clip_audio_ckpt = kwargs.pop("clip_audio_ckpt", None)
    model = ARCHS[arch](model_type=model_type, dtype=dtype, **kwargs)
    init_weights(model, seed)
    # the audio checkpoint supplies the CLIP towers only where the audio
    # branch is built, as in the JAX factory
    use_audio_ckpt = clip_audio_ckpt and getattr(model, "init_audio_model", True)
    weights = find_clip_weights(clip_audio_ckpt if use_audio_ckpt else clip_weights)
    if weights is not None:
        from ..data.tokenizer import get_tokenizer

        if not get_tokenizer().is_exact:
            logger.warning(
                "Real CLIP weights (%s) combined with the FALLBACK byte-level BPE "
                "vocabulary: token ids will not match the checkpoint's training "
                "vocabulary and text embeddings will be wrong. Provision the merges "
                "file via VTC_BPE_VOCAB.", weights)
        import_clip_weights(model, weights, seed)
    if isinstance(model, retrieval._CamRetrievalBase):
        zero_init_cam_params(model)
    frozen = frozen_predicate(model.freeze)
    for name, p in model.named_parameters():
        p.requires_grad_(not frozen(name))
    return model.to(device).eval()


@torch.no_grad()
def convert_weights(model: torch.nn.Module, dtype=torch.bfloat16):
    """Cast the matmul/projection weights to ``dtype`` in place (the analogue
    of ``vtc_tpu.models.factory.convert_weights``): LayerNorm parameters,
    biases, embeddings (``temporal_embed`` too, ``factory.py:223``) and
    ``logit_scale`` stay fp32."""
    for name, p in model.named_parameters():
        keep_fp32 = (
            ".ln_" in f".{name}"
            or name.endswith("bias")
            or "logit_scale" in name
            or "embedding" in name
            or "temporal_embed" in name
        )
        if not keep_fp32 and p.dtype == torch.float32:
            p.data = p.data.to(dtype)
    return model
