"""CLIP weight import for ``create_model``: the port's own copy of
``find_clip_weights`` and ``load_openai_state_dict``
(``vtc_tpu/models/factory.py:73-105``) and of the import at ``:137-192``.

The port's modules carry openai CLIP's names under ``model.``, so an openai
state dict (a TorchScript archive from ``clip.load``'s distribution, a plain
``state_dict``, or a reference retrieval checkpoint wrapping CLIP under
``model.``) loads as it is: every ``model.*`` parameter of the built model
takes the file's tensor of the same name, strictly (a missing name or a
shape that differs raises). A HuggingFace ``CLIPModel`` directory goes
through ``transformers`` and its names are mapped onto openai's, as
``vtc_tpu/models/torch_import.py:153-206`` maps them. A TimeSformer arch
takes CLIP's visual tower through ``timesformer_params_from_clip_visual``.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import torch

from .timesformer import TimeSformer, timesformer_params_from_clip_visual

logger = logging.getLogger(__name__)


def find_clip_weights(path: Optional[str] = None) -> Optional[str]:
    """``path`` if it exists, else ``$VTC_CLIP_WEIGHTS`` if it exists, else
    None (the model keeps its seeded weights)."""
    for p in (path, os.environ.get("VTC_CLIP_WEIGHTS")):
        if p and os.path.exists(p):
            return p
    return None


def load_openai_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """openai CLIP distributions are TorchScript archives; else a plain
    ``state_dict``, unwrapped from ``{"state_dict": ...}`` and from the
    reference retrieval checkpoints' ``model.`` prefix."""
    try:
        return torch.jit.load(path, map_location="cpu").state_dict()
    except Exception:
        obj = torch.load(path, map_location="cpu", weights_only=False)
        sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
        if isinstance(sd, dict) and not any(k.startswith("visual.") for k in sd):
            prefixed = {k[len("model."):]: v for k, v in sd.items()
                        if k.startswith("model.")}
            if any(k.startswith("visual.") for k in prefixed):
                sd = prefixed
        return sd


def _hf_block(sd, src: str, out: Dict, dst: str) -> None:
    attn = f"{src}.self_attn"
    out[f"{dst}.attn.in_proj_weight"] = torch.cat(
        [sd[f"{attn}.{p}_proj.weight"] for p in "qkv"], 0)
    out[f"{dst}.attn.in_proj_bias"] = torch.cat([sd[f"{attn}.{p}_proj.bias"] for p in "qkv"])
    for name in ("weight", "bias"):
        out[f"{dst}.attn.out_proj.{name}"] = sd[f"{attn}.out_proj.{name}"]
        out[f"{dst}.ln_1.{name}"] = sd[f"{src}.layer_norm1.{name}"]
        out[f"{dst}.ln_2.{name}"] = sd[f"{src}.layer_norm2.{name}"]
        out[f"{dst}.mlp.c_fc.{name}"] = sd[f"{src}.mlp.fc1.{name}"]
        out[f"{dst}.mlp.c_proj.{name}"] = sd[f"{src}.mlp.fc2.{name}"]


def openai_from_hf(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A HuggingFace ``CLIPModel.state_dict()`` under openai CLIP's names and
    layouts (the projections transposed, q, k and v concatenated)."""
    out = {
        "visual.conv1.weight": sd["vision_model.embeddings.patch_embedding.weight"],
        "visual.class_embedding": sd["vision_model.embeddings.class_embedding"],
        "visual.positional_embedding":
            sd["vision_model.embeddings.position_embedding.weight"],
        "visual.proj": sd["visual_projection.weight"].T,
        "token_embedding.weight": sd["text_model.embeddings.token_embedding.weight"],
        "positional_embedding": sd["text_model.embeddings.position_embedding.weight"],
        "text_projection": sd["text_projection.weight"].T,
        "logit_scale": sd["logit_scale"],
    }
    for name in ("weight", "bias"):
        # "pre_layrnorm" is HF's own spelling
        out[f"visual.ln_pre.{name}"] = sd[f"vision_model.pre_layrnorm.{name}"]
        out[f"visual.ln_post.{name}"] = sd[f"vision_model.post_layernorm.{name}"]
        out[f"ln_final.{name}"] = sd[f"text_model.final_layer_norm.{name}"]
    for tower, dst in (("vision_model", "visual.transformer"), ("text_model", "transformer")):
        i = 0
        while f"{tower}.encoder.layers.{i}.layer_norm1.weight" in sd:
            _hf_block(sd, f"{tower}.encoder.layers.{i}", out, f"{dst}.resblocks.{i}")
            i += 1
    return out


def read_clip_weights(path: str) -> Dict[str, torch.Tensor]:
    """openai-named CLIP tensors from ``path``: a HuggingFace directory
    (needs ``transformers``) or an openai file."""
    if os.path.isdir(path):
        try:
            from transformers import CLIPModel
        except ImportError as e:
            raise RuntimeError(
                f"{path} is a directory (HuggingFace CLIP format) but transformers "
                f"is unavailable: {e}")
        return openai_from_hf(CLIPModel.from_pretrained(path).state_dict())
    return load_openai_state_dict(path)


@torch.no_grad()
def import_clip_weights(model: torch.nn.Module, path: str, seed: int = 0) -> None:
    """Load CLIP's tensors from ``path`` into every ``model.*`` parameter of
    ``model`` (strict: each must be in the file, at its shape). A
    TimeSformer tower takes CLIP's visual tower through
    ``timesformer_params_from_clip_visual`` with ``seed`` for its new time
    attention."""
    sd = read_clip_weights(path)
    visual = model.model.visual
    if isinstance(visual, TimeSformer):
        tower = {k[len("visual."):]: v for k, v in sd.items() if k.startswith("visual.")}
        tower = timesformer_params_from_clip_visual(
            tower, visual.variant, nframes=visual.nframes, seed=seed)
        sd = {**{k: v for k, v in sd.items() if not k.startswith("visual.")},
              **{f"visual.{k}": v for k, v in tower.items()}}
    own = [k for k in model.state_dict() if k.startswith("model.")]
    missing = [k for k in own if k[len("model."):] not in sd]
    if missing:
        raise KeyError(f"{path}: no tensor for {missing[:8]}"
                       + ("..." if len(missing) > 8 else ""))
    _, unexpected = model.load_state_dict(
        {k: sd[k[len("model."):]] for k in own}, strict=False)
    assert not unexpected, unexpected
