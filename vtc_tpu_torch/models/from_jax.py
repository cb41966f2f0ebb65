"""Carry the JAX package's parameters into the port's state dict.

``state_dict_from_jax`` takes a ``vtc_tpu`` retrieval model's param tree as
nested dicts of numpy arrays (the caller converts from JAX) and returns the
reference (torch) state-dict names that the port's modules carry:

* a Dense ``kernel`` becomes ``weight = kernel.T``;
* LayerNorm ``scale``/``bias`` become ``weight``/``bias``;
* the ``[3, E, E]``/``[3, E]`` qkv storage becomes ``[3E, E]``/``[3E]``;
* ``conv1 [width, 3·p·p]`` becomes the OIHW conv weight;
* the CAM goes under ``final_transformer.*``, ``final_linear.weight``,
  ``mask_embedding`` and ``mean_center_bn.*``;
* a TimeSformer tower's blocks, hoisted flat as
  ``visual/transformer_resblocks_{i}`` with ``timeattn``, ``ln_time`` and
  ``temporal_fc`` beside the ViT block's leaves, go under
  ``model.visual.transformer.resblocks.{i}``, and ``visual/temporal_embed``
  under ``model.visual.temporal_embed`` (the names of
  ``vtc_tpu.models.torch_export.export_vtc_state_dict``).

* the audio MLP (``audio_mlp``: ``fc1``, ``bn``, ``fc2``) goes under
  ``audio_model.mlp.layers.{1,2,4}``, the names of ``torch_export``, its
  BatchNorm's ``mean``/``var`` from ``batch_stats["audio_mlp"]["bn"]``;
* a MoE adapter block's expert stacks (``mlp_moe``) go under
  ``final_transformer.resblocks.{i}.mlp_moe.{router,w_fc,bias_fc,w_proj,
  bias_proj}`` in their JAX layout: names of the port's own, as the
  reference export has none.

``plain_state_dict_from_jax`` carries a baseline (``MLP``,
``JointEmbedding``, ``CLIP``) across. Every leaf must be consumed: a leaf
with no place in the port raises instead of being dropped.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .layers import bn_state_from_jax

MOE_LEAVES = ("router", "w_fc", "bias_fc", "w_proj", "bias_proj")


class _Reader:
    """Leaf access that records what was read."""

    def __init__(self, tree: Dict):
        self.tree = tree
        self.seen = set()

    def get(self, path: str) -> np.ndarray:
        node = self.tree
        for k in path.split("/"):
            node = node[k]
        self.seen.add(path)
        return np.asarray(node, dtype=np.float32)

    def has(self, path: str) -> bool:
        node = self.tree
        for k in path.split("/"):
            if not isinstance(node, dict) or k not in node:
                return False
            node = node[k]
        return True

    def unconsumed(self, prefix: str = ""):
        out = []

        def walk(node, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, f"{path}/{k}" if path else k)
            elif path not in self.seen:
                out.append(prefix + path)

        walk(self.tree, "")
        return out


def _block(r: _Reader, src: str, sd: Dict, dst: str) -> None:
    def qkv(w):
        return w.reshape((w.shape[0] * w.shape[1],) + w.shape[2:])

    sd[f"{dst}.attn.in_proj_weight"] = qkv(r.get(f"{src}/attn/in_proj_weight"))
    sd[f"{dst}.attn.in_proj_bias"] = qkv(r.get(f"{src}/attn/in_proj_bias"))
    sd[f"{dst}.attn.out_proj.weight"] = r.get(f"{src}/attn/out_proj/kernel").T
    sd[f"{dst}.attn.out_proj.bias"] = r.get(f"{src}/attn/out_proj/bias")
    for ln in ("ln_1", "ln_2"):
        sd[f"{dst}.{ln}.weight"] = r.get(f"{src}/{ln}/scale")
        sd[f"{dst}.{ln}.bias"] = r.get(f"{src}/{ln}/bias")
    if r.has(f"{src}/mlp_moe"):  # a MoE block: the expert stacks as they are
        for leaf in MOE_LEAVES:
            sd[f"{dst}.mlp_moe.{leaf}"] = r.get(f"{src}/mlp_moe/{leaf}")
    else:
        for fc in ("c_fc", "c_proj"):
            sd[f"{dst}.mlp.{fc}.weight"] = r.get(f"{src}/mlp/{fc}/kernel").T
            sd[f"{dst}.mlp.{fc}.bias"] = r.get(f"{src}/mlp/{fc}/bias")
    if r.has(f"{src}/timeattn"):  # a TimeSformer block
        sd[f"{dst}.timeattn.in_proj_weight"] = qkv(r.get(f"{src}/timeattn/in_proj_weight"))
        sd[f"{dst}.timeattn.in_proj_bias"] = qkv(r.get(f"{src}/timeattn/in_proj_bias"))
        sd[f"{dst}.timeattn.out_proj.weight"] = r.get(f"{src}/timeattn/out_proj/kernel").T
        sd[f"{dst}.timeattn.out_proj.bias"] = r.get(f"{src}/timeattn/out_proj/bias")
        sd[f"{dst}.ln_time.weight"] = r.get(f"{src}/ln_time/scale")
        sd[f"{dst}.ln_time.bias"] = r.get(f"{src}/ln_time/bias")
        sd[f"{dst}.temporal_fc.weight"] = r.get(f"{src}/temporal_fc/kernel").T
        sd[f"{dst}.temporal_fc.bias"] = r.get(f"{src}/temporal_fc/bias")


def _blocks(r: _Reader, src: str, sd: Dict, dst: str, sep: str = "/") -> int:
    """Blocks ``{src}{sep}resblocks_{i}`` -> ``{dst}.resblocks.{i}``; the
    TimeSformer hoists them flat (``sep="_"``)."""
    i = 0
    while r.has(f"{src}{sep}resblocks_{i}"):
        _block(r, f"{src}{sep}resblocks_{i}", sd, f"{dst}.resblocks.{i}")
        i += 1
    return i


def _mlp(r: _Reader, stats: Optional[Dict], sd: Dict, dst: str, at) -> None:
    """``fc1``, ``bn``, ``fc2`` -> ``{dst}.{i}`` for the indices ``at``."""
    i1, ibn, i2 = at
    for i, fc in ((i1, "fc1"), (i2, "fc2")):
        sd[f"{dst}.{i}.weight"] = r.get(f"{fc}/kernel").T
        sd[f"{dst}.{i}.bias"] = r.get(f"{fc}/bias")
    bn = (stats or {}).get("bn") or {}
    for k, v in bn_state_from_jax(r.get("bn/scale"), r.get("bn/bias"), bn.get("mean"),
                                  bn.get("var")).items():
        sd[f"{dst}.{ibn}.{k}"] = v


def _to_torch(sd: Dict) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, order="C", copy=True)) for k, v in sd.items()}


def plain_state_dict_from_jax(params: Dict, batch_stats: Optional[Dict] = None
                              ) -> Dict[str, torch.Tensor]:
    """A JAX ``MLP`` (``fc1``/``bn``/``fc2`` -> ``layers.{1,2,4}``) or
    ``JointEmbedding``/``CLIP`` (``branch_{a,b}`` -> ``branch_{a,b}.layers.
    {0,1,3}``, ``temperature``) -> the port's state dict."""
    sd: Dict[str, np.ndarray] = {}
    stats = batch_stats or {}
    if "fc1" in params:
        r = _Reader(params)
        _mlp(r, stats, sd, "layers", (1, 2, 4))
        leftovers = r.unconsumed()
    else:
        leftovers = [k for k in params if k not in ("branch_a", "branch_b", "temperature")]
        for branch in ("branch_a", "branch_b"):
            r = _Reader(params[branch])
            _mlp(r, stats.get(branch), sd, f"{branch}.layers", (0, 1, 3))
            leftovers += r.unconsumed(f"{branch}/")
        if "temperature" in params:
            sd["temperature"] = np.asarray(params["temperature"], np.float32)
    if leftovers:
        raise ValueError(f"params hold leaves the port has no place for: {leftovers[:8]}")
    return _to_torch(sd)


def state_dict_from_jax(params: Dict, batch_stats: Optional[Dict] = None
                        ) -> Dict[str, torch.Tensor]:
    """JAX retrieval-model params (numpy leaves) -> the port's state dict."""
    if "clip" not in params:
        raise ValueError("state_dict_from_jax needs a 'clip' tower")
    sd: Dict[str, np.ndarray] = {}
    rc = _Reader(params["clip"])
    conv = rc.get("visual/conv1")
    p = int(round((conv.shape[1] / 3) ** 0.5))
    sd["model.visual.conv1.weight"] = conv.reshape(conv.shape[0], 3, p, p)
    for name in ("class_embedding", "positional_embedding", "proj"):
        sd[f"model.visual.{name}"] = rc.get(f"visual/{name}")
    for ln in ("ln_pre", "ln_post"):
        sd[f"model.visual.{ln}.weight"] = rc.get(f"visual/{ln}/scale")
        sd[f"model.visual.{ln}.bias"] = rc.get(f"visual/{ln}/bias")
    if rc.has("visual/temporal_embed"):  # a TimeSformer tower
        sd["model.visual.temporal_embed"] = rc.get("visual/temporal_embed")
        n_blocks = _blocks(rc, "visual/transformer", sd, "model.visual.transformer",
                           sep="_")
    else:
        n_blocks = _blocks(rc, "visual/transformer", sd, "model.visual.transformer")
    if n_blocks == 0:
        raise ValueError("no visual transformer blocks found")
    sd["model.token_embedding.weight"] = rc.get("text/token_embedding")
    sd["model.positional_embedding"] = rc.get("text/positional_embedding")
    sd["model.ln_final.weight"] = rc.get("text/ln_final/scale")
    sd["model.ln_final.bias"] = rc.get("text/ln_final/bias")
    sd["model.text_projection"] = rc.get("text/text_projection")
    _blocks(rc, "text/transformer", sd, "model.transformer")
    sd["model.logit_scale"] = rc.get("logit_scale")
    leftovers = rc.unconsumed("clip/")

    if "cam" in params:
        cam = _Reader(params["cam"])
        _blocks(cam, "final_transformer", sd, "final_transformer")
        sd["final_linear.weight"] = cam.get("final_linear").T
        sd["mask_embedding"] = cam.get("mask_embedding")
        leftovers += cam.unconsumed("cam/")
        bs = (batch_stats or {}).get("cam")
        if bs:
            sd["mean_center_bn.running_mean"] = np.asarray(bs["mean"], np.float32)
            sd["mean_center_bn.running_var"] = np.asarray(bs["var"], np.float32)
            sd["mean_center_bn.num_batches_tracked"] = np.asarray(0, np.int64)

    if "audio_mlp" in params:
        au = _Reader(params["audio_mlp"])
        _mlp(au, (batch_stats or {}).get("audio_mlp"), sd, "audio_model.mlp.layers",
             (1, 2, 4))
        leftovers += au.unconsumed("audio_mlp/")

    leftovers += [f"{k}/..." for k in params if k not in ("clip", "cam", "audio_mlp")]
    if leftovers:
        raise ValueError(
            "params hold leaves the port has no place for (not dropping "
            f"weights silently): {sorted(leftovers)[:8]}"
            + ("..." if len(leftovers) > 8 else "")
        )
    return _to_torch(sd)
