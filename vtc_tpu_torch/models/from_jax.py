"""Carry the JAX package's parameters into the port's state dict.

``state_dict_from_jax`` takes a ``vtc_tpu`` retrieval model's param tree as
nested dicts of numpy arrays (the caller converts from JAX) and returns the
reference (torch) state-dict names that the port's modules carry:

* a Dense ``kernel`` becomes ``weight = kernel.T``;
* LayerNorm ``scale``/``bias`` become ``weight``/``bias``;
* the ``[3, E, E]``/``[3, E]`` qkv storage becomes ``[3E, E]``/``[3E]``;
* ``conv1 [width, 3·p·p]`` becomes the OIHW conv weight;
* the CAM goes under ``final_transformer.*``, ``final_linear.weight``,
  ``mask_embedding`` and ``mean_center_bn.*``.

Every leaf must be consumed: a leaf with no place in the port (an audio head,
a MoE adapter, a TimeSformer tower) raises instead of being dropped.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


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
    for fc in ("c_fc", "c_proj"):
        sd[f"{dst}.mlp.{fc}.weight"] = r.get(f"{src}/mlp/{fc}/kernel").T
        sd[f"{dst}.mlp.{fc}.bias"] = r.get(f"{src}/mlp/{fc}/bias")


def _blocks(r: _Reader, src: str, sd: Dict, dst: str) -> int:
    i = 0
    while r.has(f"{src}/resblocks_{i}"):
        _block(r, f"{src}/resblocks_{i}", sd, f"{dst}.resblocks.{i}")
        i += 1
    return i


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
    if _blocks(rc, "visual/transformer", sd, "model.visual.transformer") == 0:
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

    leftovers += [f"{k}/..." for k in params if k not in ("clip", "cam")]
    if leftovers:
        raise ValueError(
            "params hold leaves the port has no place for (not dropping "
            f"weights silently): {sorted(leftovers)[:8]}"
            + ("..." if len(leftovers) > 8 else "")
        )
    return {k: torch.from_numpy(np.array(v, order="C", copy=True))
            for k, v in sd.items()}
