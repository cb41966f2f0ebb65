"""Eval throughput of the flagship on the card: the twin of ``bench.py``.

    python -m vtc_tpu_torch.bench

``PretrainedCLIP_finaltf`` (ViT-B/32 towers + the Context Adapter over 5
comments) runs the retrieval-eval forward in bf16 (``convert_weights``) on
``bench.py``'s inputs: uint8 patches, a 16-token title and 5 comments
(``synthetic_tokens``, 14 real tokens). ``BENCH_BATCH`` (160) pairs a
forward; after ``WARMUP`` forwards, three windows of ``BENCH_ITERS`` (96)
forwards, each its work over its time (CUDA events); the value is their
median. Companions, for the flagship only (so
``vs_baseline`` compares like with like):

* ``vs_baseline``: the same forward in fp32 at batch 8 on the host's CPU,
  through the port's plain versions (one window of 2 forwards);
* ``full_context_pairs_per_sec``: 77-token texts at batch 96;
* ``train_samples_per_sec``: ``scripts.bench_train_step`` at batch 128 (3
  windows of 24 steps after 6), skipped with ``BENCH_SKIP_TRAIN=1``;
* ``mfu`` and ``train_mfu``: the FLOPs of a pair (``forward_flops``,
  counted from the model's shapes; a train sample is three forwards' worth)
  times the rate, over the dense bf16 peak of the card named by
  ``torch.cuda.get_device_name`` (``device.PEAK_FLOPS``), with ``device`` the
  card's name and power limit as ``nvidia-smi`` reads them.

``BENCH_MODEL`` (``ViT-B/16``, ``ViT-L/14``) prints the single-row form for
that variant. It prints ONE JSON line. It needs a card unless ``main`` is
told ``device="cpu"`` (the tests), and then no device metric is given.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
from typing import Optional

import numpy as np
import torch

from .data import extract_patches, synthetic_tokens
from .device import CARD, PEAK_FLOPS, resolve_device
from .models import convert_weights, create_model
from .models.clip_model import CLIP_VARIANTS, ClipVariant
from .utils.timing import windows_ms

FLAGSHIP = "ViT-B/32"
WARMUP = 3
N_COMMENTS = 5
CAM_LAYERS = 2  # the flagship's Context Adapter


def block_flops(tokens: int, width: int) -> int:
    """One residual attention block on one sequence: the qkv, output and
    MLP GEMMs (24·L·w²) and QKᵀ and P·V (4·L²·w, every (query, key) pair,
    as the plain version computes them)."""
    return 24 * tokens * width**2 + 4 * tokens**2 * width


def forward_flops(v: ClipVariant, batch: int, ntoks: int = 16,
                  n_comments: int = N_COMMENTS) -> int:
    """Multiply-add FLOPs (2 per product) of one eval forward of the flagship
    at ``batch`` pairs on uint8 patches: the patch embedding and its folded
    bias, the image tower, 1 + ``n_comments`` texts a pair through the text
    tower, the CAM over 1 + ``n_comments`` tokens and the ``batch²``
    similarities. LayerNorms, softmaxes and elementwise work are left out."""
    n_patches = (v.input_resolution // v.patch_size) ** 2
    patch_dim = 3 * v.patch_size**2
    image = (2 * n_patches * patch_dim * v.vision_width
             + v.vision_layers * block_flops(n_patches + 1, v.vision_width)
             + 2 * v.vision_width * v.embed_dim)
    texts = 1 + n_comments
    text = texts * (v.text_layers * block_flops(ntoks, v.text_width)
                    + 2 * v.text_width * v.embed_dim)
    cam = CAM_LAYERS * block_flops(1 + n_comments, v.embed_dim)
    return (batch * (image + text + cam) + 2 * patch_dim * v.vision_width
            + 2 * batch * batch * v.embed_dim)


def bench_inputs(v: ClipVariant, batch: int, ntoks: int, device, seed: int = 0):
    """bench.py's inputs: uint8 patches, title and 5 comments."""
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, (batch, v.input_resolution, v.input_resolution, 3),
                      dtype=np.uint8)
    vis = extract_patches(u8, v.patch_size)
    title = synthetic_tokens((batch,), ntoks, 14, rng)
    comments = synthetic_tokens((batch, N_COMMENTS), ntoks, 14, rng)
    return [torch.from_numpy(a).to(device) for a in (vis, title, comments)]


def run(batch: int, iters: int, warmup: int, dtype_name: str, ntoks: int = 16,
        windows: int = 3, model_type: str = FLAGSHIP, device=None) -> float:
    """Pairs/s of the eval forward: the median of ``windows`` windows of
    ``iters`` forwards, after ``warmup``."""
    device = resolve_device(device)
    model = create_model("PretrainedCLIP_finaltf", model_type=model_type, seed=0,
                         dtype=dtype_name, device=device).eval()
    if dtype_name == "bf16":
        convert_weights(model)
    inputs = bench_inputs(CLIP_VARIANTS[model_type], batch, ntoks, device)
    with torch.inference_mode():
        ms = windows_ms(lambda: model(*inputs), device, iters, warmup, windows)
    return batch * 1e3 / statistics.median(ms)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _stderr(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def peak_bf16(device) -> Optional[float]:
    """The dense bf16 peak of the card, or None off it (or on another card)."""
    if device.type != "cuda" or CARD not in torch.cuda.get_device_name(device):
        return None
    return PEAK_FLOPS[torch.bfloat16]


def main(env=None, device=None, flagship: str = FLAGSHIP) -> dict:
    """Measures, prints the JSON line and returns it. ``flagship`` is the
    variant whose row carries the companions (the tests' ``test-tiny``)."""
    env = os.environ if env is None else env
    device = resolve_device(device)
    batch = int(env.get("BENCH_BATCH", 160))
    iters = int(env.get("BENCH_ITERS", 96))
    model_type = env.get("BENCH_MODEL", flagship)
    v = CLIP_VARIANTS[model_type]
    peak = peak_bf16(device)
    pps = run(batch, iters, WARMUP, "bf16", model_type=model_type, device=device)
    result = {"metric": "eval_clip_pairs_per_sec_per_chip", "value": round(pps, 2),
              "unit": "pairs/s"}

    def mfu(rate, flops_per_item):
        return None if peak is None else round(rate * flops_per_item / peak, 4)

    pair_flops = forward_flops(v, batch) / batch
    device_info = card_line() if device.type == "cuda" else "cpu"
    if model_type != flagship:
        result.update(model=model_type, vs_baseline=None, mfu=mfu(pps, pair_flops),
                      device=device_info)
        print(json.dumps(result), flush=True)
        return result

    if env.get("BENCH_SKIP_FULL_CONTEXT") != "1":
        result["full_context_pairs_per_sec"] = round(
            run(96, 8, 2, "bf16", ntoks=77, model_type=model_type, device=device), 2)
    cpu_pps = run(8, 2, 1, "fp32", windows=1, model_type=model_type, device="cpu")
    result["vs_baseline"] = round(pps / cpu_pps, 2)
    result["quality_parity"] = (
        "asset-gated: needs real CLIP weights (VTC_CLIP_WEIGHTS) and the BPE merges")
    result["mfu"] = mfu(pps, pair_flops)
    if env.get("BENCH_SKIP_TRAIN") != "1":
        from .scripts import bench_train_step

        train_batch = 128
        sps = bench_train_step.main(train_batch, 16, iters=24, warmup=6,
                                    model_type=model_type, device=device,
                                    log=_stderr)["samples_per_s"]
        result["train_samples_per_sec"] = round(sps, 2)
        result["train_mfu"] = mfu(sps, 3 * forward_flops(v, train_batch) / train_batch)
    result["device"] = device_info
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
