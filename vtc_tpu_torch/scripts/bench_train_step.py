"""Throughput of the flagship's full train step on the card.

    python -m vtc_tpu_torch.scripts.bench_train_step [batch] [ntoks] [arch] [frames] [iters]
        [--accum_steps K] [--moments_dtype bfloat16]

The port's twin of ``scripts/bench_train_step.py`` (``:22-80``) with its
uint8 patch input (``VTC_BENCH_PATCHES=1``): ``PretrainedCLIP_finaltf`` at
ViT-B/32, batch 128, a 16-token title and 5 comments (``synthetic_tokens``,
14 real tokens), bf16 activations over fp32 weights, Adam with amsgrad at lr
1e-5 (``adapter_lr`` 1e-4, ``time_lr`` 1e-5), StepLR(10, 0.1) at 100 steps
per epoch. Each step is ``training.train_step``: forward, ``clip_loss``,
backward, optimizer, scheduler. The CAM's random adapter skip draws from one
seeded generator, fresh masks every step, as in training.

``--accum_steps K`` takes each step as the GradCache accumulation over K
microbatches (``trainer.accum_steps``); ``--moments_dtype bfloat16`` stores
Adam's moments in bf16 (``optimizer.args.moments_dtype``). ``main``'s
``model_kwargs`` reach ``create_model`` (``chip_smoke.py`` steps the MoE
adapter, ``moe_experts=4, moe_top_k=2, freeze="all"``, beside the dense
one with the same freeze).

After ``warmup`` steps it times ``windows`` windows of ``iters`` steps, with
``torch.cuda.synchronize()`` around each, and prints samples/s over all of
them with each window's rate. It needs a card and raises without one.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..data import extract_patches, synthetic_tokens
from ..device import resolve_device
from ..models import create_model
from ..ops.losses import clip_loss
from ..training import build_optimizer, train_step

OPTIMIZER = {"type": "Adam", "args": {"lr": 1e-5, "amsgrad": True}}
SCHEDULER = {"type": "StepLR", "args": {"step_size": 10, "gamma": 0.1}}
STEPS_PER_EPOCH = 100
SEED = 0


def setup(batch: int = 128, ntoks: int = 16, arch: str = "PretrainedCLIP_finaltf",
          frames: int = 0, moments_dtype=None, model_kwargs=None):
    """``(model, optimizer, scheduler, data)`` on the card, the JAX script's
    configuration; ``data`` is (uint8 patches, title, comments)."""
    device = resolve_device()
    kwargs = dict(model_kwargs or {}, **({"nframes": frames} if frames else {}))
    model = create_model(arch, model_type="ViT-B/32", seed=SEED, dtype="bf16",
                         device=device, **kwargs)
    optimizer_cfg = dict(OPTIMIZER, args=dict(OPTIMIZER["args"], moments_dtype=moments_dtype))
    optimizer, scheduler = build_optimizer(
        model, optimizer_cfg, SCHEDULER, steps_per_epoch=STEPS_PER_EPOCH,
        adapter_lr=1e-4, time_lr=1e-5,
    )
    rng = np.random.default_rng(SEED)
    lead = (batch, frames) if frames else (batch,)
    vis = extract_patches(rng.integers(0, 256, lead + (224, 224, 3), dtype=np.uint8), 32)
    title = synthetic_tokens((batch,), ntoks, 14, rng)
    comments = synthetic_tokens((batch, 5), ntoks, 14, rng)
    data = [torch.from_numpy(a).to(device) for a in (vis, title, comments)]
    return model, optimizer, scheduler, data


def main(batch: int = 128, ntoks: int = 16, arch: str = "PretrainedCLIP_finaltf",
         frames: int = 0, iters: int = 8, warmup: int = 3, windows: int = 3,
         accum_steps: int = 1, moments_dtype=None, model_kwargs=None) -> dict:
    """Runs the benchmark; returns ``{"samples_per_s", "window_rates",
    "losses", "setup"}``: ``losses`` has every step's loss, warm-up
    included, and ``setup`` is what ``setup`` built, for a caller that
    goes on stepping (the profiler windows of ``chip_smoke.py``)."""
    model, optimizer, scheduler, data = built = setup(batch, ntoks, arch, frames,
                                                      moments_dtype, model_kwargs)
    generator = torch.Generator(device=data[0].device).manual_seed(SEED)
    losses = []

    def step():
        loss, _ = train_step(model, clip_loss, optimizer, scheduler, data, {}, generator,
                             accum_steps=accum_steps)
        losses.append(loss)

    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    seconds = []
    for _ in range(windows):
        tic = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - tic)
    rates = [batch * iters / s for s in seconds]
    rate = batch * iters * windows / sum(seconds)
    print(f"train step: {rate:.1f} samples/s over {windows * iters} steps "
          f"({1e3 * sum(seconds) / (windows * iters):.3f} ms/step, windows "
          f"{[round(r, 1) for r in rates]}), batch {batch}, {ntoks}-token texts, "
          f"arch {arch} {model_kwargs or ''}, accum_steps {accum_steps}, moments "
          f"{moments_dtype or 'float32'}",
          flush=True)
    return {"samples_per_s": rate, "window_rates": rates,
            "losses": [float(x) for x in losses], "setup": built}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="train samples/s of the flagship")
    parser.add_argument("batch", nargs="?", type=int, default=128)
    parser.add_argument("ntoks", nargs="?", type=int, default=16)
    parser.add_argument("arch", nargs="?", default="PretrainedCLIP_finaltf")
    parser.add_argument("frames", nargs="?", type=int, default=0)
    parser.add_argument("iters", nargs="?", type=int, default=8)
    parser.add_argument("--accum_steps", type=int, default=1)
    parser.add_argument("--moments_dtype", default=None, choices=("bfloat16", "float32"))
    a = parser.parse_args()
    main(a.batch, a.ntoks, a.arch, a.frames, a.iters, accum_steps=a.accum_steps,
         moments_dtype=a.moments_dtype)
