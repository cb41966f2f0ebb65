"""Throughput of the flagship's full train step on the card.

    python -m vtc_tpu_torch.scripts.bench_train_step [batch] [ntoks] [arch] [frames] [iters]

The port's twin of ``scripts/bench_train_step.py`` (``:22-80``) with its
uint8 patch input (``VTC_BENCH_PATCHES=1``): ``PretrainedCLIP_finaltf`` at
ViT-B/32, batch 128, a 16-token title and 5 comments (``synthetic_tokens``,
14 real tokens), bf16 activations over fp32 weights, Adam with amsgrad at lr
1e-5 (``adapter_lr`` 1e-4, ``time_lr`` 1e-5), StepLR(10, 0.1) at 100 steps
per epoch. Each step is ``training.train_step``: forward, ``clip_loss``,
backward, optimizer, scheduler. The CAM's random adapter skip draws from one
seeded generator, fresh masks every step, as in training.

After ``warmup`` steps it times ``windows`` windows of ``iters`` steps, with
``torch.cuda.synchronize()`` around each, and prints samples/s over all of
them with each window's rate. It needs a card and raises without one.
"""

from __future__ import annotations

import sys
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
          frames: int = 0):
    """``(model, optimizer, scheduler, data)`` on the card, the JAX script's
    configuration; ``data`` is (uint8 patches, title, comments)."""
    device = resolve_device()
    kwargs = {"nframes": frames} if frames else {}
    model = create_model(arch, model_type="ViT-B/32", seed=SEED, dtype="bf16",
                         device=device, **kwargs)
    optimizer, scheduler = build_optimizer(
        model, OPTIMIZER, SCHEDULER, steps_per_epoch=STEPS_PER_EPOCH,
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
         frames: int = 0, iters: int = 8, warmup: int = 3, windows: int = 3) -> dict:
    """Runs the benchmark; returns ``{"samples_per_s", "window_rates",
    "losses", "setup"}``: ``losses`` has every step's loss, warm-up
    included, and ``setup`` is what ``setup`` built, for a caller that
    goes on stepping (the profiler windows of ``chip_smoke.py``)."""
    model, optimizer, scheduler, data = built = setup(batch, ntoks, arch, frames)
    generator = torch.Generator(device=data[0].device).manual_seed(SEED)
    losses = []

    def step():
        loss, _ = train_step(model, clip_loss, optimizer, scheduler, data, {}, generator)
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
          f"arch {arch}", flush=True)
    return {"samples_per_s": rate, "window_rates": rates,
            "losses": [float(x) for x in losses], "setup": built}


if __name__ == "__main__":
    args = sys.argv[1:]
    main(int(args[0]) if len(args) > 0 else 128,
         int(args[1]) if len(args) > 1 else 16,
         args[2] if len(args) > 2 else "PretrainedCLIP_finaltf",
         int(args[3]) if len(args) > 3 else 0,
         int(args[4]) if len(args) > 4 else 8)
