"""The optimizer update alone on the card, per leaf against one merged
buffer: the twin of ``scripts/bench_optim_update.py``.

    python -m vtc_tpu_torch.scripts.bench_optim_update [iters]

The flagship (``PretrainedCLIP_finaltf``, ViT-B/32, fp32 weights as the
train step keeps them) with every gradient set to 1e-4, and the update that
``training.build_optimizer`` builds for ``bench_train_step``'s
configuration (4 groups × decay, Adam with amsgrad, lr 1e-5, adapter lr
1e-4, StepLR(10, 0.1)):

* ``optimizer.step()`` of ``torch.optim.Adam`` (its multi-tensor path, one
  launch per group of leaves and operation);
* the same with ``moments_dtype="bfloat16"``: ``Bf16MomentAdam``;
* the same math (plain amsgrad, one lr) on ONE flat fp32 buffer of all the
  parameters: a handful of elementwise launches over N elements.

Each is timed by CUDA events, the median of 3 windows of ``iters`` steps
after 3, beside the bytes bound of the merged update (5 reads and 4 writes
of N fp32 over 3.35 TB/s). If the merged update reaches the bound while the
per-leaf one does not, the per-leaf update is bound by its launch count and
a flat-buffer layout would pay; if not, it is not. ``main`` returns the
times; ``device="cpu"`` (the tests) times on the host clock.
"""

from __future__ import annotations

import argparse
import statistics

import torch

from ..device import HBM_BYTES_PER_S, resolve_device
from ..models import create_model
from ..training import build_optimizer
from ..utils.timing import windows_ms
from .bench_train_step import OPTIMIZER, SCHEDULER, STEPS_PER_EPOCH

B1, B2, EPS, LR = 0.9, 0.999, 1e-8, 1e-5


def merged_adam_step(state: dict, g: torch.Tensor) -> None:
    """One amsgrad step on flat buffers, in place: ``bench_optim_update.py``'s
    ``merged``."""
    state["t"] += 1
    t = state["t"]
    p, mu, nu, numax = state["p"], state["mu"], state["nu"], state["numax"]
    mu.mul_(B1).add_(g, alpha=1 - B1)
    nu.mul_(B2).addcmul_(g, g, value=1 - B2)
    torch.maximum(numax, nu, out=numax)
    denom = (numax / (1 - B2**t)).sqrt_().add_(EPS)
    p.addcdiv_(mu, denom, value=-LR / (1 - B1**t))


def main(iters: int = 64, model_type: str = "ViT-B/32", device=None, log=print) -> dict:
    """-> ``{"leaves", "params", "adam_ms", "bf16_moments_ms", "merged_ms",
    "bound_ms"}``."""
    device = resolve_device(device)
    out = {}
    for moments in (None, "bfloat16"):
        model = create_model("PretrainedCLIP_finaltf", model_type=model_type, seed=0,
                             dtype="bf16", device=device)
        params = [p for p in model.parameters() if p.requires_grad]
        optimizer, _ = build_optimizer(
            model, dict(OPTIMIZER, args=dict(OPTIMIZER["args"], moments_dtype=moments)),
            SCHEDULER, steps_per_epoch=STEPS_PER_EPOCH, adapter_lr=1e-4, time_lr=1e-5)
        for p in params:
            p.grad = torch.full_like(p, 1e-4)
        key = "adam_ms" if moments is None else "bf16_moments_ms"
        out[key] = statistics.median(windows_ms(optimizer.step, device, iters))
        out["leaves"], out["params"] = len(params), sum(p.numel() for p in params)
        del model, optimizer, params
    n = out["params"]
    state = {"p": torch.full((n,), 0.01, device=device), "t": 0,
             **{k: torch.zeros(n, device=device) for k in ("mu", "nu", "numax")}}
    g = torch.full((n,), 1e-4, device=device)
    out["merged_ms"] = statistics.median(
        windows_ms(lambda: merged_adam_step(state, g), device, iters))
    out["bound_ms"] = 9 * n * 4 / HBM_BYTES_PER_S * 1e3
    log(f"{out['leaves']} leaves, {n / 1e6:.1f}M params on {device}")
    log(f"per-leaf Adam (amsgrad, 4 groups x decay): {out['adam_ms']:.3f} ms/step")
    log(f"per-leaf Bf16MomentAdam: {out['bf16_moments_ms']:.3f} ms/step")
    log(f"single merged {n / 1e6:.1f}M-buffer update: {out['merged_ms']:.3f} ms/step "
        f"(bytes bound {out['bound_ms']:.3f} ms at {HBM_BYTES_PER_S / 1e12:g} TB/s)")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("iters", nargs="?", type=int, default=64)
    main(ap.parse_args().iters)
