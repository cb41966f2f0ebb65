"""Throughput of the video eval forward on the card: the twin of
``scripts/bench_video_eval.py``.

    python -m vtc_tpu_torch.scripts.bench_video_eval [batch] [frames] [ntoks]

``PretrainedCLIP_TimeSformer_finaltf`` (the TimeSformer over ``frames``
frames + the CAM) at ViT-B/32, bf16 (``convert_weights``), seed 0, on uint8
patch frames (``extract_patches`` of seeded 224² frames), a title and 5
comments of ``ntoks`` tokens. Videos/s: the median of three windows of
``iters`` forwards after ``warmup``, each window its work over its time
(CUDA events). ``main`` returns the rate and the windows';
``device="cpu"`` (the tests) runs on the host. With ``VTC_TRACE=1`` (the
JAX script's switch) one window of ``iters`` forwards after the warm-up
runs under ``torch.profiler`` instead (``profile_trace.profile_calls``):
it prints the top kernels, the device time per kernel family and the idle
share (``profile_trace.report``) and returns that profile in place of the
rates.
"""

from __future__ import annotations

import argparse
import os
import statistics

import numpy as np
import torch

from ..data import extract_patches, synthetic_tokens
from ..device import resolve_device
from ..models import convert_weights, create_model
from ..utils.timing import windows_ms


def main(batch: int = 32, frames: int = 8, ntoks: int = 16, iters: int = 32,
         warmup: int = 2, windows: int = 3, model_type: str = "ViT-B/32", device=None,
         log=print) -> dict:
    """-> ``{"videos_per_s", "window_rates"}`` (under ``VTC_TRACE=1``
    ``{"profile"}``)."""
    device = resolve_device(device)
    model = create_model("PretrainedCLIP_TimeSformer_finaltf", model_type=model_type,
                         nframes=frames, seed=0, dtype="bf16", device=device).eval()
    convert_weights(model)
    v = model.variant
    rng = np.random.default_rng(0)
    res = v.input_resolution
    u8 = rng.integers(0, 256, (batch, frames, res, res, 3), dtype=np.uint8)
    vis = extract_patches(u8, v.patch_size)
    title = synthetic_tokens((batch,), ntoks, 14, rng)
    comments = synthetic_tokens((batch, 5), ntoks, 14, rng)
    inputs = [torch.from_numpy(a).to(device) for a in (vis, title, comments)]

    with torch.inference_mode():
        if os.environ.get("VTC_TRACE") == "1":  # one window under the profiler
            from .profile_trace import profile_calls, report

            for _ in range(warmup):
                model(*inputs)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            prof = profile_calls(lambda: model(*inputs), iters, device)
            report(prof, f"video eval batch {batch}, {frames} frames", iters, log)
            return {"profile": prof}
        rates = [batch * 1e3 / ms
                 for ms in windows_ms(lambda: model(*inputs), device, iters, warmup, windows)]
    rate = statistics.median(rates)
    log(f"video eval: {rate:.1f} videos/s median (windows "
        f"{[round(r, 1) for r in rates]}, batch {batch}, {frames} frames, "
        f"{ntoks}-token texts, uint8 patches, {model_type} on {device})")
    return {"videos_per_s": rate, "window_rates": rates}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=32)
    ap.add_argument("frames", nargs="?", type=int, default=8)
    ap.add_argument("ntoks", nargs="?", type=int, default=16)
    a = ap.parse_args()
    main(a.batch, a.frames, a.ntoks)
