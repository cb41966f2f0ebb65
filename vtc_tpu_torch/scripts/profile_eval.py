"""Per-tower times of the flagship's eval forward on the card: the twin of
``scripts/profile_eval.py``.

    python -m vtc_tpu_torch.scripts.profile_eval [batch] [ntoks]

``PretrainedCLIP_finaltf`` at ViT-B/32, bf16 (``convert_weights``), seed 0,
the JAX script's inputs (CLIP-normalized NCHW images, a title and 5
comments of ``ntoks`` tokens from ``synthetic_tokens``), timed by CUDA events
as the median of 3 windows of ``iters`` calls after 3 warm-up calls:

* the full forward (image, title + 5 comments, CAM, similarities);
* the image tower alone;
* the text tower alone on the 6 texts of each pair, and on the title alone;
* the CAM and the similarities alone, on precomputed embeddings.

Then the FLOPs of a pair (``bench.forward_flops``) over the full forward's
time, against the card's dense bf16 peak. ``main`` returns the times;
``device="cpu"`` (the tests) times on the host clock.
"""

from __future__ import annotations

import argparse
import statistics

import numpy as np
import torch

from ..bench import forward_flops, peak_bf16
from ..data import synthetic_tokens
from ..device import resolve_device
from ..models import convert_weights, create_model
from ..utils.timing import windows_ms


def main(batch: int = 128, ntoks: int = 16, iters: int = 16, model_type: str = "ViT-B/32",
         device=None, log=print) -> dict:
    """-> ``{"full", "image", "text_x6", "title", "cam"}`` in ms per call."""
    device = resolve_device(device)
    model = create_model("PretrainedCLIP_finaltf", model_type=model_type, seed=0,
                         dtype="bf16", device=device).eval()
    convert_weights(model)
    v = model.variant
    rng = np.random.default_rng(0)
    res = v.input_resolution
    vis = torch.from_numpy(rng.normal(size=(batch, 3, res, res)).astype(np.float32))
    title = synthetic_tokens((batch,), ntoks, 14, rng)
    comments = synthetic_tokens((batch, 5), ntoks, 14, rng)
    vis, title, comments = (torch.as_tensor(a).to(device) for a in (vis, title, comments))
    texts = torch.cat([title[:, None], comments], 1).reshape(-1, ntoks)
    with torch.inference_mode():
        fv = model.encode_image(vis)
        ft, fc = model._encode_title_and_comments(title, comments)
        calls = {
            "full": lambda: model(vis, title, comments),
            "image": lambda: model.model.encode_image(vis),
            "text_x6": lambda: model.model.encode_text(texts),
            "title": lambda: model.model.encode_text(title),
            "cam": lambda: model._sim(*model._encode_with_comments(fv, ft, fc)),
        }
        ms = {name: statistics.median(windows_ms(fn, device, iters))
              for name, fn in calls.items()}
    names = {"full": "full forward", "image": "image tower", "text_x6": "text tower x6",
             "title": "text tower x1 (title)", "cam": "CAM + sim"}
    for name, t in ms.items():
        log(f"{names[name]:<28} {t:8.3f} ms/iter  {batch / t * 1e3:10.0f} items/s")
    log(f"{'(img + 6x text) sum':<28} {ms['image'] + ms['text_x6']:8.3f} ms")
    log(f"{'full - img - 6x text':<28} {ms['full'] - ms['image'] - ms['text_x6']:8.3f} ms")
    flops = forward_flops(v, batch, ntoks)
    peak = peak_bf16(device)
    rate = flops / (ms["full"] * 1e-3)
    share = "no card" if peak is None else f"{rate / peak:.4f} of the dense bf16 peak"
    log(f"pair = {flops / batch / 1e9:.2f} GFLOP (from the shapes) -> "
        f"{rate / 1e12:.1f} TFLOP/s on {device}, {share}")
    return ms


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=128)
    ap.add_argument("ntoks", nargs="?", type=int, default=16)
    a = ap.parse_args()
    main(a.batch, a.ntoks)
