"""The video input pipeline against the video train step on the card; the
twin of ``scripts/bench_video_pipeline.py``.

    python -m vtc_tpu_torch.scripts.bench_video_pipeline [--videos 48] [--workers 8]
        [--batch 8] [--epochs 2] [--device-step] [--csv_file CSV --root DIR]

The pipeline is ``VideoDatasetSegments`` in training (OpenCV decode of a
random 8-frame segment, the augmentations, ``clip_preprocess_batch``, the
BPE) through the threaded ``DataLoader``, then ``prefetch_to_device``, then,
with ``--device-step``, ``training.train_step`` of the video model from the
``arch``, optimizer and schedule of
``configs/pretrained_clip_timesformer_comments_attention.jsonc``
(``PretrainedCLIP_TimeSformer_finaltf``, ViT-B/32, 8 frames, fp32 as the
``train.py`` twin trains it, seed 0). It reports videos/s:

* **host**: the loader alone over ``epochs`` epochs, every batch collated;
* **device step**: ``STEPS`` train steps on one batch already on the card,
  between two synchronizations, after ``WARMUP`` steps: the rate the step
  demands of the loader;
* **overlapped**: the loader, the copy and the step together, one epoch,
  the step's demand met where it is at least the device step's rate.

Without ``--csv_file`` it writes the JAX script's corpus (``make_corpus``:
``videos`` videos of 240 frames at 480 x 360, 30 fps, mp4v) in a temporary
directory. ``main`` returns the rates; ``--device-step`` needs a card.
"""

from __future__ import annotations

import argparse
import csv
import os
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

BASE36 = "0123456789abcdefghijklmnopqrstuvwxyz"
VIDEO_CONFIG = Path(__file__).resolve().parents[2] / "configs" / (
    "pretrained_clip_timesformer_comments_attention.jsonc")
WARMUP, STEPS = 2, 5


def make_corpus(root, n_videos: int = 48, frames: int = 240, w: int = 480, h: int = 360,
                fps: int = 30):
    """``n_videos`` videos of a seeded noise image scrolled 3 pixels a frame
    (mp4v), ids ``vd`` + two base-36 digits of their number, and their
    CSV: ``(csv path, media root)``."""
    import cv2

    vids = os.path.join(root, "media", "vids")
    os.makedirs(vids, exist_ok=True)
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n_videos):
        rid_str = "vd" + BASE36[(i // 36) % 36] + BASE36[i % 36]
        writer = cv2.VideoWriter(os.path.join(vids, f"{rid_str}.mp4"),
                                 cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        base = rng.integers(0, 255, (h, w, 3), np.uint8)
        for f in range(frames):
            writer.write(np.roll(base, f * 3, axis=1))
        writer.release()
        rows.append([int(rid_str, 36), f"results/vids/{rid_str}.mp4", f"synthetic video {i}",
                     frames / fps, str([f"comment {i} alpha", f"comment {i} beta"])])
    path = os.path.join(root, "posts.csv")
    with open(path, "w", newline="") as f:
        out = csv.writer(f)
        out.writerow(["reddit_id", "video_path", "title", "video_length", "comments"])
        out.writerows(rows)
    return path, os.path.join(root, "media")


def _step_parts(device, steps_per_epoch: int):
    """The video model, optimizer and schedule of the config, on ``device``."""
    from ..models import create_model
    from ..training import build_optimizer
    from ..utils import jsonc

    cfg = jsonc.read_json(VIDEO_CONFIG)
    arch = cfg["arch"]
    model = create_model(arch["type"], seed=0, device=device, **dict(arch["args"]))
    optimizer, scheduler = build_optimizer(
        model, cfg["optimizer"], cfg.get("lr_scheduler"), steps_per_epoch=steps_per_epoch,
        fc_lr=cfg.get("fc_lr"), time_lr=cfg.get("time_lr"), adapter_lr=cfg.get("adapter_lr"))
    return model, optimizer, scheduler


def main(videos: int = 48, workers: int = 8, batch: int = 8, epochs: int = 2,
         device_step: bool = False, csv_file: Optional[str] = None,
         root: Optional[str] = None, log=print) -> dict:
    """Runs the benchmark; returns ``{"host_videos_per_s", "device_videos_per_s",
    "overlapped_videos_per_s", "meets_demand", "peak_gib"}`` (the device
    numbers None without ``device_step``)."""
    from ..data import DataLoader, VideoDatasetSegments, prefetch_to_device
    from ..device import resolve_device
    from ..ops.losses import clip_loss
    from ..training import train_step

    if csv_file is None:
        tmp = tempfile.mkdtemp(prefix="vtc_video_bench_")
        log(f"corpus: {videos} videos (240 frames, 480x360) in {tmp}")
        csv_file, root = make_corpus(tmp, videos)
    ds = VideoDatasetSegments(csv_file, root, train=True, add_comments="always", num_comms=5,
                              comment_sampling="random")
    loader = DataLoader(ds, batch_size=batch, shuffle=True, drop_last=True,
                        num_workers=workers)
    cores = len(os.sched_getaffinity(0))
    result = {"host_videos_per_s": None, "device_videos_per_s": None,
              "overlapped_videos_per_s": None, "meets_demand": None, "peak_gib": None}

    n, tic = 0, time.perf_counter()
    for _ in range(epochs):
        for b in loader:
            n += b[0].shape[0]
    host_s = time.perf_counter() - tic
    result["host_videos_per_s"] = n / host_s
    log(f"host pipeline: {n / host_s:.2f} videos/s ({n} clips of {len(ds)} in {host_s:.2f} s, "
        f"{workers} workers, {cores} cores; {host_s * cores / max(n, 1):.3f} core-seconds "
        "per clip)")
    if not device_step:
        return result

    device = resolve_device()
    model, optimizer, scheduler = _step_parts(device, len(loader))
    generator = torch.Generator(device=device).manual_seed(0)
    *first, _ = next(iter(loader))
    data = [torch.from_numpy(a).to(device) for a in first]
    torch.cuda.reset_peak_memory_stats(device)
    for _ in range(WARMUP):
        train_step(model, clip_loss, optimizer, scheduler, data, {}, generator)
    torch.cuda.synchronize(device)
    tic = time.perf_counter()
    for _ in range(STEPS):
        loss, _ = train_step(model, clip_loss, optimizer, scheduler, data, {}, generator)
    torch.cuda.synchronize(device)
    step_s = (time.perf_counter() - tic) / STEPS
    result["device_videos_per_s"] = batch / step_s
    result["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    log(f"device step alone: {batch / step_s:.2f} videos/s ({step_s * 1e3:.1f} ms per step "
        f"of {batch}, loss {float(loss):.4f}, peak {result['peak_gib']:.3f} GiB)")

    def batches():
        for *d, _ in loader:
            yield tuple(d)

    n, tic = 0, time.perf_counter()
    for d in prefetch_to_device(batches(), device, size=2):
        loss, _ = train_step(model, clip_loss, optimizer, scheduler, list(d), {}, generator)
        n += d[0].shape[0]
    torch.cuda.synchronize(device)
    e2e_s = time.perf_counter() - tic
    result["overlapped_videos_per_s"] = n / e2e_s
    result["meets_demand"] = bool(result["host_videos_per_s"] >= result["device_videos_per_s"])
    log(f"overlapped: {n / e2e_s:.2f} videos/s ({n} clips in {e2e_s:.2f} s, loss "
        f"{float(loss):.4f}); the loader {'meets' if result['meets_demand'] else 'falls below'}"
        f" the step's demand ({result['host_videos_per_s']:.2f} against "
        f"{result['device_videos_per_s']:.2f} videos/s)")
    return result


def cli(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--videos", type=int, default=48)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--device-step", action="store_true",
                    help="also run the video train step (needs a card)")
    ap.add_argument("--csv_file", default=None, help="a corpus's CSV (default: written)")
    ap.add_argument("--root", default=None, help="the corpus's media root")
    args = ap.parse_args(argv)
    return main(args.videos, args.workers, args.batch, args.epochs, args.device_step,
                args.csv_file, args.root)


if __name__ == "__main__":
    cli()
