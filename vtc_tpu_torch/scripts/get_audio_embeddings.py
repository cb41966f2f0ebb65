"""GDT audio embeddings of every video of a CSV, the twin of
``scripts/get_audio_embeddings.py``:

    python -m vtc_tpu_torch.scripts.get_audio_embeddings --csv posts.csv \\
        --root videos/ --out audio_embeddings.npz [--gdt_weights gdt_IG65M.pth]

CSV (``data.table.read_csv``) -> each row's ``<video_path without
results/>`` under ``--root`` -> 5 two-second log spectrograms at the
relative points (0.15, 0.3, 0.45, 0.6, 0.85) on the host
(``audio.video_audio_clips``: PyAV where ``av`` imports, else the all-ones
fallback, counted and printed), through the ``DataLoader`` -> the ResNet-9
audio tower in fp32 on the card (``--device cpu`` for the CPU) ->
``{"reddit_ids", "embeddings" [N, 5, 512]}`` in ``--out``, the file that
``ImTextDataset(cached_audio_features=...)`` reads. Without
``--gdt_weights`` the tower is a seeded random init (a warning says so).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..audio import AudioResNet9, is_fallback, load_gdt_state_dict, video_audio_clips
from ..audio.spectrogram import N_FRAMES, N_FREQ, av_available
from ..data.loader import DataLoader
from ..data.table import read_csv
from ..device import resolve_device
from ..models.factory import init_plain

NUM_CLIPS = 5


class AudioClips:
    """The ``[5, 257, 199]`` spectrogram clips of each file."""

    def __init__(self, filenames):
        self.filenames = filenames

    def __len__(self):
        return len(self.filenames)

    def __getitem__(self, i):
        return video_audio_clips(self.filenames[i], NUM_CLIPS)


def build_tower(gdt_weights=None, device=None, seed: int = 0) -> AudioResNet9:
    """The audio tower in eval mode on ``device``: GDT's weights where given,
    else a seeded init."""
    model = AudioResNet9()
    if gdt_weights:
        ckpt = torch.load(gdt_weights, map_location="cpu", weights_only=False)
        load_gdt_state_dict(model, ckpt.get("model", ckpt))
    else:
        init_plain(model, torch.Generator().manual_seed(seed))
        print("warning: random audio-tower init (no --gdt_weights given)")
    return model.to(resolve_device(device)).eval()


def encode(model: AudioResNet9, clips: torch.Tensor) -> torch.Tensor:
    """``[b, nclips, 257, 199]`` -> ``[b, nclips, 512]``."""
    b, c = clips.shape[:2]
    return model(clips.reshape(b * c, 1, N_FREQ, N_FRAMES)).reshape(b, c, -1)


def main(argv=None) -> tuple:
    """-> ``(embeddings [N, 5, 512], the number of fallback clips)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--csv", required=True)
    ap.add_argument("--root", default="")
    ap.add_argument("--out", default="audio_embeddings_no_aug_5clip_5embeds_2sec.npz")
    ap.add_argument("--batch_size", type=int, default=96)
    ap.add_argument("--num_workers", type=int, default=13)
    ap.add_argument("--gdt_weights", default=None,
                    help="gdt_IG65M.pth to initialize the audio tower")
    ap.add_argument("--device", default=None, help="cpu, or a card (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    table = read_csv(args.csv)
    filenames = [os.path.join(args.root, x[len("results/"):-4] + ".mp4")
                 for x in table.video_path]
    model = build_tower(args.gdt_weights, device)
    loader = DataLoader(AudioClips(filenames), batch_size=args.batch_size,
                        num_workers=args.num_workers)
    out, fallbacks = [], 0
    tic = time.time()
    with torch.inference_mode():
        for bi, batch in enumerate(loader):
            fallbacks += int(is_fallback(batch).sum())
            y = encode(model, torch.as_tensor(batch, device=device)).float().cpu().numpy()
            out.append(y)
            toc = time.time() - tic
            tic = time.time()
            print(bi, "/", len(loader), "%.1fHz" % (len(y) / toc), y.shape)
    print(f"audio fallbacks: {fallbacks} of {len(filenames) * NUM_CLIPS} "
          f"clips (PyAV {'imports' if av_available() else 'does not import'})")
    stacked = np.vstack(out)
    np.savez(args.out, reddit_ids=np.asarray(table.reddit_id).astype(np.int64),
             embeddings=stacked)
    print("saved", args.out, stacked.shape)
    return stacked, fallbacks


if __name__ == "__main__":
    main()
