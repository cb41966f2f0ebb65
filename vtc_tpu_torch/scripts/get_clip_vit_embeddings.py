"""CLIP image embeddings of every thumbnail of a CSV, the twin of
``scripts/get_clip_vit_embeddings.py``:

    python -m vtc_tpu_torch.scripts.get_clip_vit_embeddings --csv posts.csv \\
        --root thumbnails/ --out clip_vit_embeddings.npz [--fp32] [--device cpu]

CSV (``data.table.read_csv``) -> each row's ``<video_path without
results/ and .mp4>.jpg`` under ``--root``, decoded by ``read_rgb`` (on the
card's route: nvJPEG and the ``ycc_to_rgb`` kernel for a JPEG, the host
decoders for a PNG, GIF, BMP or WebP) and CLIP-preprocessed on the
host, through the ``DataLoader`` -> batched ``encode_image`` of
``PretrainedCLIP`` on the card (bf16 activations unless ``--fp32``) ->
``{"reddit_ids", "embeddings"}`` in ``--out`` (``np.savez``; a ``.pth``
name also gets ``torch.save``). ``--clip_weights`` names CLIP weights
(``models/clip_import.py``).

``--n_devices N`` encodes on N processes, one per card, under ``torchrun
--nproc_per_node N``: each encodes the strided share ``rank::N`` of the
rows, the shares merge with ``allgather_varlen`` and go back to the CSV's
order, and rank 0 writes the file, whose rows are those of one process.
Without a process group it raises with the ``torchrun`` line on a machine
with N cards, and warns and encodes on one device on one with fewer, as the
JAX script does.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from ..data.image_io import read_rgb
from ..data.loader import DataLoader
from ..data.preprocess import clip_preprocess
from ..data.table import read_csv
from ..device import resolve_device
from ..models import create_model
from ..parallel.mesh import check_data_devices, data_group, process_share
from ..utils.util import allgather_varlen, init_distributed, is_main, launched


class Thumbnails:
    """The CLIP-preprocessed thumbnail of each file, decoded on ``device``."""

    def __init__(self, filenames, image_size: int, device):
        self.filenames = filenames
        self.image_size = image_size
        self.device = device

    def __len__(self):
        return len(self.filenames)

    def __getitem__(self, i):
        return clip_preprocess(read_rgb(self.filenames[i], self.device), self.image_size)


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csv", required=True)
    ap.add_argument("--root", default="")
    ap.add_argument("--out", default="clip_vit_embeddings.npz")
    ap.add_argument("--batch_size", type=int, default=96)
    ap.add_argument("--num_workers", type=int, default=13)
    ap.add_argument("--model_type", default="ViT-B/32")
    ap.add_argument("--image_size", type=int, default=224)
    ap.add_argument("--clip_weights", default=None)
    ap.add_argument("--fp32", action="store_true", help="encode in float32 (default: bfloat16)")
    ap.add_argument("--n_devices", type=int, default=1)
    ap.add_argument("--device", default=None, help="cpu, or a card (default: the card)")
    args = ap.parse_args(argv)
    if launched():
        init_distributed()
    device = resolve_device(args.device)
    check_data_devices(args.n_devices, device, logging.getLogger(__name__), "encoding",
                       "vtc_tpu_torch.scripts.get_clip_vit_embeddings")
    pidx, pcount = process_share()

    table = read_csv(args.csv)
    files = [x[len("results/"):-4] + ".jpg" for x in table.video_path]
    rows = np.arange(len(files))[pidx::pcount]  # this process's share
    filenames = [os.path.join(args.root, files[i]) for i in rows]

    model = create_model("PretrainedCLIP", model_type=args.model_type,
                         clip_weights=args.clip_weights,
                         dtype=torch.float32 if args.fp32 else torch.bfloat16, device=device)
    loader = DataLoader(Thumbnails(filenames, args.image_size, device),
                        batch_size=args.batch_size, num_workers=args.num_workers)

    out = []
    tic = time.time()
    with torch.inference_mode():
        for bi, imgs in enumerate(loader):
            y = model.encode_image(torch.as_tensor(imgs, device=device)).float().cpu().numpy()
            out.append(y)
            toc = time.time() - tic
            tic = time.time()
            print(bi, "/", len(loader), "%.1fHz" % (args.batch_size / toc), y.shape)

    dim = model.feature_dim
    stacked = np.vstack(out) if out else np.zeros((0, dim), np.float32)
    if pcount > 1:  # the shares, back in the CSV's order
        merged = allgather_varlen(stacked, data_group())
        order = allgather_varlen(rows, data_group())
        stacked = np.empty_like(merged)
        stacked[order] = merged
    reddit_ids = np.asarray(table.reddit_id).astype(np.int64)
    if is_main():
        np.savez(args.out, reddit_ids=reddit_ids, embeddings=stacked)
        if args.out.endswith(".pth"):
            torch.save({"reddit_ids": torch.tensor(reddit_ids),
                        "embeddings": torch.tensor(stacked)}, args.out)
        print("saved", args.out, stacked.shape)
    return stacked


if __name__ == "__main__":
    main()
