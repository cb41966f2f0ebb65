"""Retrieval server of the port: checkpoint + embedding gallery -> HTTP, the
twin of ``scripts/serve.py``:

    python -m vtc_tpu_torch.scripts.serve -c configs/pretrained_clip.jsonc \\
        -r saved/models/run/model_best.pth --index clip_vit_embeddings.npz --port 8000

``--index`` takes the ``.npz`` the embedding script writes
(``vtc_tpu_torch.scripts.get_clip_vit_embeddings``: ``reddit_ids`` +
``embeddings``) or a ``RetrievalIndex.save`` file; ``-r`` a ``.pth``
checkpoint. The model and the gallery live on the card unless ``--device
cpu``. Endpoints: ``serving/server.py``.

``--n_devices N --n_model M`` is ``vtc_tpu``'s serving mesh
(``scripts/serve.py:54-60``), one process over its cards: it needs N·M
cards and raises by count otherwise. The gallery's rows shard over the N
data places (card ``d·M`` holds shard ``d``; ``RetrievalIndex(devices=...)``)
and are replicated over the model axis; the query towers run whole on the
first card (a single process places no tower weights over the model axis).
With ``--device cpu`` the N shards lie on the CPU, as ``vtc_tpu``'s CPU test
mesh holds them.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..data.tokenizer import tokenize
from ..device import resolve_device
from ..models import create_model
from ..serving import ClipRetrievalService, RetrievalHTTPServer, RetrievalIndex
from ..training.checkpoints import graft_into, load_checkpoint
from ..utils import read_json


def build_server(config, checkpoint, index_path, *, n_devices=1, n_model=1,
                 host="127.0.0.1", port=8000, device=None) -> RetrievalHTTPServer:
    """Assemble the ``RetrievalHTTPServer`` from a config's ``arch``, an
    optional ``.pth`` checkpoint (grafted as a warm start: the keys it lacks
    or adds are reported) and a gallery file, on ``device`` (default: the
    card), the gallery sharded over ``n_devices`` data places of an
    ``n_devices × n_model`` mesh."""
    device = resolve_device(device)
    n_devices, n_model = int(n_devices or 1), int(n_model or 1)
    devices = None
    if n_devices * n_model > 1:
        if device.type == "cuda":
            have = torch.cuda.device_count()
            if have < n_devices * n_model:
                raise RuntimeError(f"a {n_devices}x{n_model} mesh needs "
                                   f"{n_devices * n_model} cards; this machine has {have}")
            devices = [torch.device("cuda", d * n_model) for d in range(n_devices)]
        else:
            devices = [device] * n_devices
    arch = config["arch"]
    model = create_model(arch["type"], seed=0, device=device, **dict(arch["args"]))
    if checkpoint is not None:
        missing, unexpected = graft_into(model, load_checkpoint(checkpoint)["state_dict"])
        if missing or unexpected:
            print(f"warm-start: {len(missing)} missing / {len(unexpected)} unexpected keys",
                  file=sys.stderr)
    index = RetrievalIndex.load(index_path, device=device, devices=devices)
    service = ClipRetrievalService(model, index, device=device)
    return RetrievalHTTPServer(service, tokenizer=tokenize, host=host, port=port)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="vtc_tpu_torch retrieval server")
    ap.add_argument("-c", "--config", required=True,
                    help="training config (arch section is used)")
    ap.add_argument("-r", "--resume", default=None, help="checkpoint (.pth)")
    ap.add_argument("--index", required=True, help="gallery npz (reddit_ids + embeddings)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--n_devices", type=int, default=1)
    ap.add_argument("--n_model", type=int, default=1)
    ap.add_argument("--device", default=None, help="cpu, or a card (default: the card)")
    ap.add_argument("--no_warmup", action="store_true")
    args = ap.parse_args(argv)

    server = build_server(read_json(args.config), args.resume, args.index,
                          n_devices=args.n_devices, n_model=args.n_model, host=args.host,
                          port=args.port, device=args.device)
    if not args.no_warmup:
        print("warming up query buckets ...", file=sys.stderr)
        server.warmup()
    print(f"serving on {args.host}:{server.port}", file=sys.stderr)
    server.serve()


if __name__ == "__main__":
    main()
