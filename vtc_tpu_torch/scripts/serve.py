"""Retrieval server of the port: checkpoint + embedding gallery -> HTTP, the
twin of ``scripts/serve.py``:

    python -m vtc_tpu_torch.scripts.serve -c configs/pretrained_clip.jsonc \\
        -r saved/models/run/model_best.pth --index clip_vit_embeddings.npz --port 8000

``--index`` takes the ``.npz`` the embedding script writes
(``vtc_tpu_torch.scripts.get_clip_vit_embeddings``: ``reddit_ids`` +
``embeddings``) or a ``RetrievalIndex.save`` file; ``-r`` a ``.pth``
checkpoint. The model and the gallery live on the card unless ``--device
cpu``. A mesh-sharded gallery (``--n_devices``/``--n_model`` above 1) is
not ported (ROADMAP: Queue 1 item 9) and raises. Endpoints: ``serving/server.py``.
"""

from __future__ import annotations

import argparse
import sys

from ..data.tokenizer import tokenize
from ..device import DISTRIBUTION, resolve_device
from ..models import create_model
from ..serving import ClipRetrievalService, RetrievalHTTPServer, RetrievalIndex
from ..training.checkpoints import graft_into, load_checkpoint
from ..utils import read_json


def build_server(config, checkpoint, index_path, *, n_devices=1, n_model=1,
                 host="127.0.0.1", port=8000, device=None) -> RetrievalHTTPServer:
    """Assemble the ``RetrievalHTTPServer`` from a config's ``arch``, an
    optional ``.pth`` checkpoint (grafted as a warm start: the keys it lacks
    or adds are reported) and a gallery file, on ``device`` (default: the
    card)."""
    if n_devices * n_model > 1:
        raise NotImplementedError(f"a {n_devices}x{n_model} mesh-sharded gallery is not "
                                  f"ported ({DISTRIBUTION})")
    device = resolve_device(device)
    arch = config["arch"]
    model = create_model(arch["type"], seed=0, device=device, **dict(arch["args"]))
    if checkpoint is not None:
        missing, unexpected = graft_into(model, load_checkpoint(checkpoint)["state_dict"])
        if missing or unexpected:
            print(f"warm-start: {len(missing)} missing / {len(unexpected)} unexpected keys",
                  file=sys.stderr)
    index = RetrievalIndex.load(index_path, device=device)
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
