"""Serving on the card: a query batch's encode and rank time, and the HTTP
latency of a request end to end; the twin of ``scripts/bench_serving.py``.

    python -m vtc_tpu_torch.scripts.bench_serving [batch] [gallery_size] [k] [iters]

Defaults as the JAX script's: batch 16, a gallery of 10,000 seeded rows,
k 10, 64 iterations. The model is ``PretrainedCLIP`` at ViT-B/32 with bf16
weights (``convert_weights``), seed 0; the queries are
``synthetic_tokens`` (77 tokens, 14 real), the service the port's
``ClipRetrievalService`` over a ``RetrievalIndex`` on the card.

* **encode + rank**: ``service.search_text`` on the token batch (the text
  tower at the bucketed batch, the gallery product, ``torch.topk``, the
  result's copy to the host), ``iters`` calls per window between two CUDA
  events, 3 windows after 3 warm-up calls; the median window's ms per
  batch and queries/s;
* **HTTP**: a ``RetrievalHTTPServer`` on a free local port, warmed up, then
  ``HTTP_REQUESTS`` (200) sequential requests each, timed on the host's
  clock from send to parsed reply: ``/search/text`` with 1 and with
  ``batch`` query strings, and ``/search/image`` with one base64 JPEG
  (``JPEG``, the committed ``tests/data/jpeg/rgb420_480x360.jpg``, decoded
  by nvJPEG and the ``ycc_to_rgb`` kernel, CLIP-preprocessed on the host);
  p50 and p99 in ms;
* the decode + preprocess time of that JPEG alone, ms per image.

Each number is printed beside the card's name and power limit (``nvidia-
smi``); ``main`` returns them. It needs a card and raises without one.
"""

from __future__ import annotations

import argparse
import base64
import json
import statistics
import subprocess
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

from ..data.image_io import decode_rgb
from ..data.preprocess import clip_preprocess
from ..data.tokenizer import synthetic_tokens, tokenize
from ..device import resolve_device
from ..models import convert_weights, create_model
from ..serving import ClipRetrievalService, RetrievalHTTPServer, RetrievalIndex

JPEG = Path(__file__).resolve().parents[2] / "tests/data/jpeg/rgb420_480x360.jpg"
WINDOWS, WARMUP = 3, 3
HTTP_REQUESTS = 200
QUERY_WORDS = ("a cat on a sofa", "the view from a mountain top at dawn",
               "people dancing at a street festival", "an old car in the rain")


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _post(port: int, path: str, payload: dict) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        if resp.status != 200:
            raise RuntimeError(f"{path}: HTTP {resp.status}")
        return json.loads(resp.read())


def http_latency(port: int, path: str, payload: dict, requests: int, warmup: int = 5) -> dict:
    """p50 and p99 ms of ``requests`` sequential requests, after
    ``warmup``."""
    for _ in range(warmup):
        _post(port, path, payload)
    ms = []
    for _ in range(requests):
        tic = time.perf_counter()
        _post(port, path, payload)
        ms.append((time.perf_counter() - tic) * 1e3)
    return {"p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99)),
            "mean_ms": statistics.fmean(ms), "requests": requests}


def encode_rank_ms(service, tokens: np.ndarray, k: int, iters: int) -> dict:
    """Median over ``WINDOWS`` windows of ``iters`` ``search_text`` calls,
    timed with CUDA events: ms per query batch."""
    for _ in range(WARMUP):
        service.search_text(tokens, k=k)
    torch.cuda.synchronize()
    windows = []
    for _ in range(WINDOWS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            service.search_text(tokens, k=k)
        end.record()
        end.synchronize()
        windows.append(start.elapsed_time(end) / iters)
    return {"ms_per_batch": statistics.median(windows), "windows_ms": windows}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", nargs="?", type=int, default=16)
    ap.add_argument("gallery", nargs="?", type=int, default=10_000)
    ap.add_argument("k", nargs="?", type=int, default=10)
    ap.add_argument("iters", nargs="?", type=int, default=64)
    args = ap.parse_args(argv)
    device = resolve_device(None)
    smi = card_name()

    model = convert_weights(create_model("PretrainedCLIP", model_type="ViT-B/32", seed=0,
                                         dtype=torch.bfloat16, device=device))
    rng = np.random.default_rng(0)
    gallery = rng.normal(size=(args.gallery, model.feature_dim)).astype(np.float32)
    index = RetrievalIndex(model.feature_dim, device=device)
    index.add(gallery, np.arange(args.gallery))
    service = ClipRetrievalService(model, index, device=device)
    tokens = synthetic_tokens((args.batch,), 77, 14, rng)

    out = {"batch": args.batch, "gallery": args.gallery, "k": args.k, "iters": args.iters,
           "card": smi}
    rank = encode_rank_ms(service, tokens, args.k, args.iters)
    out["encode_rank_ms_per_batch"] = rank["ms_per_batch"]
    out["encode_rank_windows_ms"] = rank["windows_ms"]
    out["queries_per_s"] = args.batch / rank["ms_per_batch"] * 1e3
    print(f"encode+rank: {rank['ms_per_batch']:.4f} ms per batch of {args.batch} "
          f"(windows {[round(w, 4) for w in rank['windows_ms']]}), "
          f"{out['queries_per_s']:.1f} queries/s, gallery {args.gallery}, k {args.k}; "
          f"on {smi}", flush=True)

    jpeg = JPEG.read_bytes()
    decode_rgb(jpeg, device)  # the nvJPEG binding's build
    n_img = 32
    tic = time.perf_counter()
    for _ in range(n_img):
        clip_preprocess(decode_rgb(jpeg, device), 224)
    out["b64_image_decode_preprocess_ms_per_image"] = (time.perf_counter() - tic) / n_img * 1e3
    print(f"decode + preprocess of {JPEG.name}: "
          f"{out['b64_image_decode_preprocess_ms_per_image']:.4f} ms per image; on {smi}",
          flush=True)

    server = RetrievalHTTPServer(service, tokenizer=tokenize, port=0,
                                 max_batch=max(16, args.batch))
    server.warmup(max_bucket=max(16, args.batch))
    server.start()
    try:
        b64 = base64.b64encode(jpeg).decode()
        cases = {
            "text_1": ("/search/text", {"queries": [QUERY_WORDS[0]], "k": args.k}),
            f"text_{args.batch}": ("/search/text", {
                "queries": [QUERY_WORDS[i % len(QUERY_WORDS)] + f" {i}"
                            for i in range(args.batch)], "k": args.k}),
            "image_b64_1": ("/search/image", {"images_b64": [b64], "k": args.k}),
        }
        for name, (path, payload) in cases.items():
            lat = http_latency(server.port, path, payload, HTTP_REQUESTS)
            out[f"http_{name}"] = lat
            print(f"HTTP {path} {name}: p50 {lat['p50_ms']:.4f} ms, p99 {lat['p99_ms']:.4f} "
                  f"ms, mean {lat['mean_ms']:.4f} ms over {lat['requests']} requests; "
                  f"on {smi}", flush=True)
    finally:
        server.shutdown()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
