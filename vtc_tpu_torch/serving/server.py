"""HTTP serving for the retrieval service, the port of
``vtc_tpu/serving/server.py`` (stdlib only).

* The stdlib ``ThreadingHTTPServer``; requests funnel through one lock
  around the model and index work, so one query batch runs on the device
  at a time and the service's power-of-two query buckets are the only
  batch shapes the towers see;
* ``warmup()`` runs the text buckets up to a cap once before traffic.

Endpoints (JSON in and out):

  GET  /healthz                   -> {"status": "ok", "gallery_size": N}
  POST /search/text  {"queries": ["a cat", ...], "k": 10}
  POST /search/image {"images": [[...]], "k": 10}    # [n, 3, H, W] floats
                                                      # (preprocessed)
  POST /search/image {"images_b64": ["<base64 JPEG/PNG>", ...], "k": 10}
       # encoded bytes, decoded on the service's device (on the card: a
       # JPEG by nvJPEG and the ycc_to_rgb kernel, a PNG by data/png.py; on
       # the CPU: PIL), then CLIP-preprocessed on the host (PIL's resampler,
       # data/preprocess.py)
  all  -> {"ids": [[...]], "scores": [[...]]}

A malformed request (undecodable image bytes included) gets a 400 with
the reason, an unknown path a 404, anything else a 500 (logged): a
decoder's own fault, such as an nvJPEG binding that does not build, is not
the client's.
"""

from __future__ import annotations

import base64
import binascii
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..data.image_io import ImageInputError, decode_rgb
from ..data.preprocess import clip_preprocess

logger = logging.getLogger(__name__)


class RetrievalHTTPServer:
    """A ``ClipRetrievalService`` (and a tokenizer for text queries) behind
    HTTP. ``port=0`` binds a free port; ``serve()`` blocks, ``start()``
    runs the accept loop on a daemon thread and returns the port."""

    def __init__(self, service, tokenizer=None, host="127.0.0.1", port=8000,
                 max_k: int = 100, max_batch: int = 1024, image_size: int = 224):
        self.service = service
        self.tokenizer = tokenizer
        self.max_k = int(max_k)
        self.max_batch = int(max_batch)
        self.image_size = int(image_size)
        self._lock = threading.Lock()  # one query batch on the device at a time
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # to logging, not stderr
                logger.debug("%s - %s", self.address_string(), fmt % args)

            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, {"status": "ok",
                                      "gallery_size": len(outer.service.index)})
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                except ValueError as e:  # json.JSONDecodeError is one
                    self._reply(400, {"error": f"bad JSON: {e}"})
                    return
                routes = {"/search/text": outer.search_text,
                          "/search/image": outer.search_image}
                if self.path not in routes:
                    self._reply(404, {"error": f"unknown path {self.path}"})
                    return
                try:
                    if not isinstance(req, dict):
                        raise ValueError("the request must be a JSON object")
                    payload = routes[self.path](req)
                except ValueError as e:
                    self._reply(400, {"error": str(e)})
                    return
                except Exception:  # noqa: BLE001 - a serving loop must not die
                    logger.exception("request failed")
                    self._reply(500, {"error": "internal error"})
                    return
                self._reply(200, payload)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread = None

    # ------------------------------------------------------------------ #

    def _k(self, req) -> int:
        k = int(req.get("k", 10))
        if not 1 <= k <= self.max_k:
            raise ValueError(f"k must be in [1, {self.max_k}], got {k}")
        return k

    def _check_batch(self, n: int) -> None:
        if n == 0:
            raise ValueError("empty query batch")
        if n > self.max_batch:
            raise ValueError(f"batch too large ({n} > max_batch={self.max_batch})")

    def search_text(self, req: dict) -> dict:
        queries = req.get("queries")
        if not isinstance(queries, list) or not all(isinstance(q, str) for q in queries):
            raise ValueError('"queries" must be a list of strings')
        self._check_batch(len(queries))
        if self.tokenizer is None:
            raise ValueError("server started without a tokenizer")
        tokens = np.asarray(self.tokenizer(queries), np.int32)
        if tokens.ndim != 2:
            raise ValueError(f"tokenizer returned shape {tokens.shape}, expected [n, L]")
        k = self._k(req)
        with self._lock:
            ids, scores = self.service.search_text(tokens, k=k)
        return {"ids": ids.tolist(), "scores": scores.tolist()}

    def decode_b64_images(self, items) -> np.ndarray:
        """base64 JPEG/PNG -> CLIP-preprocessed float32 ``[n, 3, S, S]``,
        decoded on the service's device (``image_io.decode_rgb``): the same
        array a client gets by decoding the bytes on that route,
        preprocessing with ``clip_preprocess`` and posting floats. Bytes at
        fault (``ImageInputError``) are the client's 400; any other failure
        of the decode (the nvJPEG binding's build, a launch, the card) is
        the server's, and reaches the 500 path."""
        if not isinstance(items, list) or not all(isinstance(s, str) for s in items):
            raise ValueError('"images_b64" must be a list of base64 strings')
        self._check_batch(len(items))
        out = []
        for i, s in enumerate(items):
            try:
                raw = base64.b64decode(s, validate=True)
            except (binascii.Error, ValueError) as e:
                raise ValueError(f"images_b64[{i}]: not base64: {e}") from e
            try:
                img = decode_rgb(raw, self.service.device, f"images_b64[{i}]")
            except ImageInputError as e:
                raise ValueError(f"images_b64[{i}]: cannot decode image: {e}") from e
            out.append(clip_preprocess(img, self.image_size))
        return np.stack(out)

    def search_image(self, req: dict) -> dict:
        images = req.get("images")
        b64 = req.get("images_b64")
        if (images is None) == (b64 is None):
            raise ValueError('provide exactly one of "images" (preprocessed floats) or '
                             '"images_b64" (encoded JPEG/PNG bytes)')
        if b64 is not None:
            arr = self.decode_b64_images(b64)
        else:
            arr = np.asarray(images, np.float32)
            if arr.ndim != 4:
                raise ValueError(f"images must be a 4-D batch, got shape {arr.shape}")
            self._check_batch(arr.shape[0])
        k = self._k(req)
        with self._lock:
            ids, scores = self.service.search_image(arr, k=k)
        return {"ids": ids.tolist(), "scores": scores.tolist()}

    # ------------------------------------------------------------------ #

    def warmup(self, context_length: int = 77, max_bucket: int = 16) -> None:
        """Run a text query batch of each power-of-two bucket up to
        ``max_bucket`` once (first launches: Triton's compiles, cuBLAS's
        heuristics), so live traffic does not pay for them."""
        b = 1
        while b <= max_bucket:
            tokens = np.zeros((b, context_length), np.int32)
            with self._lock:
                self.service.search_text(tokens, k=1)
            b *= 2

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> int:
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self.port

    def serve(self) -> None:
        logger.info("serving on %s:%d", *self._httpd.server_address)
        self._httpd.serve_forever()

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
