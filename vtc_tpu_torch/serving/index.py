"""Retrieval serving: an exact top-k index resident on the device, and a
service that encodes queries with the model towers and ranks them.

Port of ``vtc_tpu/serving/index.py`` for one device. Ranking is
normalize -> matmul -> isfinite mask -> a stable descending sort: plain
ops, as JAX's ``_rank`` is XLA and not a Pallas kernel. The sort keeps
``lax.top_k``'s order: descending score, ties lower gallery row first
(``torch.topk`` leaves the order of ties open, and so which of a tie group
at the k-th score come back). The HTTP front end is
``serving/server.py``; the mesh-sharded gallery is not ported (ROADMAP:
Queue 1 item 9).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..models.layers import l2_normalize


class RetrievalIndex:
    """Exact dense retrieval over L2-normalized embeddings. ``ids`` are
    integer identifiers aligned with the gallery rows; the gallery is
    normalized on add, so a dot product ranks as cosine and as flat L2."""

    def __init__(self, embed_dim: int,
                 device: Optional[Union[str, torch.device]] = None):
        self.embed_dim = embed_dim
        self.device = resolve_device(device)
        self._chunks = []
        self._ids = []
        self._gallery = None  # [n, d] fp32 on self.device
        self._gallery_ids = None  # [n] int64 numpy

    def __len__(self):
        if self._gallery is not None:
            return self._gallery.shape[0]
        return int(sum(c.shape[0] for c in self._chunks))

    def add(self, embeddings, ids) -> None:
        if self._gallery is not None:
            # re-open a materialized index: its rows go back to staging
            self._chunks = [self._gallery.cpu().numpy()]
            self._ids = [self._gallery_ids]
            self._gallery = None
            self._gallery_ids = None
        embeddings = np.asarray(embeddings, np.float32)
        if embeddings.ndim != 2 or embeddings.shape[-1] != self.embed_dim:
            raise ValueError(
                f"embeddings must be [n, {self.embed_dim}], got {embeddings.shape}"
            )
        ids = np.asarray(ids, np.int64)
        if ids.shape != (embeddings.shape[0],):
            raise ValueError(f"ids must be [{embeddings.shape[0]}], got {ids.shape}")
        norms = np.linalg.norm(embeddings, axis=-1, keepdims=True)
        self._chunks.append(embeddings / np.maximum(norms, 1e-12))
        self._ids.append(ids)

    def _materialize(self):
        if self._gallery is not None or not self._chunks:
            return
        self._gallery = torch.from_numpy(np.concatenate(self._chunks)).to(self.device)
        self._gallery_ids = np.concatenate(self._ids)
        self._chunks = []
        self._ids = []

    @torch.no_grad()
    def search(self, query_embeddings, k: int = 10):
        """-> (ids [nq, k] numpy int64, scores [nq, k] numpy fp32), each
        row by descending score, ties lower gallery row first."""
        self._materialize()
        if self._gallery is None:
            raise ValueError("index is empty")
        q = torch.as_tensor(query_embeddings, device=self.device).float()
        scores = l2_normalize(q) @ self._gallery.T
        scores = torch.where(torch.isfinite(scores), scores, float("-inf"))
        ranked, order = torch.sort(scores, dim=-1, descending=True, stable=True)
        return (self._gallery_ids[order[:, :k].cpu().numpy()],
                ranked[:, :k].cpu().numpy())

    def save(self, path) -> None:
        self._materialize()
        if self._gallery is None:
            raise ValueError("cannot save an empty RetrievalIndex")
        np.savez(path, embeddings=self._gallery.cpu().numpy(),
                 reddit_ids=self._gallery_ids)

    @classmethod
    def load(cls, path, device=None) -> "RetrievalIndex":
        with np.load(path) as z:
            emb, ids = z["embeddings"], z["reddit_ids"]
        index = cls(embed_dim=emb.shape[-1], device=device)
        index.add(emb, ids)
        return index


class ClipRetrievalService:
    """Model + index: token or image queries against the gallery.

    Queries are padded to power-of-two batch buckets before encoding (row 0
    repeated; the padding rows are dropped before ranking), so the towers
    see a few batch sizes only, as the JAX service, whose XLA programs are
    compiled per shape. The model must be on ``device``, as the index."""

    def __init__(self, model, index: RetrievalIndex,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        for name, dev in (("model", next(model.parameters()).device),
                          ("index", index.device)):
            if dev.type != self.device.type:
                raise ValueError(f"{name} is on {dev}, the service on {self.device}")
        self.model = model
        self.index = index

    @torch.inference_mode()
    def _bucketed(self, encode, queries):
        queries = torch.as_tensor(queries, device=self.device)
        n = queries.shape[0]
        if n > 0:
            bucket = 1 << (n - 1).bit_length()
            if bucket != n:
                pad = queries[:1].expand((bucket - n,) + queries.shape[1:])
                queries = torch.cat([queries, pad])
        return l2_normalize(encode(queries).float())[:n]

    def search_text(self, tokens, k: int = 10):
        return self.index.search(self._bucketed(self.model.encode_text, tokens), k)

    def search_image(self, images, k: int = 10):
        return self.index.search(self._bucketed(self.model.encode_image, images), k)
