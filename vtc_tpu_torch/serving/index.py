"""Retrieval serving: an exact top-k index resident on the device, and a
service that encodes queries with the model towers and ranks them.

Port of ``vtc_tpu/serving/index.py``. Ranking is normalize -> matmul ->
isfinite mask -> a stable descending sort: plain ops, as JAX's ``_rank`` is
XLA and not a Pallas kernel. The sort keeps ``lax.top_k``'s order:
descending score, ties lower gallery row first (``torch.topk`` leaves the
order of ties open, and so which of a tie group at the k-th score come
back). The HTTP front end is ``serving/server.py``.

The gallery may be sharded by rows over a list of ``devices``, as
``vtc_tpu`` shards it over its mesh's data axis (``index.py:79-98``): the
rows are padded with ``(-n) mod shards`` rows of -inf, so every shard holds
the same count, and shard ``s`` holds rows ``s·R … (s+1)·R``. Each shard
ranks its rows with the same stable sort and keeps its top ``k``; the
candidates, in shard order, merge by a stable sort on the score, which puts
ties lower global row first, ``lax.top_k``'s order over the whole gallery. A
pad row scores -inf (its products are not finite) and ranks after every
real row; where ``k`` reaches past the real rows it surfaces as id -1, as
in ``vtc_tpu`` (``index.py:113``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ..models.layers import l2_normalize


class RetrievalIndex:
    """Exact dense retrieval over L2-normalized embeddings. ``ids`` are
    integer identifiers aligned with the gallery rows; the gallery is
    normalized on add, so a dot product ranks as cosine and as flat L2.
    ``devices`` (several, or one device more than once) shards the rows,
    one shard on each; the queries and the merge run on the first."""

    def __init__(self, embed_dim: int,
                 device: Optional[Union[str, torch.device]] = None,
                 devices: Optional[Sequence[Union[str, torch.device]]] = None):
        self.embed_dim = embed_dim
        if devices:
            self.devices = [resolve_device(d) for d in devices]
            self.device = self.devices[0]
        else:
            self.device = resolve_device(device)
            self.devices = [self.device]
        self._chunks = []
        self._ids = []
        self._shards = None  # per device, [R, d] fp32
        self._gallery_ids = None  # [n] int64 numpy
        self._n_real = 0

    def __len__(self):
        if self._shards is not None:
            return self._n_real
        return int(sum(c.shape[0] for c in self._chunks))

    def _rows(self) -> np.ndarray:
        """The real rows of a materialized gallery, on the host."""
        return np.concatenate([g.cpu().numpy() for g in self._shards])[: self._n_real]

    def add(self, embeddings, ids) -> None:
        if self._shards is not None:
            # re-open a materialized index: its real rows go back to staging
            self._chunks = [self._rows()]
            self._ids = [self._gallery_ids]
            self._shards = None
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
        if self._shards is not None or not self._chunks:
            return
        gallery = np.concatenate(self._chunks)
        self._gallery_ids = np.concatenate(self._ids)
        self._n_real = gallery.shape[0]
        n = len(self.devices)
        pad = (-gallery.shape[0]) % n
        if pad:
            gallery = np.concatenate(
                [gallery, np.full((pad, gallery.shape[1]), -np.inf, np.float32)])
        rows = gallery.shape[0] // n
        self._shards = [torch.from_numpy(gallery[s * rows:(s + 1) * rows]).to(d)
                        for s, d in enumerate(self.devices)]
        self._chunks = []
        self._ids = []

    @torch.no_grad()
    def search(self, query_embeddings, k: int = 10):
        """-> (ids [nq, k] numpy int64, scores [nq, k] numpy fp32), each
        row by descending score, ties lower gallery row first; a pad row of
        a sharded gallery is id -1 (the columns stop at the gallery's rows,
        padding included)."""
        self._materialize()
        if self._shards is None:
            raise ValueError("index is empty")
        q = l2_normalize(torch.as_tensor(query_embeddings, device=self.device).float())
        scores, rows = [], []
        for s, g in enumerate(self._shards):
            local = q.to(g.device) @ g.T
            local = torch.where(torch.isfinite(local), local, float("-inf"))
            ranked, order = torch.sort(local, dim=-1, descending=True, stable=True)
            scores.append(ranked[:, :k].to(self.device))
            rows.append(order[:, :k].to(self.device) + s * g.shape[0])
        if len(scores) > 1:  # candidates in shard order: a stable sort keeps row order
            ranked, pos = torch.sort(torch.cat(scores, 1), dim=-1, descending=True,
                                     stable=True)
            top = torch.gather(torch.cat(rows, 1), 1, pos)[:, :k].cpu().numpy()
            ranked = ranked[:, :k]
        else:
            top, ranked = rows[0].cpu().numpy(), scores[0]
        ids = np.where(top < self._n_real,
                       self._gallery_ids[np.minimum(top, self._n_real - 1)], -1)
        return ids, ranked.cpu().numpy()

    def save(self, path) -> None:
        self._materialize()
        if self._shards is None:
            raise ValueError("cannot save an empty RetrievalIndex")
        np.savez(path, embeddings=self._rows(), reddit_ids=self._gallery_ids)

    @classmethod
    def load(cls, path, device=None, devices=None) -> "RetrievalIndex":
        with np.load(path) as z:
            emb, ids = z["embeddings"], z["reddit_ids"]
        index = cls(embed_dim=emb.shape[-1], device=device, devices=devices)
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
