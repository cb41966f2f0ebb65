"""Exact retrieval metrics on one device, the port of
``vtc_tpu/ops/retrieval.py:30-116`` (the reference's FAISS
``GpuIndexFlatL2``, ``model/metric.py:103-187``).

Flat L2 ranking is one matmul: ``argmin ‖g − q‖² == argmax (q·g − ½‖g‖²)``,
in fp32. Non-finite scores (the reference pads ragged caption sets with −inf
rows) become −inf and rank last.

``recall_at_k`` counts a hit where the JAX package's ``lax.top_k`` puts the
target among the first ``k``: ``top_k`` returns ties lower index first,
``torch.topk`` on the card promises no order, so the target's place is
counted, not read from ``topk``: the items that score strictly higher, plus
those that score equal at a lower index. ``ranks_of_targets`` counts only
the strictly higher ones, as JAX's does.

``recall_at_k_chunked`` streams the gallery in tiles of ``chunk`` rows,
so the ``[nq, ng]`` score matrix never exists whole; it counts the same
place from the same tile scores in two passes (the target's score, then the
items ahead of it), so it keeps ``recall_at_k``'s contract on ties.

``recall_at_k_sharded`` splits the query axis over a process group's ranks
(``vtc_tpu/ops/retrieval.py:144-197``): every rank holds the whole gallery
and queries, ranks its contiguous share of the queries, and the targets'
places are gathered in rank order, so the hits are ``recall_at_k``'s.

Inputs are tensors, computed on their device, or numpy arrays, put on
``device`` (default: the card; raises without one).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..utils.util import allgather_varlen, rank, world


def _as_tensor(x, device: Optional[torch.device]) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def _operands(features_a, features_b, targets, device):
    """(gallery, queries, targets) on one device: that of a tensor gallery,
    else ``device``."""
    if device is not None or not isinstance(features_a, torch.Tensor):
        device = resolve_device(device)
    gallery = _as_tensor(features_a, device)
    queries = _as_tensor(features_b, gallery.device)
    if targets is None:
        targets = torch.arange(queries.shape[0], device=gallery.device)
    else:
        targets = _as_tensor(targets, gallery.device).long()
    return gallery, queries, targets


def l2_scores(gallery: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """score[i, j] = q_i·g_j − ½‖g_j‖², higher is closer; [nq, ng] fp32."""
    g = gallery.float()
    q = queries.float()
    scores = q @ g.T - 0.5 * torch.sum(g * g, dim=-1)[None, :]
    return torch.where(torch.isfinite(scores), scores,
                       torch.full_like(scores, -torch.inf))


def _target_scores(scores: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.take_along_dim(scores, targets[:, None], dim=-1)


def recall_at_k(features_a, features_b, k_vals: Sequence[int] = (1, 5, 10),
                targets=None, device=None):
    """R@K of retrieving ``features_a`` items from ``features_b`` queries:
    gallery = features_a, queries = features_b, the target of query i
    defaults to i (``model/metric.py:137-161``). A gallery smaller than
    ``k`` holds every target within its top ``k``. Returns
    ``[(k, recall), ...]``."""
    gallery, queries, targets = _operands(features_a, features_b, targets, device)
    place = _places(gallery, queries, targets)
    nq = place.shape[0]
    return [(int(k), int(torch.sum(place < int(k))) / nq) for k in k_vals]


def _places(gallery, queries, targets) -> torch.Tensor:
    """Each query's target's place: the items scoring above it, and those
    scoring equal at a lower index."""
    scores = l2_scores(gallery, queries)
    ts = _target_scores(scores, targets)
    lower = torch.arange(scores.shape[1], device=scores.device)[None, :] < targets[:, None]
    return torch.sum((scores > ts) | ((scores == ts) & lower), dim=-1)


def recall_at_k_sharded(features_a, features_b, k_vals: Sequence[int] = (1, 5, 10),
                        group=None, targets=None, device=None):
    """``recall_at_k`` with the query axis split over the ranks of
    ``group`` (default: the process group; one process: ``recall_at_k``'s
    work). Every rank passes the same arrays; rank ``r`` ranks the queries
    ``r·⌈nq/W⌉ …`` against the whole gallery, and the places are gathered
    (``allgather_varlen``) before they are counted, so every rank returns
    the same ``[(k, recall), ...]``."""
    gallery, queries, targets = _operands(features_a, features_b, targets, device)
    nq = queries.shape[0]
    per = -(-nq // world(group))
    lo, hi = min(rank(group) * per, nq), min((rank(group) + 1) * per, nq)
    place = _places(gallery, queries[lo:hi], targets[lo:hi]).cpu().numpy()
    places = allgather_varlen(place, group)
    return [(int(k), int(np.sum(places < int(k))) / nq) for k in k_vals]


def ranks_of_targets(features_a, features_b, targets=None, device=None) -> np.ndarray:
    """Full rank (1-based) of each query's target: 1 + the items scoring
    strictly higher than it. Powers median/mean rank."""
    gallery, queries, targets = _operands(features_a, features_b, targets, device)
    scores = l2_scores(gallery, queries)
    ranks = 1 + torch.sum(scores > _target_scores(scores, targets), dim=-1)
    return ranks.cpu().numpy()


def retrieval_metrics(features_a, features_b, k_vals=(1, 5, 10), targets=None,
                      device=None):
    """Full metric suite: R@K + median/mean rank."""
    ranks = ranks_of_targets(features_a, features_b, targets, device)
    out = {f"R@{k}": float((ranks <= k).mean()) for k in k_vals}
    out["median_rank"] = float(np.median(ranks))
    out["mean_rank"] = float(ranks.mean())
    return out


def recall_at_k_chunked(features_a, features_b, k_vals: Sequence[int] = (1, 5, 10),
                        targets=None, chunk: int = 2048, device=None):
    """``recall_at_k`` over a gallery streamed in tiles of ``chunk`` rows
    (the port of ``vtc_tpu/ops/retrieval.py:238``, whose ``lax.scan``
    merges a running ``lax.top_k``, ``:199``). A running top-k cannot keep
    the lower-index-first order of ties that ``lax.top_k`` gives where
    ``torch.topk`` promises none, so the target's place is counted as
    ``recall_at_k`` counts it: a first pass takes each query's target score
    from the tile that holds the target, a second counts, tile by tile, the
    items scoring above it and those tying at a lower index. Both passes
    score each tile with the same ``torch.matmul``, so the comparisons see
    the same values. The memory is ``[nq, chunk]``; the score work twice the
    dense version's."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    gallery, queries, targets = _operands(features_a, features_b, targets, device)
    ng, nq = gallery.shape[0], queries.shape[0]
    tiles = [(lo, gallery[lo:lo + chunk]) for lo in range(0, ng, chunk)]
    target_scores = torch.full((nq,), -torch.inf, device=gallery.device)
    for lo, tile in tiles:
        scores = l2_scores(tile, queries)
        inside = (targets >= lo) & (targets < lo + tile.shape[0])
        pos = (targets - lo).clamp(0, tile.shape[0] - 1)
        target_scores = torch.where(inside, _target_scores(scores, pos)[:, 0], target_scores)
    ts = target_scores[:, None]
    place = torch.zeros(nq, dtype=torch.long, device=gallery.device)
    for lo, tile in tiles:
        scores = l2_scores(tile, queries)
        index = torch.arange(lo, lo + tile.shape[0], device=gallery.device)[None, :]
        place += torch.sum((scores > ts) | ((scores == ts) & (index < targets[:, None])), -1)
    return [(int(k), int(torch.sum(place < int(k))) / nq) for k in k_vals]
