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

Inputs are tensors, computed on their device, or numpy arrays, put on
``device`` (default: the card; raises without one). The sharded and chunked
variants wait for the port of distribution and the evaluation scripts.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device


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
    scores = l2_scores(gallery, queries)
    ts = _target_scores(scores, targets)
    lower = torch.arange(scores.shape[1], device=scores.device)[None, :] < targets[:, None]
    place = torch.sum((scores > ts) | ((scores == ts) & lower), dim=-1)
    nq = place.shape[0]
    return [(int(k), int(torch.sum(place < int(k))) / nq) for k in k_vals]


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
