"""Dataset-generic retrieval evaluation (MSRVTT / MSVD / K700 / Reddit /
livebot): the port of ``vtc_tpu/evaluation/retrieval_eval.py`` on one
device (the reference's ``evaluation/retrieval_evaluation.py:23-268``).

Per video: subsample frames at ``frame_stride``, split them into chunks of
8 frames (the tail linspace-padded), share the video's comments (up to 5)
across its captions and chunks, forward, mean-pool the chunk embeddings,
pad ragged caption sets with -inf, and compute bidirectional R@1/5/10.
Chunk and caption counts are padded to power-of-two buckets (the last row
repeated, the padding rows dropped), as the JAX package does for its
compiled shapes, so the towers see the batches that it sees.

The recall table is a ``RecallTable``: the card's machine has no pandas.
It has the ``DataFrame``'s column names, ``R@k`` index and percent scaling,
and ``to_csv`` writes the bytes that ``DataFrame.to_csv`` writes.

Under a process group each process encodes the strided disjoint video
subset ``rank::world`` and the embeddings are merged by
``allgather_varlen`` in the dataset's order before the ranking, as
``vtc_tpu/evaluation/retrieval_eval.py:352-425`` does; a process left
without embeddings joins the gathers with empty blocks. ``mesh`` (the
current ``parallel.mesh.create_mesh``'s, as ``vtc_tpu``'s evaluation takes
its mesh) splits the videos over its data axis, the model's forward over
its model axis (the model split by ``parallel.tensor.shard_model``), and
ranks the queries with ``recall_at_k_sharded`` over the data group.

A model that ZeRO-3 shards (``parallel.mesh.fully_shard_model``: the
trainer's probe under ``--fsdp``) gathers over the data group at every
forward, and the strided split gives the ranks different numbers of
forwards (videos, and chunks per video). So the encode runs on the gathered
parameters (``parallel.mesh.gathered_parameters``): every unit is gathered
once before it, its forwards run no collective, and it is sharded again
after; the ranks then merge and rank as above.
``dataset=`` takes any object
with ``__len__`` and ``__getitem__`` that gives ``(frames, captions,
comments, meta)`` or ``(frames, captions, meta)`` items, frames as uint8
``[t, h, w, 3]`` or preprocessed float ``[t, 3, h, w]`` (None where the
decode failed).
"""

from __future__ import annotations

import csv
import logging
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..data.datasets import clip_preprocess_batch
from ..data import tokenizer as tk
from ..device import resolve_device
from ..ops.retrieval import recall_at_k, recall_at_k_sharded
from ..parallel.mesh import (
    current_mesh,
    data_group,
    gathered_parameters,
    model_rank,
    model_world,
    process_share,
)
from ..parallel.tensor import model_axis
from ..utils.util import all_max, allgather_varlen

logger = logging.getLogger(__name__)

N_COMMENTS = 5
NFRAMES = 8
RECALL_RANGE = (1, 5, 10)
DATASETS = {  # the names retrieval_evaluation builds, and their data module class
    "MSRVTT_videos": ("MSRVTT", "VideoDatasetMSRVTT"),
    "MSVD_videos": ("MSVD", "VideoDatasetMSVD"),
    "K700_videos": ("K700", "VideoDatasetK700Comments"),
    "Reddit_videos": ("Reddit", "VideoDatasetReddit"),
    "livebot": ("livebot", "VideoDatasetLivebot"),
}


class RecallTable:
    """The recall ``DataFrame`` without pandas: float columns by name over
    the ``R@k`` index."""

    def __init__(self, columns: Dict[str, Sequence[float]], index: Sequence[str]):
        self.columns = list(columns)
        self.index = list(index)
        self._values = np.stack([np.asarray(v, np.float64) for v in columns.values()], 1)

    @property
    def shape(self):
        return self._values.shape

    def to_numpy(self) -> np.ndarray:
        return self._values.copy()

    def to_csv(self, path) -> None:
        """Write the CSV that ``DataFrame.to_csv(path)`` writes: an empty
        corner cell, the column names, one line per row, floats by
        ``repr``."""
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(["", *self.columns])
            for label, values in zip(self.index, self._values):
                w.writerow([label, *(repr(float(v)) for v in values)])

    def __repr__(self) -> str:
        width = max(len(c) for c in self.columns)
        lines = ["     " + "  ".join(c.rjust(width) for c in self.columns)]
        for label, values in zip(self.index, self._values):
            lines.append(f"{label:<5}" + "  ".join(f"{v:{width}.6f}" for v in values))
        return "\n".join(lines)


def _recall_df(vt_fracs, tv_fracs, dataset_name, split) -> RecallTable:
    """Percent-scaled bidirectional recall table (one assembly for the
    1-caption and ragged paths)."""
    table = RecallTable(
        {
            f"{dataset_name} {split} split Video to Text": np.asarray(vt_fracs) * 100.0,
            f"{dataset_name} {split} split Text to Video": np.asarray(tv_fracs) * 100.0,
        },
        index=[f"R@{k}" for k in RECALL_RANGE],
    )
    logger.info("%s", table)
    return table


def _check_mesh(mesh) -> None:
    if mesh is not None and mesh is not current_mesh():
        raise ValueError(f"mesh {mesh!r} is not the process group's: pass the mesh of "
                         f"parallel.mesh.create_mesh")


def _recall(gallery, queries, mesh, device, targets=None):
    if mesh is None:
        return recall_at_k(gallery, queries, RECALL_RANGE, targets=targets, device=device)
    return recall_at_k_sharded(gallery, queries, RECALL_RANGE, group=data_group(),
                               targets=targets, device=device)


def compute_recall(tensor_v, tensor_t, split="full-test", dataset_name="MSRVTT", mesh=None,
                   device=None) -> RecallTable:
    """Bidirectional R@1/5/10 table (``retrieval_evaluation.py:23-47``);
    with ``mesh`` the queries are ranked over its data group
    (``recall_at_k_sharded``), every rank returning the same table."""
    _check_mesh(mesh)
    vtr = [r for _, r in _recall(tensor_v, tensor_t, mesh, device)]
    tvr = [r for _, r in _recall(tensor_t, tensor_v, mesh, device)]
    return _recall_df(tvr, vtr, dataset_name, split)


def _bucket(n: int, minimum: int = 1) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _ensure_preprocessed(chunks: np.ndarray, image_size: int = 224) -> np.ndarray:
    """Raw uint8 ``[..., h, w, 3]`` frames get the CLIP transform here
    (``data.clip_preprocess_batch``: PIL's bicubic resize of every frame
    on threads, centre crop, CLIP normalization), after stride and chunk
    selection; float CHW inputs pass through unchanged."""
    arr = np.asarray(chunks)
    if arr.dtype != np.uint8 or arr.shape[-1] != 3:
        return arr
    lead = arr.shape[:-3]
    flat = clip_preprocess_batch(arr.reshape((-1,) + arr.shape[-3:]), image_size)
    return flat.reshape(lead + flat.shape[1:])


def chunk_frames(frames: np.ndarray, frame_stride: int, nframes: int = NFRAMES) -> np.ndarray:
    """``[t, ...]`` -> ``[nchunks, nframes, ...]`` with the tail
    linspace-padded (``retrieval_evaluation.py:174-198``)."""
    frames = frames[::frame_stride]
    t = frames.shape[0]
    chunks = []
    for s in range(0, t, nframes):
        x = frames[s : s + nframes]
        if x.shape[0] != nframes:
            idx = np.floor(np.linspace(0, x.shape[0] - 1, nframes)).astype(np.int64)
            x = x[idx]
        chunks.append(x)
    return np.stack(chunks)


def make_eval_forward(model, branch_override: Optional[str]):
    """``(frames, captions, comments, needs_comments) -> (feats_vis,
    feats_text)``: the model's eval forward without gradients, with the
    CAM's branch overridden where ``branch_override`` says, and the
    comments passed only where ``needs_comments``."""

    @torch.no_grad()
    def forward(frames, captions, comments, needs_comments: bool):
        if needs_comments:
            out = model(frames, captions, comments, branch_override=branch_override)
        else:
            out = model(frames, captions)
        return out[0], out[1]

    return forward


def _encode_local(model, dataset, indices, *, frame_stride, first_frame_only,
                  first_chunk_only, branch_override, needs_comments, image_size, nframes,
                  device):
    """Encode the videos at ``indices``: ``(ids, video_means [nv, D],
    caption_embs list of [ncap_i, D])``."""
    fwd = make_eval_forward(model, branch_override)
    empty_comment = tk.tokenize([""] * N_COMMENTS)

    ids, video_means, caption_embs = [], [], []
    for idx in indices:
        item = dataset[idx]
        if len(item) == 3:
            frames, captions, _ = item
            comments = None
        else:
            frames, captions, comments, _ = item
        if frames is None:  # the decode failed
            continue
        captions = np.asarray(captions)
        if captions.ndim != 2:
            raise ValueError(f"item {idx}: captions must be [n, tokens], got {captions.shape}")

        if first_frame_only:
            if first_chunk_only:
                raise ValueError("first_frame_only and first_chunk_only exclude each other")
            # one frame as a batch of one image (retrieval_evaluation.py:165-172)
            chunks = _ensure_preprocessed(np.asarray(frames)[0:1], image_size)
        else:
            chunks = chunk_frames(np.asarray(frames), frame_stride, nframes)
            if first_chunk_only:
                chunks = chunks[0:1]
            chunks = _ensure_preprocessed(chunks, image_size)
        ncap, nchunk = captions.shape[0], chunks.shape[0]

        # one comment row [1, n <= 5, 77], shared by every caption and chunk
        comm = None
        if needs_comments:
            comm = empty_comment[None] if comments is None else (
                np.asarray(comments)[:N_COMMENTS][None])

        cb, kb = _bucket(nchunk), _bucket(ncap)
        chunks_p = np.concatenate([chunks, np.repeat(chunks[-1:], cb - nchunk, axis=0)]
                                  ) if cb > nchunk else chunks
        captions_p = np.concatenate([captions, np.repeat(captions[-1:], kb - ncap, axis=0)]
                                    ) if kb > ncap else captions

        fv, ft = fwd(torch.as_tensor(chunks_p, device=device),
                     torch.as_tensor(captions_p, device=device),
                     torch.as_tensor(comm, device=device) if comm is not None else None,
                     needs_comments)
        ids.append(int(idx))
        video_means.append(fv.float().cpu().numpy()[:nchunk].mean(axis=0))
        caption_embs.append(ft.float().cpu().numpy()[:ncap])
    return ids, video_means, caption_embs


def _flatten_caps(ids, caption_embs):
    """Concatenate per-video caption embeddings; tag each row with its
    video's dataset index."""
    flat_caps = np.concatenate(caption_embs)
    cap_vid = np.concatenate([np.full(c.shape[0], vid, np.int64)
                              for vid, c in zip(ids, caption_embs)])
    return flat_caps, cap_vid


def _model_device(model, device) -> torch.device:
    """``device`` (default: the card), which the model's weights must be
    on."""
    device = resolve_device(device)
    got = next(model.parameters()).device
    if got.type != device.type:
        raise ValueError(f"the model is on {got}, the evaluation on {device}")
    return got


def retrieval_evaluation(model, datasetname: str, split: str, out_csv: Optional[str] = None,
                         frame_stride: int = 16, first_frame_only: bool = False,
                         first_chunk_only: bool = False, branch_override: Optional[str] = None,
                         needs_comments: Optional[bool] = None, dataset=None,
                         data_roots: Optional[dict] = None, image_size: int = 224,
                         nframes: int = NFRAMES, mesh=None, process_index: Optional[int] = None,
                         process_count: Optional[int] = None, device=None) -> RecallTable:
    """Evaluate ``model`` on a transfer dataset on ``device`` (default: the
    card, which the model must be on); returns the recall table, also
    written to ``out_csv`` (by rank 0) where given. Under a process group
    each process encodes its strided share (``process_index``/
    ``process_count``, the data axis's by default); with ``mesh`` a model
    split over its model axis runs its split forward."""
    _check_mesh(mesh)
    if model_world() > 1 and model_axis(model) is None:
        raise ValueError(f"a mesh of {model_world()} model ranks evaluates a split model: "
                         f"split it with parallel.tensor.shard_model")
    pidx, pcount = process_share(process_index, process_count)
    device = _model_device(model, device)
    if dataset is None:
        if datasetname not in DATASETS:
            raise ValueError("Unknown dataset")
        from .. import data as module_data

        root_key, cls = DATASETS[datasetname]
        dataset = getattr(module_data, cls)(train=False, split=split,
                                            **(data_roots or {}).get(root_key, {}))

    if needs_comments is None:
        needs_comments = hasattr(model, "branch_to_adapt_val")

    logger.info("Computing joint embeddings")
    indices = range(pidx, len(dataset), pcount)
    with gathered_parameters(model):  # ZeRO-3: no collective in the forwards
        ids, video_means, caption_embs = _encode_local(
            model, dataset, indices, frame_stride=frame_stride,
            first_frame_only=first_frame_only, first_chunk_only=first_chunk_only,
            branch_override=branch_override, needs_comments=needs_comments,
            image_size=image_size, nframes=nframes, device=device)
    if not ids and pcount == 1:
        raise RuntimeError(
            f"retrieval evaluation produced no embeddings: all {len(indices)} items of "
            f"{datasetname}/{split} failed to decode or the split is empty (check the data "
            f"root paths)")

    if ids:
        ids = np.asarray(ids, np.int64)
        video_tensor = np.asarray(np.stack(video_means), np.float32)
        flat_caps, cap_vid = _flatten_caps(ids, caption_embs)
        flat_caps = np.asarray(flat_caps, np.float32)
    else:
        logger.warning("process %d/%d produced no embeddings (all %d of its items failed to "
                       "decode); it joins the gathers with empty blocks", pidx, pcount,
                       len(indices))
        ids, cap_vid = np.zeros((0,), np.int64), np.zeros((0,), np.int64)
        video_tensor = flat_caps = None
    if pcount > 1:
        dim = all_max(0 if video_tensor is None else video_tensor.shape[1])
        if dim == 0:
            raise RuntimeError(
                f"retrieval evaluation produced no embeddings on ANY of {pcount} processes: "
                f"{datasetname}/{split} failed to decode everywhere or the split is empty "
                f"(check the data root paths)")
        if video_tensor is None:
            video_tensor = flat_caps = np.zeros((0, dim), np.float32)
        ids, video_tensor, flat_caps, cap_vid = (
            allgather_varlen(a, data_group()) for a in (ids, video_tensor, flat_caps, cap_vid))
    # the dataset's order, whatever the number of processes: videos by
    # index, captions after their video's
    order = np.argsort(ids, kind="stable")
    ids, video_tensor = ids[order], video_tensor[order]
    cap_order = np.argsort(cap_vid, kind="stable")
    flat_caps, cap_vid = flat_caps[cap_order], cap_vid[cap_order]
    row_of = {int(v): i for i, v in enumerate(ids)}
    flat_targets = np.asarray([row_of[int(v)] for v in cap_vid], np.int64)
    max_len = int(np.bincount(flat_targets, minlength=len(ids)).max())

    if max_len == 1:
        table = compute_recall(video_tensor, flat_caps, split=split, dataset_name=datasetname,
                               mesh=mesh, device=device)
    else:
        # text -> video: every real caption is a query, its target its video
        tvr = [r for _, r in _recall(video_tensor, flat_caps, mesh, device, flat_targets)]
        # video -> text: a video hits if any of its captions is in its top k
        vt_hits = _vt_recall(video_tensor, flat_caps, flat_targets, RECALL_RANGE, device)
        table = _recall_df(vt_hits, tvr, datasetname, split)

    if out_csv is not None and pidx == 0 and model_rank() == 0:
        table.to_csv(out_csv)
    return table


def _vt_recall(videos, captions, cap_video_idx, k_vals, device=None) -> np.ndarray:
    """Video -> text recall over a flattened caption gallery: a video scores
    a hit at k if one of its own captions is among its top k. The JAX
    package ranks with ``lax.top_k`` (ties lower index first); here the
    place of the video's first own caption in that order is counted from
    the scores, as ``recall_at_k`` counts a target's."""
    device = resolve_device(device)
    v = torch.as_tensor(np.asarray(videos, np.float32), device=device)
    c = torch.as_tensor(np.asarray(captions, np.float32), device=device)
    owner = torch.as_tensor(np.asarray(cap_video_idx), device=device)
    scores = v @ c.T
    scores = torch.where(torch.isfinite(scores), scores, torch.full_like(scores, -torch.inf))
    own = owner[None, :] == torch.arange(v.shape[0], device=device)[:, None]
    best = torch.where(own, scores, torch.full_like(scores, -torch.inf)).max(-1, keepdim=True)[0]
    index = torch.arange(c.shape[0], device=device)[None, :]
    first = torch.where(own & (scores == best), index, c.shape[0]).min(-1, keepdim=True)[0]
    place = torch.sum((scores > best) | ((scores == best) & (index < first)), -1)
    return np.array([int(torch.sum(place < int(k))) / v.shape[0] for k in k_vals])


__all__ = [
    "N_COMMENTS", "NFRAMES", "RECALL_RANGE", "RecallTable", "chunk_frames", "compute_recall",
    "make_eval_forward", "retrieval_evaluation",
]
