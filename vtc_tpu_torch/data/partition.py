"""Dataset partitioning, comment filtering and sampling, cached-feature
loading: the port's own copy of ``vtc_tpu/data/partition.py`` on
``table.Table`` in place of a pandas frame.

* the deterministic train/val/test split by the last base-36 digit of the
  reddit id (test 0-3, val 4-7, train 8-z), ``partition_dataframe``;
* the bot-comment filter list;
* comment sampling (random or first) with empty-string padding;
* cached-feature tables (``load_features``): torch ``.pth`` or ``.npz`` with
  the same schema.
"""

from __future__ import annotations

import ast
import glob
import os
from typing import List, Optional

import numpy as np

from .table import Table

BOT_TEXT_TO_AVOID = [
    "i am a bot",
    "i'm a bot",
    "this is a bot",
    "redditspeedbot",
    "this bot",
    "look at my programming",
    "look at my source code on github",
    "this is a manual removal by a *human moderator*",
    "your post was removed",
    "this post was removed",
    "your post has been removed",
    "community moderation bot",
    "unfortunately it has been removed",
    "thank you for your submission",
    "your submission has been removed",
    "if you feel this was done in error",
    "your post breaks",
    "has been removed for the following reasons",
    "downvote this comment if",
    "redditdownloader",
    "repostsleuthbot",
    "vreddit",
    "savethisvideo",
    "stabbot",
    "[removed]",
    "[deleted]",
    "[excluído]",
    "savevideo",
    "this comment",
]

_DIGITS = "0123456789abcdefghijklmnopqrstuvwxyz"
DIGIT_SPLIT = {
    "test": set(_DIGITS[0:4]),
    "val": set(_DIGITS[4:8]),
    "train": set(_DIGITS[8:]),
}

# a known-corrupt file the reference excludes
CORRUPT_IDS = {"jhgxv7"}


def partition_dataframe(df: Table, root: Optional[str] = None,
                        split: Optional[str] = None) -> Table:
    """Rows of ``split`` by the least significant base-36 digit of the id in
    ``video_path``; with ``root``, only the ids of the ``.mp4`` files under
    it."""
    mp4s = df.video_path.tolist()
    ids = [x.split("/")[-1].split(".")[0] for x in mp4s]

    if root is not None:
        available = glob.glob(os.path.join(root, "**/*.mp4"), recursive=True)
        available_ids = set(x.split("/")[-1].split(".")[0] for x in available)
        available_ids -= CORRUPT_IDS
        print(
            "CSV: %d Available on Disk: %d"
            % (len(ids), len(set(ids).intersection(available_ids)))
        )
        keep = [i[-1] in DIGIT_SPLIT[split] and i in available_ids for i in ids]
    else:
        keep = [i[-1] in DIGIT_SPLIT[split] for i in ids]
    return df.filter(keep)


def filter_by_k_comments(df: Table, k: int = 3, limit: Optional[int] = None) -> Table:
    """Rows whose id has a row with at least ``k`` comments; over ``limit``,
    ``limit`` of them in the order of pandas' ``sample(n=limit,
    random_state=1)``."""
    filtered_ids = []
    for row in df.rows():
        if len(ast.literal_eval(row["comments"])) >= k:
            filtered_ids.append(row["reddit_id"])
    keep = set(filtered_ids)
    new_df = df.filter([rid in keep for rid in df.reddit_id.tolist()])
    if limit is not None and len(filtered_ids) > limit:
        # pandas' sample: RandomState(random_state).choice(n, size, replace=False)
        rows = np.random.RandomState(1).choice(len(new_df), size=limit, replace=False)
        new_df = new_df.take(rows)
    return new_df


def should_add_comments(add_comments: str, train: bool) -> bool:
    cases = {
        "always": [True, True],
        "train_only": [False, True],
        "never": [False, False],
    }
    return cases[add_comments][int(train)]


def preprocess_comments(
    comments,
    sampling: Optional[str] = None,
    num_comms: int = 2,
    rng: Optional[np.random.Generator] = None,
) -> List[str]:
    """Bot filter, sample or truncate to ``num_comms``, pad with empty
    strings."""
    if num_comms == 0:
        return []
    if len(comments) > 0 and isinstance(comments[0], tuple):
        comments = [
            c[0]
            for c in comments
            if all(s not in c[0].lower() for s in BOT_TEXT_TO_AVOID)
        ]
    else:
        comments = [
            c for c in comments if all(s not in c.lower() for s in BOT_TEXT_TO_AVOID)
        ]

    if len(comments) >= num_comms:
        if sampling == "random":
            rng = rng or np.random.default_rng()
            idxs = rng.permutation(len(comments))
            comments = [comments[i] for i in idxs[:num_comms]]
        elif sampling is None:
            comments = comments[:num_comms]
    while len(comments) < num_comms:
        comments.append("")
    return comments


# --------------------------------------------------------------------------
# Cached feature tables
# --------------------------------------------------------------------------


def _load_feature_file(path: str) -> dict:
    if str(path).endswith(".npz"):
        with np.load(path, allow_pickle=True) as z:
            return {k: z[k] for k in z.files}
    import torch

    return torch.load(path, map_location="cpu", weights_only=False)


def load_features(df: Table, path: str):
    """Cached features aligned to ``df.reddit_id``.

    Plain format: {"reddit_ids": int64 [N], "embeddings": float32 [N, D]} ->
    float32 [len(df), D]. Comment format: {"reddit_id_to_comment_id": dict,
    "embeddings": list-of-list-of-vectors} -> list of lists.
    """
    stored = _load_feature_file(path)

    if "reddit_id_to_comment_id" in stored:
        mapping = stored["reddit_id_to_comment_id"]
        if hasattr(mapping, "item"):
            mapping = mapping.item()
        reddit_ids = list(mapping.keys())
        embeddings = stored["embeddings"]
        lookup = {int(el): i for i, el in enumerate(reddit_ids)}
        sel = [lookup[rid] for rid in df.reddit_id.tolist()]
        feats = [
            [np.asarray(e, dtype=np.float32) for e in embeddings[s]] for s in sel
        ]
        assert len(feats) == len(df)
        return feats

    ids = np.asarray(stored["reddit_ids"])
    emb = np.asarray(stored["embeddings"], dtype=np.float32)
    lookup = {int(el): i for i, el in enumerate(ids)}
    sel = [lookup[rid] for rid in df.reddit_id.tolist()]
    feats = emb[sel]
    assert feats.shape[0] == len(df)
    return feats


def sample_instance(feature_list, sampling, rng=None):
    """One of a row's features: the first, a random one, or all stacked."""
    assert isinstance(feature_list, list)
    if sampling == "first":
        return feature_list[0]
    if sampling == "random":
        rng = rng or np.random.default_rng()
        return feature_list[int(rng.integers(0, len(feature_list)))]
    if sampling == "all":
        return np.stack(feature_list)
    raise ValueError("Unknown sampling method")


def sample_if_list(feature, sampling, rng=None):
    if isinstance(feature, list):
        return sample_instance(feature, sampling, rng)
    return feature
