"""The transfer-evaluation video datasets: MSR-VTT, MSVD, ActivityNet and
Kinetics-700 with comments.

The port's own copy of ``vtc_tpu/data/video_retrieval.py``: the same split
lists, the same caption selection (the jsfusion caption-index pickle,
miech's first caption), the same augment-mode fake comments and random
draws, on the port's OpenCV route (``video.py``) and ``table.read_csv`` in
place of pandas. The split lists ship under ``vtc_tpu_torch/data/meta/``
(the public evaluation-protocol lists; ``meta/README.md``).
"""

from __future__ import annotations

import glob
import json
import logging
import os
import pickle
import warnings
from collections import defaultdict
from pathlib import Path
from typing import Optional

import numpy as np

from .preprocess import augment_frames
from .table import read_csv
from .tokenizer import tokenize, tokenize_max_len
from .video import linspace_subsample, read_video_full, read_video_segment, video_duration_sec

META_DIR = Path(__file__).parent / "meta"

logger = logging.getLogger(__name__)


def _read_video_train(video_path, rng: Optional[np.random.Generator] = None):
    """The stride-randomized, augmented train reader
    (``video_retrieval_videodatasets.py:65-110``)."""
    rng = rng or np.random.default_rng()
    frame_strides = (8, 16, 16, 24)
    reference_fps = 30
    nframes = 8

    video_length = video_duration_sec(video_path)
    frame_stride = frame_strides[int(rng.integers(0, len(frame_strides)))]
    segment_duration = nframes / (reference_fps / frame_stride)

    start_upper = max(0.0, video_length - segment_duration)
    segment_start = (0.0 - start_upper) * float(rng.random()) + start_upper

    vid = read_video_segment(video_path, segment_start, segment_start + segment_duration,
                             resize_width=300, resize_height=0, subsample_to=nframes)
    if vid.shape[0] == 0:
        logger.warning("video read failed, using black frames: %s", video_path)
        vid = np.zeros((nframes, 300, 300, 3), np.uint8)
    if vid.shape[0] != nframes:
        vid = linspace_subsample(vid, nframes)
    return augment_frames(vid, rng)


def _augmented_frames(video_path, rng):
    """Augment-mode train frames: the augmented 256 x 256 frames through
    CLIP's transform (``video_retrieval_videodatasets.py:213-224``)."""
    from .datasets import clip_preprocess_batch

    return clip_preprocess_batch(_read_video_train(video_path, rng))


def _fake_comment_item(frames, captions, rng, train, name):
    """Augment mode: one caption becomes the title, five others fake
    comments."""
    if not train:
        warnings.warn(f"{name}: augment with eval set is nondeterministic")
    order = rng.permutation(len(captions))
    picked = [captions[i] for i in order[:6]]
    title, fake_comments = picked[0], picked[1:]
    assert len(fake_comments) == 5
    return (frames, tokenize(title, truncate=True)[0], tokenize(fake_comments, truncate=True),
            {})


def _tokenize_captions(captions):
    """A video's captions; truncated only where one is over-long (the other
    captions of the video stay whole)."""
    try:
        return tokenize(captions)
    except RuntimeError as e:
        logger.warning("over-length caption set, truncating (%s): %.80s", e, captions)
        return tokenize(captions, truncate=True)


def _resolve_files(video_ids, make_path, name, require_all=False):
    """The split's ids to existing files; misses logged (and refused with
    ``require_all``)."""
    found, missing = [], 0
    for v in video_ids:
        p = make_path(v)
        if os.path.exists(p):
            found.append(str(p))
        else:
            missing += 1
    logger.info("%s: %d files resolved, %d missing", name, len(found), missing)
    if require_all and missing:
        raise FileNotFoundError(f"{name}: {missing} split videos missing")
    return found


def _stem(path):
    return os.path.basename(path).rsplit(".", 1)[0]


def _split_ids(path: Path):
    return [line.strip() for line in path.read_text().splitlines() if line.strip()]


class VideoDatasetMSRVTT:
    """MSR-VTT with its four standard splits; augment mode turns extra
    captions into 5 fake comments (``video_retrieval_videodatasets.py:113-255``).
    An item is the video's every frame (``retrieval_eval`` preprocesses the
    ones its stride takes), its tokenized captions and its id."""

    # split -> (train list, eval list, caption-index pickle for eval)
    SPLITS = {
        "miech": ("train_list_miech.txt", "test_list_miech.txt", None),
        "jsfusion": ("train_list_jsfusion.txt", "val_list_jsfusion.txt",
                     "jsfusion_val_caption_idx.pkl"),
        "full-val": ("train_list_full.txt", "val_list_full.txt", None),
        "full-test": ("train_list_full.txt", "test_list_full.txt", None),
    }
    METADATA_JSON = ("train_val_videodatainfo.json", "test_videodatainfo.json")
    VIDEO_DIRS = ("TrainValVideo", "TestVideo")

    def __init__(self, root="/data/MSRVTT", train=True, split=None, augment=False,
                 meta_dir=None, seed=0):
        if split not in self.SPLITS:
            raise ValueError(f"Unknown MSRVTT split {split!r}")
        self.train = train
        self.augment = augment
        self.rng = np.random.default_rng(seed)

        meta = Path(meta_dir) if meta_dir else META_DIR / "msrvtt_meta"
        train_list, eval_list, caption_idx = self.SPLITS[split]
        video_ids = _split_ids(meta / (train_list if train else eval_list))
        logger.info("MSRVTT split %s: %d videos", split, len(video_ids))

        captions = defaultdict(list)
        for json_file in self.METADATA_JSON:
            path = os.path.join(root, json_file)
            if not os.path.exists(path):
                raise FileNotFoundError(path)
            with open(path) as f:
                for s in json.load(f)["sentences"]:
                    captions[s["video_id"]].append(s["caption"])

        files_by_id = {}
        for sub in self.VIDEO_DIRS:
            for m in glob.glob(os.path.join(root, sub, "*.mp4")):
                files_by_id[_stem(m)] = m

        # the eval protocols' captions: jsfusion one per video from the
        # pickled index, miech the first
        if not train and caption_idx is not None:
            with open(meta / caption_idx, "rb") as f:
                for vid, i in pickle.load(f).items():
                    captions[vid] = [captions[vid][i]]
        if not train and split == "miech":
            for vid in captions:
                captions[vid] = [captions[vid][0]]

        self.video_files = [files_by_id[v] for v in video_ids]
        self.captions = captions

    def __len__(self):
        n = len(self.video_files)
        return 5 * n if (self.augment and self.train) else n

    def __getitem__(self, idx):
        video_path = self.video_files[idx % len(self.video_files)]
        vid_id = _stem(video_path)
        if self.augment:
            frames = _augmented_frames(video_path, self.rng)
            return _fake_comment_item(frames, self.captions[vid_id], self.rng, self.train,
                                      "MSRVTT")
        return read_video_full(video_path), _tokenize_captions(self.captions[vid_id]), vid_id


class VideoDatasetMSVD:
    """MSVD's val and test splits (``video_retrieval_videodatasets.py:258-368``).
    Needs ``raw-captions.pkl`` in the meta dir (absent upstream)."""

    SPLITS = {
        "val": ("train_list.txt", "val_list.txt"),
        "test": ("train_list.txt", "test_list.txt"),
    }

    def __init__(self, root="/data/MSVD", train=True, split=None, augment=False,
                 meta_dir=None, seed=0):
        if split not in self.SPLITS:
            raise ValueError(f"Unknown MSVD split {split!r}")
        self.train = train
        self.augment = augment
        self.rng = np.random.default_rng(seed)

        meta = Path(meta_dir) if meta_dir else META_DIR / "msvd_meta"
        caption_file = meta / "raw-captions.pkl"
        if not caption_file.exists():
            raise FileNotFoundError(
                f"{caption_file} — MSVD captions must be provided (the file is also missing "
                "from the reference repo; see data/meta/README.md)")
        with open(caption_file, "rb") as f:
            self._raw_captions = pickle.load(f)

        video_ids = _split_ids(meta / self.SPLITS[split][0 if train else 1])
        self.video_files = _resolve_files(
            video_ids, lambda v: os.path.join(root, "YouTubeClips", v + ".avi"), "MSVD",
            require_all=True)

    def _captions(self, vid_id):
        return [" ".join(words) for words in self._raw_captions[vid_id]]

    def __len__(self):
        n = len(self.video_files)
        return 5 * n if (self.augment and self.train) else n

    def __getitem__(self, idx):
        video_path = self.video_files[idx % len(self.video_files)]
        vid_id = _stem(video_path)
        if self.augment:
            frames = _augmented_frames(video_path, self.rng)
            return _fake_comment_item(frames, self._captions(vid_id), self.rng, self.train,
                                      "MSVD")
        return read_video_full(video_path), _tokenize_captions(self._captions(vid_id)), vid_id


class VideoDatasetActivityNet:
    """ActivityNet retrieval (``video_retrieval_videodatasets.py:371-475``,
    with configurable paths); every split video must be on disk, as the
    reference asserts."""

    SPLITS = {
        "val": ("train_list.txt", "val_1_list.txt"),
        "test": ("train_list.txt", "val_2_list.txt"),
    }

    def __init__(self, root, train=True, split=None, meta_dir=None):
        if split not in self.SPLITS:
            raise ValueError(f"Unknown ActivityNet split {split!r}")
        self.train = train
        meta = Path(meta_dir) if meta_dir else META_DIR / "activitynet_meta"

        with open(meta / "raw-captions.pkl", "rb") as f:
            self._raw_captions = pickle.load(f)
        video_ids = _split_ids(meta / self.SPLITS[split][0 if train else 1])
        self.video_files = _resolve_files(
            video_ids, lambda v: os.path.join(root, "videos", v + ".mp4"), "ActivityNet",
            require_all=True)

    def __len__(self):
        return len(self.video_files)

    def __getitem__(self, idx):
        video_path = self.video_files[idx]
        vid_id = _stem(video_path)
        captions = [" ".join(w) for w in self._raw_captions[vid_id]]
        return read_video_full(video_path), tokenize(captions, truncate=True), vid_id


class VideoDatasetK700Comments:
    """Kinetics-700 test videos with 3 comments or more, leaving out any id
    seen in the k400 or k700 training sets
    (``video_retrieval_videodatasets.py:478-554``)."""

    def __init__(self, root="/data",
                 kinetics_csv="/data/oxford_project/kinetics700_havedescs.csv", train=False,
                 split="test"):
        assert train is False and split == "test"
        df = read_csv(kinetics_csv)

        train_ids = {
            _stem(p)
            for dataset in ("kinetics400", "kinetics700")
            for p in glob.glob(os.path.join(root, dataset, "train", "**", "*.mp4"),
                               recursive=True)
        }

        self.video_files, self.titles, self.comments, self.descriptions = [], [], [], []
        for row in df.rows():
            comments = row["comments"]
            if ("/test/" not in row["video_path"] or row["kinetics_id"] in train_ids
                    or row["title_lang"] != "en" or not isinstance(comments, str)):
                continue
            comments = json.loads(comments)
            if len(comments) < 3:
                continue
            self.video_files.append(os.path.join(root, row["video_path"]))
            self.titles.append(row["title"])
            self.comments.append(comments)
            self.descriptions.append(row["description"])
        logger.info("K700Comments: %d eval videos", len(self.video_files))

    def __len__(self):
        return len(self.video_files)

    def __getitem__(self, index):
        frames = read_video_full(self.video_files[index])
        vid_id = _stem(self.video_files[index])
        title_tok = tokenize_max_len(self.titles[index])
        comments_tok = tokenize_max_len(self.comments[index])
        return frames, title_tok, comments_tok, vid_id
