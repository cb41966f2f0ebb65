"""The datasets of the VTC corpus: ``VideoDatasetSegments`` (random
8-frame segments, titles, comments; the kinetics and howto100m training
mixes), ``ImTextDataset`` (thumbnails), ``FeaturesDataset`` (cached
embeddings), and the test sets ``VideoDatasetReddit`` and
``VideoDatasetLivebot``.

The port's own copy of ``vtc_tpu/data/datasets.py``, on ``table.read_csv``
in place of pandas, ``image_io.read_rgb`` in place of PIL, the port's
OpenCV route (``video.py``) for video and its PIL-exact resampler
(``resample.py``) for ``clip_preprocess_batch``. Items are numpy arrays on
the host, as in the JAX package; the trainer puts batches on the card
(``loader.prefetch_to_device``). Randomness is one ``np.random.Generator``
per dataset, seeded by ``seed``, drawn in the JAX package's order.

``VideoDatasetFirst32`` and ``VideoDatasetFirst1800`` feed the R(2+1)D
tower: the first 32 frames at 128 x 171 with the ig65m normalization
(``[c, t, h, w]``, or CLIP's preprocess and title tokens), and the
collaborative-experts clips (short side 128 with OpenCV's bilinear resize,
a 112 center crop, padded to 32 frames). The transfer-evaluation datasets
are in ``video_retrieval.py``.
"""

from __future__ import annotations

import ast
import json
import logging
import math
import os
from typing import List

import numpy as np

from ..device import resolve_device
from .image_io import read_rgb
from .partition import (
    filter_by_k_comments,
    load_features,
    partition_dataframe,
    preprocess_comments,
    sample_if_list,
    should_add_comments,
)
from .preprocess import (
    CLIP_MEAN,
    CLIP_STD,
    IG65M_MEAN,
    IG65M_STD,
    augment_frames,
    augment_image,
    clip_preprocess,
    clip_resize_uint8,
    extract_patches,
)
from .rake import Rake
from .resample import resize
from .table import Table, read_csv
from .tokenizer import get_tokenizer, tokenize, tokenize_max_len
from .video import (
    FALLBACK_SHAPE,
    read_segment_with_fallbacks,
    read_video_full,
    read_video_segment,
)

_logger = logging.getLogger(__name__)


class VisionTitleCommentDatasetBase:
    """CSV loading, splits, tokenization."""

    def __len__(self):
        return len(self.filenames)

    def split_dataset(self, csv_file, df: Table, train, test, test_on_over_k_comms=None,
                      test_set_limit=None) -> Table:
        if test:
            assert not train
            new_df = partition_dataframe(df, split="test")
        else:
            new_df = partition_dataframe(df, split="train" if train else "val")
        if test_on_over_k_comms is not None and not train:
            new_df = filter_by_k_comments(new_df, test_on_over_k_comms, limit=test_set_limit)
        return new_df

    should_add_comments = staticmethod(should_add_comments)

    def _tokenise(self, texts, max_len: int = 77) -> np.ndarray:
        """BPE, with the RAKE keyword phrases of a text of ``max_len`` tokens
        or more in its place (truncated if those are still too long)."""
        if isinstance(texts, str):
            texts = [texts]
        tok = get_tokenizer()
        sot, eot = tok.sot_token, tok.eot_token
        all_tokens = [[sot] + tok.encode(t) + [eot] for t in texts]
        result = np.zeros((len(all_tokens), max_len), dtype=np.int32)
        for i, tokens in enumerate(all_tokens):
            if len(tokens) >= max_len:
                self.rake.extract_keywords_from_text(texts[i])
                phrases = self.rake.get_ranked_phrases()
                tokens = [sot] + tok.encode(" ".join(phrases)) + [eot]
                if len(tokens) >= max_len:
                    result[i, :max_len] = np.asarray(tokens[: max_len - 1] + [eot])
                else:
                    result[i, : len(tokens)] = np.asarray(tokens)
            else:
                result[i, : len(tokens)] = np.asarray(tokens)
        return result

    def preprocess_comments(self, comments, sampling=None, num_comms=2):
        return preprocess_comments(comments, sampling=sampling, num_comms=num_comms,
                                   rng=self.rng)

    def _load_reddit(self, df: Table, file_extension: str = ".mp4") -> Table:
        """Append the reddit rows whose media exist under ``self.root``.

        The CSV's ``video_path`` column stores ``results/<id>.<orig-ext>``;
        the dataset's media carry ``file_extension`` instead (``.jpg``
        thumbnails for the image datasets). Returns the rows kept."""
        paths = [os.path.join(self.root, v[len("results/"):-4] + file_extension)
                 for v in df.video_path.tolist()]
        present = np.array([os.path.exists(p) for p in paths], dtype=bool)
        if not present.all():
            _logger.warning(
                "reddit media: only %d of %d CSV rows found under %s",
                int(present.sum()), len(df), self.root,
            )
        df = df.filter(present)
        self.filenames.extend(p for p, keep in zip(paths, present) if keep)
        self.ids.extend(df.reddit_id.tolist())
        self.titles.extend(df.title.tolist())
        self.video_lengths.extend(df.video_length.tolist())
        self.comments.extend(ast.literal_eval(c) for c in df.comments.tolist())
        _logger.info("%d reddit videos", len(self.ids))
        return df


    def _append_mix_rows(self, df: Table, root, title_col: str, desc_col: str) -> int:
        """The kinetics/howto100m training mixes: every row whose video is
        on disk joins the corpus with id -1 (not reddit), its JSON
        comments, and its description's sentences over 60 characters as
        comments too."""
        kept = 0
        for row in df.rows():
            path = os.path.join(root, row["video_path"])
            if not os.path.exists(path):
                continue
            comms = [] if _isna(row["comments"]) else json.loads(row["comments"])
            desc = row[desc_col]
            if not _isna(desc):
                comms += [s.strip() for s in desc.split(".") if len(s) > 60]
            self.filenames.append(path)
            self.ids.append(-1)
            self.titles.append(row[title_col])
            self.video_lengths.append(row["video_length"])
            self.comments.append(comms)
            kept += 1
        return kept

    def _load_kinetics(self, df: Table):
        # train rows only: k700-train, k400-train or unknown, a /train/ path
        in_train = [k700 == "train" and (k400 == "train" or _isna(k400)) and "/train/" in path
                    for k700, k400, path in zip(df.split_k700.tolist(), df.split_k400.tolist(),
                                                df.video_path.tolist())]
        n = self._append_mix_rows(df.filter(in_train), self.kinetics_root, "title_en",
                                  "description_en")
        _logger.info("kinetics mix: %d videos", n)

    def _load_howto100m(self, df: Table):
        n = self._append_mix_rows(df, self.howto100m_root, "title", "description")
        _logger.info("howto100m mix: %d videos", n)

    def _read_video(self, idx) -> np.ndarray:
        vid = read_segment_with_fallbacks(
            self.filenames[idx],
            video_length=self.video_lengths[idx],
            nframes=self.nframes,
            frame_strides=self.frame_strides,
            reference_fps=self.reference_fps,
            is_reddit=self.ids[idx] != -1,
            train=self.train,
            resize_width=self.video_read_width,
            resize_height=self.video_read_height,
            rng=self.rng,
        )
        if self.train:
            vid = augment_frames(vid, self.rng)
        return vid


def _isna(value) -> bool:
    """A field that pandas reads as missing (``read_csv`` gives it NaN)."""
    return isinstance(value, float) and math.isnan(value)


class VideoDatasetSegments(VisionTitleCommentDatasetBase):
    """Random augmented 8-frame segments, titles and comments
    (``dataset_loaders.py:440-566``); ``first_frame_only`` gives the first
    frame alone. ``device`` is taken for a common signature with
    ``ImTextDataset`` and not used: video decodes on the host."""

    def __init__(
        self,
        csv_file,
        root,
        train=True,
        test=False,
        add_comments="train_only",
        num_comms=2,
        comment_sampling="random",
        use_kinetics_train=None,
        kinetics_csv=None,
        kinetics_root=None,
        use_howto100m_train=None,
        howto100m_csv=None,
        howto100m_root=None,
        first_frame_only=False,
        test_on_over_k_comms=None,
        test_set_limit=None,
        seed=0,
        device=None,
    ):
        self.train = train
        self.root = root
        self.kinetics_root = kinetics_root
        self.howto100m_root = howto100m_root
        self.num_comms = num_comms
        self.comment_sampling = comment_sampling if train else None
        self.first_frame_only = first_frame_only
        self.rng = np.random.default_rng(seed)
        self.rake = Rake()

        self.add_comments = self.should_add_comments(add_comments, train)

        self.video_read_height = 300
        self.video_read_width = 0
        self.nframes = 8
        self.reference_fps = 30
        self.frame_strides = (4, 8, 16, 32) if train else (16,)

        self.ids: List = []
        self.filenames: List[str] = []
        self.titles: List[str] = []
        self.video_lengths: List[float] = []
        self.comments: List = []

        use_reddit = (not train) or (
            use_kinetics_train != "only" and use_howto100m_train != "only")
        use_kinetics = train and use_kinetics_train in ("combine", "only")
        use_howto100m = train and use_howto100m_train in ("combine", "only")
        assert not (use_kinetics_train == "only" and use_howto100m_train == "only")

        if use_reddit:
            df = self.split_dataset(
                csv_file, read_csv(csv_file), train, test,
                test_on_over_k_comms=test_on_over_k_comms, test_set_limit=test_set_limit)
            self._load_reddit(df)
        if use_kinetics:
            self._load_kinetics(read_csv(kinetics_csv))
        if use_howto100m:
            self._load_howto100m(read_csv(howto100m_csv))

    def __getitem__(self, idx):
        title = self.titles[idx]
        comments = self.comments[idx]

        vid = clip_preprocess_batch(self._read_video(idx))
        if self.first_frame_only:
            vid = vid[0]

        title_tok = self._tokenise([title])[0]
        if self.add_comments:
            comments = self.preprocess_comments(
                comments, sampling=self.comment_sampling, num_comms=self.num_comms)
            comments_tok = self._tokenise(comments)
        else:
            comments_tok = self._tokenise([""])
        return vid, title_tok, comments_tok, {"id": self.ids[idx]}


def clip_preprocess_batch(frames: np.ndarray, size: int = 224) -> np.ndarray:
    """uint8 ``[t, h, w, 3]`` -> float32 ``[t, 3, size, size]``: the frames
    resized together (PIL's bicubic, bit for bit, one thread per frame up to
    the cores this process may use), then cropped and normalized as
    ``clip_preprocess`` does each frame, so equal to
    ``preprocess.clip_preprocess_frames``. (The JAX package's native stage
    folds the normalization into one multiply and subtract, within 4.8e-7
    of this.)"""
    t, h, w, _ = frames.shape
    if w <= h:
        new_w, new_h = size, max(1, int(h * size / w))
    else:
        new_w, new_h = max(1, int(w * size / h)), size
    threads = min(t, len(os.sched_getaffinity(0)) or 1)
    resized = resize(np.ascontiguousarray(frames), new_w, new_h, "bicubic", threads)
    top, left = (new_h - size) // 2, (new_w - size) // 2
    arr = resized[:, top : top + size, left : left + size].astype(np.float32) / 255.0
    return ((arr - CLIP_MEAN) / CLIP_STD).transpose(0, 3, 1, 2)



class FeaturesDataset:
    """Precomputed-feature training: cached CLIP/audio embedding tables
    keyed by reddit id, with optional nested concatenation and per-item
    comment sampling. ``device`` is taken for a common signature with
    ``ImTextDataset`` and not used: the tables stay on the host."""

    def __init__(
        self,
        csv_file,
        input_features=None,
        target_features=None,
        train=True,
        train_comment_sampling=None,
        test_comment_sampling=None,
        seed=0,
        device=None,
    ):
        self.train = train
        self.feature_sampling = train_comment_sampling if train else test_comment_sampling
        self.rng = np.random.default_rng(seed)

        df = partition_dataframe(read_csv(csv_file), split="train" if train else "val")

        if isinstance(input_features, str):
            input_features = [input_features]
        # nesting is decided by the spec's shape, not by the loaded type: a
        # ragged comment-format table loads as a list of per-row lists
        self._nested = [isinstance(f, (list, tuple)) for f in input_features]
        self.feats = [
            (
                [load_features(df, f) for f in feats]
                if isinstance(feats, (list, tuple))
                else load_features(df, feats)
            )
            for feats in input_features
        ]
        self.targets = load_features(df, target_features) if target_features else None

    def __len__(self):
        return len(self.feats[0])

    def __getitem__(self, idx):
        inputs = []
        for nested, feat in zip(self._nested, self.feats):
            if nested:
                inputs.append(np.concatenate(
                    [sample_if_list(f[idx], self.feature_sampling, self.rng) for f in feat]))
            else:
                inputs.append(sample_if_list(feat[idx], self.feature_sampling, self.rng))
        meta = {}
        if self.targets is not None:
            meta["target"] = self.targets[idx]
        return (*inputs, meta)


class ImTextDataset(VisionTitleCommentDatasetBase):
    """Thumbnails, titles and comments. Each item's JPEG is decoded on
    ``device`` (default: the card, by nvJPEG; ``"cpu"``: PIL), then
    resized, cropped and normalized on the host as the JAX package does."""

    def __init__(
        self,
        csv_file,
        root,
        train=True,
        test=False,
        add_comments="train_only",
        num_comms=0,
        comment_sampling="random",
        cached_vision_features=None,
        test_on_over_k_comms=None,
        test_set_limit=None,
        use_augmentation=False,
        cached_audio_features=None,
        audio_with_comms=None,
        audio_instead_of_title=False,
        image_size=224,
        uint8_images=False,
        patch_images=False,
        seed=0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.train = train
        self.root = root
        self.image_size = int(image_size)
        # uint8 HWC out, normalized on the card (4x fewer bytes to copy)
        self.uint8_images = bool(uint8_images)
        # the ViT's patches [N, p*p*3] uint8, the patch-embed GEMM's operand;
        # True -> patch 32 (ViT-B/32), an int selects the patch size
        self.patch_images = int(patch_images) if patch_images else 0
        if self.patch_images == 1:
            self.patch_images = 32
        self.num_comms = int(num_comms)
        self.comment_sampling = comment_sampling if train else None
        self.cached_vision_features = cached_vision_features
        self.use_augmentation = use_augmentation
        self.cached_audio_features = cached_audio_features
        self.audio_with_comms = audio_with_comms
        self.audio_instead_of_title = audio_instead_of_title
        self.rng = np.random.default_rng(seed)
        self.rake = Rake()

        self.add_comments = self.should_add_comments(add_comments, train)

        self.ids: List = []
        self.filenames: List[str] = []
        self.titles: List[str] = []
        self.video_lengths: List = []
        self.comments: List = []

        df = self.split_dataset(
            csv_file, read_csv(csv_file), train, test,
            test_on_over_k_comms=test_on_over_k_comms, test_set_limit=test_set_limit,
        )
        df = self._load_reddit(df, file_extension=".jpg")

        if cached_vision_features is not None:
            self.vision_feats = load_features(df, cached_vision_features)
        if cached_audio_features is not None:
            self.audio_feats = load_features(df, cached_audio_features)

    def __getitem__(self, idx):
        title = self.titles[idx]
        comments = self.comments[idx]

        if self.cached_vision_features is not None:
            im = np.asarray(self.vision_feats[idx], dtype=np.float32)
        else:
            im = read_rgb(self.filenames[idx], self.device)
            if self.use_augmentation and self.train:
                im = augment_image(im, self.rng)
            if self.patch_images:
                im = extract_patches(clip_resize_uint8(im, self.image_size),
                                     self.patch_images)
            elif self.uint8_images:
                im = clip_resize_uint8(im, self.image_size)
            else:
                im = clip_preprocess(im, self.image_size)

        title_tok = self._tokenise([title])[0]
        if self.add_comments:
            comments = self.preprocess_comments(
                comments, sampling=self.comment_sampling, num_comms=self.num_comms)
            comments_tok = self._tokenise(comments)
        else:
            comments_tok = self._tokenise([""])

        if self.cached_audio_features:
            audio_clips = np.asarray(self.audio_feats[idx], dtype=np.float32)
            if self.audio_instead_of_title:
                inputs = (im, audio_clips)
            elif self.audio_with_comms:
                inputs = (im, title_tok, (comments_tok, audio_clips))
            else:
                inputs = (im, title_tok, audio_clips)
        else:
            inputs = (im, title_tok, comments_tok)
        return (*inputs, {"id": self.ids[idx]})


class VideoDatasetReddit(VideoDatasetSegments):
    """The VTC test split: videos with 3 comments or more, at most 5,000
    (``dataset_loaders.py:1049-1113``). Each item is the video's first 8
    frames (decoding only those: the frames of a full decode cut to 8),
    padded with black frames to 8."""

    def __init__(
        self,
        root,
        reddit_csv,
        train=False,
        split="test",
        num_comms=5,
        test_on_over_k_comms=3,
        test_set_limit=5000,
        comment_sampling=None,
        first_frame_only=False,
        seed=0,
        device=None,
    ):
        assert train is False and split == "test"
        super().__init__(
            csv_file=reddit_csv,
            root=root,
            train=train,
            test=True,
            add_comments="always" if num_comms != 0 else "train_only",
            num_comms=num_comms,
            comment_sampling=comment_sampling,
            first_frame_only=first_frame_only,
            test_on_over_k_comms=test_on_over_k_comms,
            test_set_limit=test_set_limit,
            seed=seed,
        )

    def __getitem__(self, index):
        vid = read_video_full(self.filenames[index], max_frames=8)
        if vid.shape[0] == 0:
            _logger.warning("Failed reading: %s", self.filenames[index])
            vid = np.zeros(FALLBACK_SHAPE, np.uint8)

        frames = clip_preprocess_batch(vid)
        if frames.shape[0] != 8:
            pad = np.zeros((8 - frames.shape[0],) + frames.shape[1:], np.float32)
            frames = np.concatenate([frames, pad], axis=0)

        title_tok = self._tokenise(self.titles[index])
        pp_comments = self.preprocess_comments(
            self.comments[index], sampling=self.comment_sampling, num_comms=self.num_comms)
        comments_tok = self._tokenise(pp_comments)
        return frames, title_tok, comments_tok, self.ids[index]


class VideoDatasetLivebot:
    """The translated Bilibili danmaku test set
    (``dataset_loaders.py:1116-1174``): raw frames (None where the video
    does not decode), which ``retrieval_eval`` preprocesses after its
    stride, the title and the comments."""

    def __init__(self, root, cvs_file, train=False, split="test", add_comments=True,
                 device=None):
        assert train is False and split == "test"
        df = read_csv(cvs_file)
        self.video_files = [os.path.join(root, v) for v in df.video_path.tolist()]
        self.titles = df.title.tolist()
        self.comments = [ast.literal_eval(c) for c in df.comments.tolist()]
        self.add_comments = add_comments
        _logger.info("%d comments test files", len(self.video_files))

    def __len__(self):
        return len(self.video_files)

    def __getitem__(self, index):
        vid = read_video_full(self.video_files[index])
        if vid.shape[0] == 0:
            _logger.warning("failed video: %s", self.video_files[index])
            frames = None
        else:
            frames = vid

        vid_id = self.video_files[index].split("/")[-1].split(".")[0]
        title_tok = tokenize_max_len(self.titles[index])
        if self.add_comments:
            comments_tok = tokenize_max_len(self.comments[index])
        else:
            comments_tok = tokenize_max_len([""])
        return frames, title_tok, comments_tok, vid_id


def _video_files(csv_file, root, train, should_partition_dataframe):
    df = read_csv(csv_file)
    if should_partition_dataframe:
        df = partition_dataframe(df, root=root, split="train" if train else "val")
    return df, [os.path.join(root, v[len("results/"):]) for v in df.video_path.tolist()]


class VideoDatasetFirst32:
    """The first 32 frames of each video at 128 x 171 (zero frames pad a
    short one), ig65m-normalized as float32 ``[3, 32, 128, 171]`` with the
    cached text feature, or with ``clip_preprocess`` CLIP's ``[32, 3, 224,
    224]`` with the title's tokens (``dataset_loaders.py:569-680``). Items
    ``(vid, text, {"id": reddit_id})``."""

    def __init__(self, csv_file, root, text_features=None, train=True,
                 should_partition_dataframe=True, clip_preprocess=False, seed=0,
                 device=None):
        self.train = train
        self.height, self.width, self.nframes = 128, 171, 32
        self.clip_preprocess = clip_preprocess  # ``seed``: accepted, as in vtc_tpu; unused
        df, self.video_files = _video_files(csv_file, root, train,
                                            should_partition_dataframe)
        self.ids = df.reddit_id.tolist()
        self.titles = df.title.tolist()
        self.text_feats = (load_features(df, text_features)
                           if text_features is not None else None)
        if not clip_preprocess and self.text_feats is None:
            raise ValueError(
                "VideoDatasetFirst32 without clip_preprocess requires text_features "
                "(the ig65m path trains against cached text embeddings)")

    def __len__(self):
        return len(self.video_files)

    def __getitem__(self, idx):
        vid = read_video_segment(self.video_files[idx], 0, 4, resize_width=self.width,
                                 resize_height=self.height, max_frames=self.nframes)
        vid = vid[: self.nframes]
        if vid.shape[0] < self.nframes:
            out = np.zeros((self.nframes, self.height, self.width, 3), np.uint8)
            if vid.shape[0] == 0:
                _logger.warning("Zero length video: %s", self.video_files[idx])
            else:
                out[: vid.shape[0]] = vid
            vid = out
        if self.clip_preprocess:
            vid = clip_preprocess_batch(vid)
            try:
                text = tokenize(self.titles[idx])
            except RuntimeError as e:
                _logger.warning("Failed to tokenize %s: %s", self.titles[idx], e)
                text = tokenize(self.titles[idx][:20])
        else:
            vid = (vid.astype(np.float32) / 255.0 - IG65M_MEAN) / IG65M_STD
            vid = vid.transpose(3, 0, 1, 2)  # [c, t, h, w], the ig65m layout
            text = self.text_feats[idx]
        return vid, text, {"id": self.ids[idx]}


class VideoDatasetFirst1800:
    """Collaborative-experts clips (``dataset_loaders.py:683-775``): up to
    1800 frames read at height 256, the short side resized to 128 (the long
    side truncated, as torchvision's ``Resize``) with OpenCV's bilinear
    resize, a 112 center crop, ig65m-normalized, padded with zero frames to
    32: float32 ``[3, t, 112, 112]``. Items ``(vid, {})``."""

    def __init__(self, csv_file, root, train=True, should_partition_dataframe=True,
                 device=None):
        self.train = train
        self.video_read_height, self.height, self.crop_size = 256, 128, 112
        self.nframes, self.min_nframes = 1800, 32
        _, self.video_files = _video_files(csv_file, root, train,
                                           should_partition_dataframe)

    def __len__(self):
        return len(self.video_files)

    def _resize_crop(self, f):
        import cv2

        h, w = f.shape[:2]
        if h <= w:
            nh, nw = self.height, max(1, int(w * self.height / h))
        else:
            nw, nh = self.height, max(1, int(h * self.height / w))
        f = cv2.resize(f, (nw, nh), interpolation=cv2.INTER_LINEAR)
        top, left = (nh - self.crop_size) // 2, (nw - self.crop_size) // 2
        return f[top: top + self.crop_size, left: left + self.crop_size]

    def __getitem__(self, idx):
        vid = read_video_segment(self.video_files[idx], 0, self.nframes // 15,
                                 resize_width=0, resize_height=self.video_read_height,
                                 max_frames=self.nframes)[: self.nframes]
        length = vid.shape[0]
        c = self.crop_size
        if length > 0:
            vid = np.stack([self._resize_crop(f) for f in vid]).astype(np.float32)
            vid = ((vid / 255.0 - IG65M_MEAN) / IG65M_STD).transpose(0, 3, 1, 2)
        else:
            vid = np.zeros((0, 3, c, c), np.float32)
        if length < self.min_nframes:
            out = np.zeros((self.min_nframes, 3, c, c), np.float32)
            if length == 0:
                _logger.warning("Zero length video: %s", self.video_files[idx])
            else:
                out[:length] = vid
            vid = out
        return vid.transpose(1, 0, 2, 3), {}
