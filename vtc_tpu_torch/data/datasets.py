"""The image datasets of the VTC corpus: ``ImTextDataset`` (thumbnails,
titles, comments) and ``FeaturesDataset`` (cached embeddings).

The port's own copy of ``vtc_tpu/data/datasets.py:54-131,446-625``, on
``table.read_csv`` in place of pandas and ``image_io.read_rgb`` in place of
PIL: the base's split, tokenization with the RAKE fallback, comment
preprocessing and reddit loader, then the two datasets with every argument.
Items are numpy arrays on the host, as in the JAX package; the trainer puts
batches on the card (``loader.prefetch_to_device``). Randomness is one
``np.random.Generator`` per dataset, seeded by ``seed``, drawn in the JAX
package's order.

The video datasets (``VideoDatasetSegments`` and the rest) wait for the
port of ``video.py``, ``video_retrieval.py`` and the libav decoder: their
names raise ``NotImplementedError`` (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import ast
import logging
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
from .preprocess import augment_image, clip_preprocess, clip_resize_uint8, extract_patches
from .rake import Rake
from .table import Table, read_csv
from .tokenizer import get_tokenizer

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


def _waits_for_video(name: str):
    def dataset(*args, **kwargs):
        raise NotImplementedError(
            f"{name} waits for the port of the video datasets (video.py, "
            "video_retrieval.py and the libav decoder; ROADMAP: Queue 1 item 3)")

    dataset.__name__ = dataset.__qualname__ = name
    return dataset


VideoDatasetSegments = _waits_for_video("VideoDatasetSegments")
VideoDatasetFirst32 = _waits_for_video("VideoDatasetFirst32")
VideoDatasetFirst1800 = _waits_for_video("VideoDatasetFirst1800")
VideoDatasetReddit = _waits_for_video("VideoDatasetReddit")
VideoDatasetLivebot = _waits_for_video("VideoDatasetLivebot")
VideoDatasetMSRVTT = _waits_for_video("VideoDatasetMSRVTT")
VideoDatasetMSVD = _waits_for_video("VideoDatasetMSVD")
VideoDatasetActivityNet = _waits_for_video("VideoDatasetActivityNet")
VideoDatasetK700Comments = _waits_for_video("VideoDatasetK700Comments")
