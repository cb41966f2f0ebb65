"""The port's data layer: the datasets (found by name by
``config.init_obj('dataset', data)``), the CSV table, splits and comment
sampling, the CLIP BPE, image and video reading and preprocessing, the
loader and its copy to the card. Images are read as PIL's ``convert("RGB")``
reads them: a JPEG on the card (nvJPEG and the ``ycc_to_rgb`` kernel), a
PNG, GIF, BMP or WebP on the host (``decode_webp`` among them), PIL itself
where the caller names the CPU."""

from .datasets import (
    FeaturesDataset,
    ImTextDataset,
    VideoDatasetFirst32,
    VideoDatasetFirst1800,
    VideoDatasetLivebot,
    VideoDatasetReddit,
    VideoDatasetSegments,
    clip_preprocess_batch,
)
from .image_io import ImageInputError, JpegDecodeError, decode_rgb, read_rgb
from .loader import DataLoader, default_collate, prefetch_to_device
from .partition import (
    BOT_TEXT_TO_AVOID,
    filter_by_k_comments,
    load_features,
    partition_dataframe,
    preprocess_comments,
)
from .preprocess import (
    CLIP_MEAN,
    CLIP_STD,
    clip_preprocess,
    clip_preprocess_frames,
    clip_resize_uint8,
    extract_patches,
    normalize_uint8_images,
)
from .table import Table, read_csv
from .video import (
    linspace_subsample,
    read_segment_with_fallbacks,
    read_video_full,
    read_video_segment,
    video_duration_sec,
)
from .video_retrieval import (
    VideoDatasetActivityNet,
    VideoDatasetK700Comments,
    VideoDatasetMSRVTT,
    VideoDatasetMSVD,
)
from .webp import WebpDecodeError, decode_webp
from .tokenizer import (
    EOT_ID,
    SOT_ID,
    get_tokenizer,
    synthetic_tokens,
    tokenize,
    tokenize_max_len,
)

__all__ = [
    "BOT_TEXT_TO_AVOID", "CLIP_MEAN", "CLIP_STD", "DataLoader", "EOT_ID",
    "FeaturesDataset", "ImTextDataset", "ImageInputError", "JpegDecodeError", "SOT_ID",
    "Table",
    "VideoDatasetActivityNet", "VideoDatasetFirst32", "VideoDatasetFirst1800",
    "VideoDatasetK700Comments", "VideoDatasetLivebot", "VideoDatasetMSRVTT",
    "VideoDatasetMSVD", "VideoDatasetReddit", "VideoDatasetSegments",
    "clip_preprocess", "clip_preprocess_batch", "clip_preprocess_frames",
    "clip_resize_uint8", "decode_rgb", "decode_webp", "default_collate", "extract_patches",
    "filter_by_k_comments", "get_tokenizer", "linspace_subsample", "load_features",
    "normalize_uint8_images", "partition_dataframe", "prefetch_to_device",
    "preprocess_comments", "read_csv", "read_rgb", "read_segment_with_fallbacks",
    "read_video_full", "read_video_segment", "synthetic_tokens", "tokenize",
    "tokenize_max_len", "video_duration_sec", "WebpDecodeError",
]
