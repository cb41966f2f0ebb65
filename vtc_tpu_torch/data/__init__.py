"""The port's data layer: the datasets (found by name by
``config.init_obj('dataset', data)``), the CSV table, splits and comment
sampling, the CLIP BPE, image reading and preprocessing, the loader and its
copy to the card."""

from .datasets import (
    FeaturesDataset,
    ImTextDataset,
    VideoDatasetActivityNet,
    VideoDatasetFirst32,
    VideoDatasetFirst1800,
    VideoDatasetK700Comments,
    VideoDatasetLivebot,
    VideoDatasetMSRVTT,
    VideoDatasetMSVD,
    VideoDatasetReddit,
    VideoDatasetSegments,
)
from .image_io import JpegDecodeError, decode_rgb, read_rgb
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
    clip_resize_uint8,
    extract_patches,
    normalize_uint8_images,
)
from .table import Table, read_csv
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
    "FeaturesDataset", "ImTextDataset", "JpegDecodeError", "SOT_ID", "Table",
    "VideoDatasetActivityNet", "VideoDatasetFirst32", "VideoDatasetFirst1800",
    "VideoDatasetK700Comments", "VideoDatasetLivebot", "VideoDatasetMSRVTT",
    "VideoDatasetMSVD", "VideoDatasetReddit", "VideoDatasetSegments",
    "clip_preprocess", "clip_resize_uint8", "decode_rgb", "default_collate",
    "extract_patches",
    "filter_by_k_comments", "get_tokenizer", "load_features", "normalize_uint8_images",
    "partition_dataframe", "prefetch_to_device", "preprocess_comments", "read_csv",
    "read_rgb", "synthetic_tokens", "tokenize", "tokenize_max_len",
]
