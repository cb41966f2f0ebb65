"""Helpers of the port: the JSONC config reader, the card's timer, the
TensorBoard writer, logging setup and ``inf_loop``."""

from .jsonc import read_json, write_json
from .logging_setup import setup_logging
from .util import inf_loop, is_image_like_batch
from .writer import TensorboardWriter

__all__ = ["TensorboardWriter", "inf_loop", "is_image_like_batch", "read_json",
           "setup_logging", "write_json"]
