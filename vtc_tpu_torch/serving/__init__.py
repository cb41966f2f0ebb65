"""Single-device retrieval serving of the port."""

from .index import ClipRetrievalService, RetrievalIndex

__all__ = ["ClipRetrievalService", "RetrievalIndex"]
